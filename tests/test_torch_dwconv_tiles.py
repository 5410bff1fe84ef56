"""A tile-faithful CPU emulation of the int8 depthwise 3×3 kernel
(``ops/cuda/csrc/int8_dwconv3x3.cu``), held equal to its plain version.

The emulation does the kernel's work word by word: :func:`.plan`'s tiles,
the grid of whole slice multiples and each block's walk over its tiles
with the two halo buffers, the halo staged in granules (each thread's share
as the kernel splits it, the pad code outside the map and past C, the
buffers filled with junk first so that a cell read but never staged
shows), the 32-bit words at the kernel's pitch, ``__byte_perm`` with
CUDA's selector semantics, the signed ``__dp4a``, the rolling rows of
channel words, the epilogue in float32 steps (its conversions as the
kernel's exact float additions), and the stores masked at
the map's edge and the channel tail.  Every output must be written once.
Tolerance 0, at strides 1 and 2, both ``pad_lo``, C ∈ {8, 24, 40, 96,
144}, the card tests' ragged shapes, one MobileNetV2 and one MobileOne-S1
layer shape, on the plan's grid (usually one tile a block here) and on a
grid of one slice's blocks (each walks many tiles).  The plan itself:
within the kernel's limits at every depthwise shape of the two models.
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import int8_dwconv as D

torch.set_num_threads(1)

JUNK = 0xA5              # what a halo byte holds before it is staged


def byte_perm(x, y, s: int):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: byte n of the
    result is byte ``(s >> 4n) & 7`` of the 8 bytes of (x, y), x's first
    (every selector here leaves bit 3 of a nibble, sign replication, 0)."""
    sel = [(s >> (4 * n)) & 0xF for n in range(4)]
    assert max(sel) < 8
    pool = np.concatenate([x.astype("<u4").view(np.uint8).reshape(-1, 4),
                           y.astype("<u4").view(np.uint8).reshape(-1, 4)], 1)
    return np.ascontiguousarray(pool[:, sel]).view("<u4").reshape(-1)


def dp4a(a, b, c):
    """Signed ``__dp4a(a, b, c)``: c + Σ_i int8(a.i)·int8(b.i)."""
    a8 = a.astype("<u4").view(np.int8).reshape(-1, 4).astype(np.int32)
    b8 = b.astype("<u4").view(np.int8).reshape(-1, 4).astype(np.int32)
    return c + (a8 * b8).sum(axis=1, dtype=np.int32)


MAGIC, MAGIC_BITS = np.float32(12582912.0), np.int32(0x4B400000)


def acc_to_float(acc):
    """The kernel's f32(acc): the int added to MAGIC's bits, less MAGIC."""
    return (MAGIC_BITS + acc).view(np.float32) - MAGIC


def code_of(y, lo, hi):
    """The kernel's code: y clamped to [lo, hi] in float, plus MAGIC
    (rounding half to even), the low byte of its bits."""
    t = np.minimum(np.maximum(y, np.float32(lo)), np.float32(hi)) + MAGIC
    return (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def transpose4(p0, p1, p2, p3):
    x0, x1 = byte_perm(p0, p1, 0x5140), byte_perm(p0, p1, 0x7362)
    y0, y1 = byte_perm(p2, p3, 0x5140), byte_perm(p2, p3, 0x7362)
    return [byte_perm(x0, y0, 0x5410), byte_perm(x0, y0, 0x7632),
            byte_perm(x1, y1, 0x5410), byte_perm(x1, y1, 0x7632)]


def words(mem, addr):
    """Little-endian 32-bit words of ``mem`` at byte addresses ``addr``."""
    b = mem[addr[:, None] + np.arange(4)].astype(np.uint32)
    return b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24


def row_words(buf, q, pitch, stride):
    p = [words(buf, q + k * pitch) for k in range(6 if stride == 1 else 5)]
    lo = transpose4(*p[:4])
    if stride == 1:
        y0, y1 = byte_perm(p[2], p[3], 0x5140), byte_perm(p[2], p[3], 0x7362)
        z0, z1 = byte_perm(p[4], p[5], 0x5140), byte_perm(p[4], p[5], 0x7362)
        return lo + [byte_perm(y0, z0, 0x5410), byte_perm(y0, z0, 0x7632),
                     byte_perm(y1, z1, 0x5410), byte_perm(y1, z1, 0x7632)]
    return lo + [byte_perm(lo[j], p[4], 0x32 | (4 + j) << 8 | (4 + j) << 12)
                 for j in range(4)]


def mac_row(acc, cw, wa, stride):
    for j in range(4):
        w0 = wa[j]
        if stride == 1:
            w1 = (w0 << 8) & 0xFFFFFFFF
            acc[j][0] = dp4a(cw[j], w0, acc[j][0])
            acc[j][1] = dp4a(cw[j], w1, acc[j][1])
            acc[j][2] = dp4a(cw[4 + j], w0, acc[j][2])
            acc[j][3] = dp4a(cw[4 + j], w1, acc[j][3])
        else:
            acc[j][0] = dp4a(cw[j], w0, acc[j][0])
            acc[j][1] = dp4a(cw[4 + j], w0, acc[j][1])


def stage_halo(p, x, t, buf, stride, pad_lo, pad):
    """The kernel's stage_halo: each thread's (column, rows) share, every
    granule of the halo staged exactly once."""
    n_img, h, w, c = x.shape
    sl, rest = t % p.slices, t // p.slices
    tx, rest = rest % p.tiles_x, rest // p.tiles_x
    ty, n = rest % p.tiles_y, rest // p.tiles_y
    c0 = sl * p.cb
    iy0, ix0 = ty * p.th * stride - pad_lo, tx * p.tw * stride - pad_lo
    gpp = p.cb // p.granule
    cols = p.hw * gpp
    staged = np.zeros((p.hh, cols), np.int32)
    for tid in range(p.threads):
        ways, col, col_step, hr0 = p.threads // cols, tid, p.threads, 0
        if ways > 1:
            hr0 = tid // cols
            col = tid - hr0 * cols if hr0 < ways else cols
            col_step = cols
        else:
            ways = 1
        while col < cols:
            hc, k = divmod(col, gpp)
            ch, ix = c0 + k * p.granule, ix0 + hc
            for hr in range(hr0, p.hh, ways):
                iy = iy0 + hr
                dst = (hr * p.hw + hc) * p.pitch + k * p.granule
                if 0 <= ix < w and ch < c and 0 <= iy < h:
                    src = x[n, iy, ix, ch:ch + p.granule]
                    assert src.size == p.granule
                    buf[dst:dst + p.granule] = src.view(np.uint8)
                else:
                    buf[dst:dst + p.granule] = np.uint8(pad & 0xFF)
                staged[hr, col] += 1
            col += col_step
    assert (staged == 1).all()


def emulate(x, wp, a, b, *, stride, pad, pad_lo=1, lo=-128, hi=127,
            mode="codes", relu=False, plan=None, grid=None):
    """The kernel on numpy arrays: x (N, H, W, C) int8, wp (9, C) int8,
    a, b (C,) float32."""
    n_img, h, w, c = x.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    p = plan or D.plan(n_img, h, w, c, stride)
    assert c % D.GRANULE == 0 and p.threads <= D.MAX_THREADS
    assert p.smem <= 232448 and p.pitch % p.granule == 0
    r = D.columns(stride)
    grid = grid or p.tiles          # a multiple of the slice count
    assert grid % p.slices == 0 and p.slices <= grid <= p.tiles
    out = np.zeros((n_img, ho, wo, c),
                   np.int8 if mode == "codes" else np.float32)
    written = np.zeros(out.shape, np.int32)
    tid = np.arange(p.threads)
    cq = tid % (p.cb // 4)
    j = tid // (p.cb // 4) % p.cg
    r0 = tid // (p.cb // 4 * p.cg) * p.rpt
    wbytes = wp.reshape(-1).view(np.uint8)
    row_step = p.hw * p.pitch
    for blk in range(grid):
        ch = blk % p.slices * p.cb + 4 * cq
        c_in = ch < c
        # load_weights: the tap words of the thread's 4 channels
        chs = np.where(c_in, ch, 0)
        wa = []
        for dy in range(3):
            tap = [np.where(c_in, words(wbytes, (3 * dy + dx) * c + chs), 0)
                   .astype(np.uint32) for dx in range(3)]
            wa.append(transpose4(*tap, np.zeros(p.threads, np.uint32)))
        ea = [np.where(c_in, a[np.minimum(chs + k, c - 1)], 0)
              .astype(np.float32) for k in range(4)]
        eb = [np.where(c_in, b[np.minimum(chs + k, c - 1)], 0)
              .astype(np.float32) for k in range(4)]
        bufs = [np.full(p.smem // 2, JUNK, np.uint8) for _ in range(2)]
        cur = 0
        stage_halo(p, x, blk, bufs[0], stride, pad_lo, pad)
        for t in range(blk, p.tiles, grid):
            if t + grid < p.tiles:
                stage_halo(p, x, t + grid, bufs[cur ^ 1], stride, pad_lo,
                           pad)
            rest = t // p.slices
            tx, rest = rest % p.tiles_x, rest // p.tiles_x
            ty, n = rest % p.tiles_y, rest // p.tiles_y
            buf = bufs[cur]
            q = (r * stride * j) * p.pitch + 4 * cq
            ox = tx * p.tw + r * j
            cw = [row_words(buf, q + r0 * stride * row_step, p.pitch,
                            stride)]
            if stride == 1:
                cw.append(row_words(buf, q + (r0 + 1) * row_step, p.pitch,
                                    stride))
            for i in range(p.rpt):
                oy = ty * p.th + r0 + i
                hr = q + ((r0 + i) * stride + 2) * row_step
                acc = [[np.zeros(p.threads, np.int32) for _ in range(r)]
                       for _ in range(4)]
                if stride == 1:
                    cw.append(row_words(buf, hr, p.pitch, stride))
                    for dy in range(3):
                        mac_row(acc, cw[dy], wa[dy], stride)
                    cw = cw[1:]
                else:
                    mac_row(acc, cw[0], wa[0], stride)
                    mac_row(acc, row_words(buf, hr - row_step, p.pitch,
                                           stride), wa[1], stride)
                    cw = [row_words(buf, hr, p.pitch, stride)]
                    mac_row(acc, cw[0], wa[2], stride)
                for k in range(r):
                    ok = c_in & (ox + k < wo) & (oy < ho)
                    for u in range(4):
                        y = (acc_to_float(acc[u][k]) * ea[u]) + eb[u]
                        if mode == "codes":
                            v = code_of(y, lo, hi)
                        else:
                            v = np.maximum(y, np.float32(0)) if relu else y
                        for th in np.flatnonzero(ok):
                            out[n, oy[th], ox[th] + k, ch[th] + u] = v[th]
                            written[n, oy[th], ox[th] + k, ch[th] + u] += 1
            cur ^= 1
    assert (written == 1).all()
    return out


def _operands(seed, n, h, w, c):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wp = rng.integers(-128, 128, (9, c), dtype=np.int8)
    a = (rng.random(c, dtype=np.float32) * 1e-3 + 1e-5).astype(np.float32)
    b = (rng.standard_normal(c).astype(np.float32) * 4).astype(np.float32)
    return x, wp, a, b


def _check(n, h, w, c, stride, pad_lo, seed, plan=None, grid=None):
    x, wp, a, b = _operands(seed, n, h, w, c)
    for kw in (dict(mode="codes", lo=-3, hi=90), dict(mode="codes"),
               dict(mode="f32", relu=True), dict(mode="f32")):
        got = emulate(x, wp, a, b, stride=stride, pad=-11, pad_lo=pad_lo,
                      plan=plan, grid=grid, **kw)
        want = D.int8_dwconv3x3_plain(
            torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(a),
            torch.from_numpy(b), stride=stride, pad=-11, pad_lo=pad_lo,
            **kw).numpy()
        assert np.array_equal(got, want), kw


GEOMETRIES = [(1, 1), (2, 0), (2, 1)]        # (stride, pad_lo)


@pytest.mark.parametrize("c", [8, 24, 40, 96, 144])
@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=lambda g: f"s{g[0]}p{g[1]}")
def test_emulation_equals_plain_channels(geometry, c):
    stride, pad_lo = geometry
    _check(2, 9, 10, c, stride, pad_lo, seed=c + stride)


# tests/test_torch_dwconv.py's RAGGED card shapes, (h, w, c, stride, pad_lo)
RAGGED = [(1, 1, 16, 1, 1), (3, 5, 16, 2, 1), (9, 13, 48, 2, 1),
          (2, 17, 2880, 1, 1), (31, 30, 80, 2, 0), (15, 1, 32, 2, 1),
          (5, 7, 8, 1, 1), (12, 10, 24, 2, 0), (9, 11, 40, 1, 1),
          (20, 19, 24, 1, 1), (13, 6, 40, 2, 1)]


@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_emulation_equals_plain_ragged(shape):
    _check(2, *shape, seed=shape[0] * shape[1])


@pytest.mark.parametrize("shape", [(1, 14, 14, 576, 2, 0),
                                   (2, 14, 14, 512, 1, 1)],
                         ids=["mobilenet_v2_14x14x576_s2",
                              "mobileone_s1_14x14x512_s1"])
def test_emulation_equals_plain_mobile_layer(shape):
    _check(*shape, seed=shape[3])


@pytest.mark.parametrize("case", [(2, 13, 11, 24, 1, 1, (32, 2, 2, 3)),
                                  (2, 12, 9, 96, 2, 0, (64, 2, 1, 2)),
                                  (1, 9, 16, 40, 2, 1, (32, 3, 3, 1))],
                         ids=["s1_c24", "s2_c96_cb64_tail", "s2_c40"])
def test_emulation_walks_many_tiles_a_block(case):
    """A grid of one slice's blocks: each walks its slice's tiles with the
    two buffers, on small tiles (a 64-channel slice with a masked tail)."""
    n, h, w, c, stride, pad_lo, override = case
    p = D.make_plan(n, h, w, c, stride, *override)
    assert p.tiles // p.slices >= 4
    _check(n, h, w, c, stride, pad_lo, seed=c, plan=p, grid=p.slices)


# the depthwise convs of MobileNetV2 (widths 1.0 and 0.75) and MobileOne-S1
# at 224², (h, w, c, stride)
ZOO = [(112, 112, 32, 1), (112, 112, 96, 2), (56, 56, 144, 1),
       (56, 56, 144, 2), (28, 28, 192, 1), (28, 28, 192, 2),
       (14, 14, 384, 1), (14, 14, 576, 1), (14, 14, 576, 2), (7, 7, 960, 1),
       (112, 112, 24, 1), (112, 112, 64, 2), (56, 56, 96, 1), (56, 56, 96, 2),
       (14, 14, 512, 1), (14, 14, 512, 2), (28, 28, 288, 1), (14, 14, 432, 1),
       (14, 14, 432, 2), (7, 7, 720, 1)]


@pytest.mark.parametrize("n", [1, 8, 256])
def test_plan_within_the_kernels_limits(n):
    for h, w, c, stride in ZOO:
        p = D.plan(n, h, w, c, stride)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        assert p.cb % 8 == 0 and (c % p.cb == 0 or p.cb == 32)
        assert p.threads <= D.MAX_THREADS
        assert p.smem <= D.HALF_SMEM and p.tiles < D.INT_LIMIT
        assert p.granule == (16 if c % 16 == 0 and p.cb % 16 == 0 else 8)
        assert p.tiles_y * p.th >= ho and p.tiles_x * p.tw >= wo
        # no tile is all padding, and a padded tile wastes under half
        assert (p.tiles_y - 1) * p.th < ho and (p.tiles_x - 1) * p.tw < wo
        assert p.tiles_y * p.th * p.tiles_x * p.tw < 2 * ho * wo
        assert p == D.make_plan(n, h, w, c, stride, p.cb, p.cg, p.rg, p.rpt)

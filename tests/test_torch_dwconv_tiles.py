"""A tile-faithful CPU emulation of the int8 depthwise kernel
(``ops/cuda/csrc/int8_dwconv.cuh``: the aligned 3×3 build
``int8_dwconv3x3.cu`` and the wide build ``int8_dwconv5x5.cu``), held
equal to its plain version.

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

The wide build the same way: the 5×5 window's tap rows' (lo, hi) weight
words and ``__funnelshift_l``, its two channel words of a halo row and
the five rows a thread keeps as it walks down the tile, the window sums
of a weight offset's term against words of ones; the ragged path's row
runs (each halo row one run at the pitch C, placed at its source address
mod 16 for codes at every offset from a 16-byte boundary, its 16-byte
chunks and head and tail words as each thread takes them, aligned on
both sides, every byte of a row staged once), its cells at granule 4 or
1 elsewhere, its weights, a, b and the term's coefficient read channel by
channel (W4 nibbles from rows of ⌈C/2⌉ bytes), its whole-quad stores at
their alignment and, below ``STAGED_C``, its output rows staged in shared
memory and copied out in 16- or 4-byte units (each unit once, from bytes
that output row wrote).  k ∈ {3, 5}, every pad form (k // 2 at strides 1
and 2, k // 2 − 1 at stride 2), C ∈ {1, 3, 6, 12, 18, 20, 36, 92, 100,
672}, W8 and W4, with and without the term, on the plan's tiles and on
forced small ones, each of GhostNet-1.0's ragged shapes and the 5×5
shapes of GhostNet-1.0 and EfficientNet-B0 at batch 1 in their requests'
modes; and the plan at every depthwise shape of the two models.

The 1×1 window's kernel (MobileOne's scale branches) the same way at
every C above and both strides, W8 and W4, with and without the term:
the grid of pixel blocks by channel slices, each thread's granule of
channels (16 or 8 bytes on the aligned path, 4 or 1 on the ragged one)
and pixel lane, its walk over the pixels, its one load of a pixel's
granule (the pad code outside the map), the products and epilogue in
float32 steps, and its whole-granule stores, each output once; on the
plan's grid, on one block a slice (each thread walks many pixels) and
with pads passed in.
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


def funnelshift_l(lo, hi, shift: int):
    """CUDA's ``__funnelshift_l(lo, hi, shift)``: the high word of
    (hi:lo) << shift."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v << np.uint64(shift)) >> np.uint64(32)).astype(np.uint32)


def row_words5(buf, q, pitch, stride):
    """The 5×5 window's two channel words of a halo row."""
    p = [words(buf, q + k * pitch) for k in range(8 if stride == 1 else 7)]
    if stride == 2:
        p.append(p[6])
    return transpose4(*p[:4]) + transpose4(*p[4:])


def mac_row5(acc, cw, wlo, whi, stride):
    for j in range(4):
        for k in range(len(acc[j])):
            d = 8 * stride * k
            lo = (wlo[j].astype(np.uint64) << np.uint64(d)).astype(np.uint32)
            acc[j][k] = dp4a(cw[j], lo, acc[j][k])
            acc[j][k] = dp4a(cw[4 + j], funnelshift_l(wlo[j], whi[j], d),
                             acc[j][k])


def tile_of(p, t):
    """Tile t → (image, tile row, tile column)."""
    rest = t // p.slices
    tx, rest = rest % p.tiles_x, rest // p.tiles_x
    return rest // p.tiles_y, rest % p.tiles_y, tx


def stage_halo(p, x, t, buf, stride, pad_lo, pad):
    """The kernel's stage_halo: each thread's (column, rows) share, every
    granule of the halo staged exactly once."""
    n_img, h, w, c = x.shape
    n, ty, tx = tile_of(p, t)
    c0 = t % p.slices * p.cb
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


def run_shift(p, x, t, stride, pad_lo, x_addr):
    """The kernel's run_shift: the address of the tile's halo pixel (iy0,
    ix0) mod 16 on the runs layout (``x_addr`` the address of x), else 0."""
    if not p.runs:
        return 0
    _, h, w, c = x.shape
    n, ty, tx = tile_of(p, t)
    pixel = (n * h + ty * p.th * stride - pad_lo) * w + tx * p.tw * stride \
        - pad_lo
    return (x_addr + pixel * c) % 16


def stage_runs(p, x, t, buf, stride, pad_lo, pad, x_addr):
    """The kernel's stage_runs: each thread's (16-byte chunk, rows) share,
    a chunk wholly inside the row's run one 16-byte copy (aligned in shared
    memory and in device memory), else word by word: a 4-byte copy in the
    run, the pad code outside it; every byte of each halo row staged once
    and no byte besides."""
    _, h, w, c = x.shape
    n, ty, tx = tile_of(p, t)
    iy0, ix0 = ty * p.th * stride - pad_lo, tx * p.tw * stride - pad_lo
    flat = x.reshape(-1).view(np.uint8)
    span = p.hw * c
    run0, run1 = max(0, -ix0) * c, min(p.hw, w - ix0) * c
    shift = run_shift(p, x, t, stride, pad_lo, x_addr)
    staged = np.zeros(buf.size, np.int32)
    for tid in range(p.threads):
        ways, col, col_step, hr0 = p.threads // p.chunks, tid, p.threads, 0
        if ways > 1:
            hr0 = tid // p.chunks
            col = tid - hr0 * p.chunks if hr0 < ways else p.chunks
            col_step = p.chunks
        else:
            ways = 1
        while col < p.chunks:
            for hr in range(hr0, p.hh, ways):
                row0 = shift + hr * p.row_pitch
                lo = ((row0 >> 4) + col) * 16 - row0
                if lo >= span:
                    continue
                iy = iy0 + hr
                row_in = 0 <= iy < h
                frm = ((n * h + iy) * w + ix0) * c
                dst = row0 + lo
                if row_in and lo >= run0 and lo + 16 <= run1:
                    assert dst % 16 == 0 and (x_addr + frm + lo) % 16 == 0
                    buf[dst:dst + 16] = flat[frm + lo:frm + lo + 16]
                    staged[dst:dst + 16] += 1
                    continue
                for i in range(4):
                    o, d = lo + 4 * i, dst + 4 * i
                    if o < 0 or o >= span:
                        continue
                    assert d % 4 == 0
                    if row_in and run0 <= o < run1:
                        assert (x_addr + frm + o) % 4 == 0
                        buf[d:d + 4] = flat[frm + o:frm + o + 4]
                    else:
                        buf[d:d + 4] = np.uint8(pad & 0xFF)
                    staged[d:d + 4] += 1
            col += col_step
    want = np.zeros(buf.size, np.int32)
    for hr in range(p.hh):
        want[shift + hr * p.row_pitch:shift + hr * p.row_pitch + span] = 1
    assert (staged == want).all()


def tap_words(wp, c, ch, c_in, tap, ragged):
    """The kernel's tap_word for every thread: the word of channels
    ch..ch+3 at ``tap`` (W4 ``wp`` is uint8 nibbles).  The aligned path's
    W4 word is its W8 word (tests/test_torch_int4_kernels.py holds
    unpack_pair to it); the ragged path reads channel by channel."""
    w4 = wp.dtype == np.uint8
    if not ragged:
        chs = np.where(c_in, ch, 0)
        w8 = (D.int8_weight(torch.from_numpy(wp), c).numpy() if w4 else wp)
        return np.where(c_in, words(w8.reshape(-1).view(np.uint8),
                                    tap * c + chs), 0).astype(np.uint32)
    word = np.zeros(ch.shape, np.uint32)
    for j in range(4):
        valid = ch + j < c
        cj = np.where(valid, ch + j, 0)
        if w4:
            u = wp.reshape(-1)[tap * ((c + 1) // 2) + cj // 2].astype(np.int32)
            v = (((u >> (4 * (cj & 1))) & 0xF) ^ 8) - 8
        else:
            v = wp.reshape(-1)[tap * c + cj].astype(np.int32)
        word |= np.where(valid, v & 0xFF, 0).astype(np.uint32) << (8 * j)
    return word


def emulate_1x1(x, wp, a, b, *, stride, pad, lo=-128, hi=127, mode="codes",
                relu=False, plan=None, grid=None, offset=None, ragged=0,
                x_addr=0, pads=None):
    """The 1×1 window's kernel on numpy arrays (the module docstring's
    last paragraph); ``pads`` ((top, bottom), (left, right)) or None (no
    pad, ⌈H/s⌉ rows)."""
    n_img, h, w, c = x.shape
    if mode != "codes":      # f32 takes granules of 4 (D.route)
        ragged = 4 if c % 4 == 0 else 1
    top, left, ho, wo = D.geometry(h, w, 1, stride, 0, pads)
    p = plan or D.plan(n_img, h, w, c, stride, 1, ragged,
                       None if pads is None else (ho, wo))
    g = p.granule
    assert g == (ragged or (16 if c % 16 == 0 and p.cb % 16 == 0 else 8))
    assert c % g == 0 and p.cb % g == 0 and x_addr % g == 0
    cq = p.cb // g
    assert p.threads == cq * p.cg <= D.MAX_THREADS and p.rg == p.rpt == 1
    assert p.slices == -(-c // p.cb)
    pixels = n_img * ho * wo
    grid = grid or p.tiles_x
    wv = D.int8_weight(torch.from_numpy(wp), c).numpy()[0].astype(np.int32)
    out = np.zeros((n_img, ho, wo, c),
                   np.int8 if mode == "codes" else np.float32)
    written = np.zeros(out.shape, np.int32)
    t = np.arange(p.threads)
    lane = t // cq
    for by in range(p.slices):
        ch0 = (by * cq + t % cq) * g
        live = (lane < p.cg) & (ch0 < c)
        for bx in range(grid):
            for m0 in range(bx * p.cg, pixels, grid * p.cg):
                m = m0 + lane
                ok = live & (m < pixels)
                q, rest = m % wo, m // wo
                pp, nn = rest % ho, rest // ho
                iy, ix = pp * stride - top, q * stride - left
                inmap = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                for j in range(g):
                    ch = np.minimum(ch0 + j, c - 1)
                    src = x[np.minimum(nn, n_img - 1), np.clip(iy, 0, h - 1),
                            np.clip(ix, 0, w - 1), ch].astype(np.int32)
                    xv = np.where(inmap, src, np.int32(pad))
                    y = acc_to_float(xv * wv[ch]) * a[ch]
                    if offset is not None:
                        y = y + acc_to_float(xv - np.int32(pad)) * offset[ch]
                    y = y + b[ch]
                    v = code_of(y, lo, hi) if mode == "codes" else (
                        np.maximum(y, np.float32(0)) if relu else y)
                    idx = (nn[ok], pp[ok], q[ok], (ch0 + j)[ok])
                    out[idx] = v[ok]
                    np.add.at(written, idx, 1)
    assert (written == 1).all()
    return out


def emulate(x, wp, a, b, *, stride, pad, pad_lo=None, lo=-128, hi=127,
            mode="codes", relu=False, plan=None, grid=None, offset=None,
            ragged=0, x_addr=0):
    """The kernel on numpy arrays: x (N, H, W, C) int8, wp (k², C) int8
    or (k², ⌈C/2⌉) uint8 nibbles, a, b (and the term's offset, or None)
    (C,) float32; ``ragged`` the path (:func:`.route`), ``x_addr`` the
    address of x mod 16 (4-byte aligned at granule 4, 16 on the aligned
    path).  The 1×1 window: :func:`emulate_1x1`."""
    n_img, h, w, c = x.shape
    k = D.window(torch.from_numpy(wp))
    if k == 1:
        return emulate_1x1(x, wp, a, b, stride=stride, pad=pad, lo=lo,
                           hi=hi, mode=mode, relu=relu, plan=plan, grid=grid,
                           offset=offset, ragged=ragged, x_addr=x_addr)
    pad_lo = k // 2 if pad_lo is None else pad_lo
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    p = plan or D.plan(n_img, h, w, c, stride, k, ragged)
    assert (c % D.GRANULE == 0) or ragged
    assert p.threads <= D.MAX_THREADS and p.cb % 4 == 0
    assert p.smem <= 232448 and p.pitch % p.granule == 0
    assert x_addr % (p.granule if ragged else 16) == 0
    assert p.runs == (ragged == 4 and p.cb == c)
    assert bool(p.stage_row) == (p.runs and c < D.STAGED_C)
    assert p.row_pitch >= p.hw * p.pitch
    if p.runs:     # rows at W·C mod 16, so a run keeps its alignment; the
        # second buffer at a 16-byte boundary
        assert p.pitch == c and (p.row_pitch - w * c) % 16 == 0
        assert p.smem % 32 == 0
    assert p.granule == (ragged or (16 if c % 16 == 0 and p.cb % 16 == 0
                                    else 8))
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
    row_step = p.row_pitch
    kept = 5 - stride                 # 5×5: halo rows an output row passes on
    zero = np.zeros(p.threads, np.uint32)
    ones = [np.full(p.threads, 0x00010101, np.uint32)] * 4
    ones_lo = [np.full(p.threads, 0x01010101, np.uint32)] * 4
    ones_hi = [np.full(p.threads, 0x00000001, np.uint32)] * 4
    pad_sum = np.int32(k * k * pad)
    for blk in range(grid):
        ch = blk % p.slices * p.cb + 4 * cq
        c_in = ch < c
        # load_weights: the tap words of the thread's 4 channels
        taps = [tap_words(wp, c, ch, c_in, t, ragged) for t in range(k * k)]
        if k == 3:
            wa = [transpose4(*taps[3 * dy:3 * dy + 3], zero)
                  for dy in range(3)]
        else:
            wlo = [transpose4(*taps[5 * dy:5 * dy + 4]) for dy in range(5)]
            whi = [transpose4(taps[5 * dy + 4], zero, zero, zero)
                   for dy in range(5)]
        # load_affine: per quad, or per channel on the ragged path
        inside = [(ch + u < c) if ragged else c_in for u in range(4)]
        at = [np.minimum(ch + u, c - 1) for u in range(4)]
        ea = [np.where(inside[u], a[at[u]], 0).astype(np.float32)
              for u in range(4)]
        eb = [np.where(inside[u], b[at[u]], 0).astype(np.float32)
              for u in range(4)]
        ec = [np.where(inside[u], offset[at[u]], 0).astype(np.float32)
              if offset is not None else None for u in range(4)]
        half = (p.smem - 2 * p.rg * p.stage_row) // 2
        bufs = [np.full(half, JUNK, np.uint8) for _ in range(2)]
        stages = [np.full(p.rg * p.stage_row, JUNK, np.uint8)
                  for _ in range(2)]
        cur = 0

        def stage(t, buf):
            if p.runs:
                stage_runs(p, x, t, buf, stride, pad_lo, pad, x_addr)
            else:
                stage_halo(p, x, t, buf, stride, pad_lo, pad)

        stage(blk, bufs[0])
        for t in range(blk, p.tiles, grid):
            if t + grid < p.tiles:
                stage(t + grid, bufs[cur ^ 1])
            n, ty, tx = tile_of(p, t)
            buf = bufs[cur]
            q = run_shift(p, x, t, stride, pad_lo, x_addr) \
                + (r * stride * j) * p.pitch + 4 * cq
            ox = tx * p.tw + r * j
            if k == 5:
                hq = q + r0 * stride * row_step
                cw = [row_words5(buf, hq + u * row_step, p.pitch, stride)
                      for u in range(kept)]
            else:
                cw = [row_words(buf, q + r0 * stride * row_step, p.pitch,
                                stride)]
                if stride == 1:
                    cw.append(row_words(buf, q + (r0 + 1) * row_step,
                                        p.pitch, stride))
            for i in range(p.rpt):
                oy = ty * p.th + r0 + i
                hr = q + ((r0 + i) * stride + 2) * row_step
                acc = [[np.zeros(p.threads, np.int32) for _ in range(r)]
                       for _ in range(4)]
                sums = [[np.zeros(p.threads, np.int32) for _ in range(r)]
                        for _ in range(4)]
                if k == 5:
                    cw += [row_words5(buf, hq + (i * stride + u) * row_step,
                                      p.pitch, stride)
                           for u in range(kept, 5)]
                    for dy in range(5):
                        mac_row5(acc, cw[dy], wlo[dy], whi[dy], stride)
                        mac_row5(sums, cw[dy], ones_lo, ones_hi, stride)
                    cw = cw[stride:]
                elif stride == 1:
                    cw.append(row_words(buf, hr, p.pitch, stride))
                    for dy in range(3):
                        mac_row(acc, cw[dy], wa[dy], stride)
                        mac_row(sums, cw[dy], ones, stride)
                    cw = cw[1:]
                else:
                    rows = [cw[0], row_words(buf, hr - row_step, p.pitch,
                                             stride)]
                    cw = [row_words(buf, hr, p.pitch, stride)]
                    for dy, row in enumerate(rows + cw):
                        mac_row(acc, row, wa[dy], stride)
                        mac_row(sums, row, ones, stride)
                vals = [[None] * 4 for _ in range(r)]
                for kk in range(r):
                    for u in range(4):
                        y = acc_to_float(acc[u][kk]) * ea[u]
                        if offset is not None:
                            y = y + acc_to_float(sums[u][kk] - pad_sum) \
                                * ec[u]
                        y = y + eb[u]
                        if mode == "codes":
                            vals[kk][u] = code_of(y, lo, hi)
                        else:
                            vals[kk][u] = np.maximum(y, np.float32(0)) \
                                if relu else y
                if p.stage_row:
                    store_staged(p, stages[i & 1], vals, out, written, n,
                                 ty, tx, i, r0, j, ch, r, wo, ho)
                    continue
                for kk in range(r):
                    ok = c_in & (ox + kk < wo) & (oy < ho)
                    for u in range(4):
                        v = vals[kk][u]
                        st = ok & (ch + u < c) if ragged else ok
                        if c % 4 == 0:
                            # a whole quad a store, inside C: one word of
                            # codes (4-byte aligned) or one float4 (16)
                            o = ((n * ho + oy) * wo + ox + kk) * c + ch
                            assert (o[ok] % 4 == 0).all()
                            assert (ch[ok] + 4 <= c).all()
                        idx = (n, oy[st], ox[st] + kk, ch[st] + u)
                        out[idx] = v[st]
                        np.add.at(written, idx, 1)
            cur ^= 1
    assert (written == 1).all()
    return out


def store_staged(p, stage, vals, out, written, n, ty, tx, i, r0, j, ch, r,
                 wo, ho):
    """The kernel's store_row_staged on the runs layout: each thread's R
    quads into its row group's row of the staging buffer (a float4 or a
    word at its alignment), then the block's rows inside the map copied out
    in units of 16 bytes (f32) or 4 (codes), each unit once and only from
    bytes this output row wrote."""
    c = out.shape[-1]
    size = out.itemsize
    unit = 4 * size
    fresh = np.zeros(stage.size, bool)
    for kk in range(r):
        at = (r0 // p.rpt) * p.stage_row + ((r * j + kk) * c + ch) * size
        assert (at % unit == 0).all()
        quad = np.stack([vals[kk][u].astype(out.dtype) for u in range(4)], 1)
        idx = at[:, None] + np.arange(unit)
        stage[idx] = quad.view(np.uint8).reshape(len(at), unit)
        fresh[idx] = True
    units = min(p.tw, wo - tx * p.tw) * c * size // unit
    flat, done = out.reshape(-1).view(np.uint8), written.reshape(-1)
    for rr in range(p.rg):
        oy = ty * p.th + rr * p.rpt + i
        if oy >= ho:
            continue
        src = rr * p.stage_row + np.arange(units * unit)
        assert fresh[src].all()
        dst = ((n * ho + oy) * wo + tx * p.tw) * c * size
        flat[dst:dst + units * unit] = stage[src]
        done[dst // size:dst // size + units * unit // size] += 1


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


WIDE_C = [1, 3, 6, 12, 18, 20, 36, 92, 100, 672]
# (w4, term) pairs, two a geometry: every pair at every (k, C)
WEIGHTS_TERMS = [((False, False), (True, True)), ((False, True),
                                                  (True, False)),
                 ((True, True), (False, False))]


def _ragged(c: int) -> int:
    """:func:`.route` for codes and weights at the allocator's alignment."""
    return 0 if c % 8 == 0 else 4 if c % 4 == 0 else 1


def _wide_check(n, h, w, c, k, stride, pad_lo, w4, term, seed, plan=None,
                grid=None, ragged=None, x_addr=0, modes=None):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    span = 8 if w4 else 128
    wk = torch.from_numpy(rng.integers(-span, span, (k, k, 1, c),
                                       dtype=np.int8))
    wp = (D.pack_weight_int4 if w4 else D.pack_weight)(wk).numpy()
    a = (rng.random(c, dtype=np.float32) * 1e-3 + 1e-5).astype(np.float32)
    b = (rng.standard_normal(c).astype(np.float32) * 4).astype(np.float32)
    oc = (rng.standard_normal(c).astype(np.float32) * 1e-3).astype(
        np.float32) if term else None
    ragged = _ragged(c) if ragged is None else ragged
    for kw in modes or (dict(mode="codes", lo=-3, hi=90),
                        dict(mode="f32", relu=True)):
        got = emulate(x, wp, a, b, stride=stride, pad=-11, pad_lo=pad_lo,
                      plan=plan, grid=grid, offset=oc, ragged=ragged,
                      x_addr=x_addr, **kw)
        want = D.int8_dwconv3x3_plain(
            torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(a),
            torch.from_numpy(b), stride=stride, pad=-11, pad_lo=pad_lo,
            offset=None if oc is None else torch.from_numpy(oc),
            **kw).numpy()
        assert np.array_equal(got, want), (kw, k, c, stride, pad_lo, w4,
                                           term, ragged)


@pytest.mark.parametrize("c", WIDE_C)
@pytest.mark.parametrize("k", D.WINDOWS)
def test_emulation_equals_plain_any_window_and_c(k, c):
    """Every pad form at both strides, W8 and W4, with and without a
    weight offset's term, on the plan's tiles: the 5×5 window on either
    path, the ragged path of either window where C % 8 != 0 (row runs at C
    % 4 == 0, from codes at 0, 4 and 8 bytes past a 16-byte boundary)."""
    geometries = [(1, k // 2), (2, k // 2), (2, max(k // 2 - 1, 0))]
    for i, (stride, pad_lo) in enumerate(geometries):
        for w4, term in WEIGHTS_TERMS[i]:
            _wide_check(2, 7, 9 if stride == 1 else 8, c, k, stride, pad_lo,
                        w4, term, seed=k * 1000 + c + i,
                        x_addr=4 * i if _ragged(c) == 4 else 0)


@pytest.mark.parametrize("case", [(2, 13, 11, 24, 5, 1, 2, 0, (32, 2, 2, 3)),
                                  (2, 12, 9, 96, 5, 2, 1, 0, (64, 2, 1, 2)),
                                  (2, 13, 11, 20, 3, 1, 1, 4, (8, 2, 2, 3)),
                                  (2, 12, 9, 18, 5, 2, 2, 1, (8, 2, 1, 2)),
                                  (1, 9, 16, 100, 3, 2, 0, 4, (32, 3, 3, 1)),
                                  (2, 9, 10, 16, 3, 1, 1, 1, (8, 2, 1, 2))],
                         ids=["5x5_s1_c24", "5x5_s2_c96_cb64_tail",
                              "ragged_s1_c20", "ragged_5x5_s2_c18",
                              "ragged_s2_c100_cb32_tail",
                              "ragged_bytes_c16_unaligned"])
def test_emulation_walks_many_tiles_wide(case):
    """A grid of one slice's blocks on small tiles, so that each block
    walks its slice's tiles with the two buffers; the 5×5 window and the
    ragged path with masked tail slices, and a C % 8 == 0 map staged byte
    by byte (codes off 16-byte alignment)."""
    n, h, w, c, k, stride, pad_lo, ragged, override = case
    p = D.make_plan(n, h, w, c, stride, *override, k, ragged)
    assert p.tiles // p.slices >= 4
    _wide_check(n, h, w, c, k, stride, pad_lo, c % 3 == 0, True, seed=c,
                plan=p, grid=p.slices, ragged=ragged)


@pytest.mark.parametrize("case", [(2, 13, 11, 20, 3, 1, 1, 0, (20, 2, 2, 3)),
                                  (2, 11, 13, 12, 3, 1, 1, 4, (12, 2, 1, 3)),
                                  (2, 12, 9, 12, 5, 2, 2, 8, (12, 2, 1, 2)),
                                  (1, 9, 15, 36, 3, 2, 0, 12, (36, 3, 3, 1)),
                                  (2, 10, 10, 28, 5, 1, 2, 4, (28, 1, 3, 2))],
                         ids=["runs_s1_c20", "runs_s1_c12_addr4",
                              "runs_5x5_s2_c12_addr8",
                              "runs_s2_c36_addr12", "runs_5x5_s1_c28_addr4"])
def test_emulation_walks_many_tiles_runs(case):
    """The row runs on small tiles, so that each block walks its tiles with
    the two buffers and every tile has its own alignment shift: codes at
    each offset from a 16-byte boundary, rows of W·C ≠ 0 mod 16 bytes."""
    n, h, w, c, k, stride, pad_lo, x_addr, override = case
    p = D.make_plan(n, h, w, c, stride, *override, k, 4)
    assert p.runs and p.tiles // p.slices >= 4 and (w * c) % 16
    _wide_check(n, h, w, c, k, stride, pad_lo, c % 3 == 0, True, seed=c,
                plan=p, grid=p.slices, ragged=4, x_addr=x_addr)


# GhostNet-1.0's and EfficientNet-B0's depthwise convs at 224², (h, w, c,
# k, stride): those the aligned 3×3 path takes too
GHOST_EFFNET = [(112, 112, 8, 3, 1), (112, 112, 24, 3, 1),
                (112, 112, 48, 3, 2), (56, 56, 12, 3, 1),
                (112, 112, 16, 3, 2), (56, 56, 36, 3, 1),
                (56, 56, 72, 5, 2), (28, 28, 20, 3, 1), (56, 56, 24, 5, 2),
                (28, 28, 60, 3, 1), (28, 28, 120, 3, 1), (28, 28, 240, 3, 2),
                (14, 14, 40, 3, 1), (28, 28, 40, 3, 2), (14, 14, 100, 3, 1),
                (14, 14, 92, 3, 1), (14, 14, 240, 3, 1), (14, 14, 56, 3, 1),
                (14, 14, 80, 3, 1), (14, 14, 336, 3, 1), (14, 14, 672, 5, 2),
                (7, 7, 80, 3, 1), (14, 14, 112, 5, 2), (7, 7, 480, 3, 1),
                (112, 112, 32, 3, 1), (112, 112, 96, 3, 2),
                (56, 56, 144, 3, 1), (56, 56, 144, 5, 2),
                (28, 28, 240, 5, 1), (14, 14, 480, 3, 1),
                (14, 14, 480, 5, 1), (14, 14, 672, 5, 1), (7, 7, 1152, 5, 1),
                (7, 7, 1152, 3, 1)]


@pytest.mark.parametrize("n", [1, 8, 256])
def test_plan_within_the_kernels_limits_ghost_effnet(n):
    for h, w, c, k, stride in GHOST_EFFNET:
        ragged = _ragged(c)
        p = D.plan(n, h, w, c, stride, k, ragged)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        assert p.cb % (4 if ragged else 8) == 0 and p.cb >= 4
        assert p.threads <= D.MAX_THREADS
        assert p.smem <= D.HALF_SMEM and p.tiles < D.INT_LIMIT
        assert p.hh == (p.th - 1) * stride + k
        assert p.tiles_y * p.th >= ho and p.tiles_x * p.tw >= wo
        assert (p.tiles_y - 1) * p.th < ho and (p.tiles_x - 1) * p.tw < wo
        assert p == D.make_plan(n, h, w, c, stride, p.cb, p.cg, p.rg, p.rpt,
                                k, ragged)
        if ragged:
            # the whole pixel rounded up to a quad: one slice
            assert p.cb == -(-c // 4) * 4 and p.slices == 1


# GhostNet-1.0's ragged launches and the 5×5 ones of GhostNet-1.0 and
# EfficientNet-B0 (each shape once), (h, w, c, k, stride, pad_lo, mode):
# the mode their requests run them in
LAUNCHES = [(56, 56, 12, 3, 1, 1, "f32"), (56, 56, 36, 3, 1, 1, "f32relu"),
            (28, 28, 20, 3, 1, 1, "f32"), (28, 28, 60, 3, 1, 1, "f32relu"),
            (14, 14, 100, 3, 1, 1, "f32relu"),
            (14, 14, 92, 3, 1, 1, "f32relu"),
            (56, 56, 72, 5, 2, 2, "f32"), (56, 56, 24, 5, 2, 2, "codes"),
            (14, 14, 672, 5, 2, 2, "f32"), (14, 14, 112, 5, 2, 2, "codes"),
            (56, 56, 144, 5, 2, 2, "f32"), (28, 28, 240, 5, 1, 2, "f32"),
            (14, 14, 480, 5, 1, 2, "f32"), (14, 14, 672, 5, 1, 2, "f32"),
            (7, 7, 1152, 5, 1, 2, "f32")]
MODES = {"codes": dict(mode="codes", lo=-3, hi=90), "f32": dict(mode="f32"),
         "f32relu": dict(mode="f32", relu=True)}


@pytest.mark.parametrize("launch", LAUNCHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_emulation_equals_plain_ghost_effnet_launch(launch):
    """Each shape at batch 1 on the plan's tiles, in its request's mode."""
    h, w, c, k, stride, pad_lo, mode = launch
    _wide_check(1, h, w, c, k, stride, pad_lo, False, False, seed=c + h,
                modes=[MODES[mode]])

"""A tile-faithful CPU emulation of the int8 im2col kernel
(``ops/cuda/csrc/int8_im2col.cu``), held equal to its plain version.

The emulation does the kernel's work block by block on :func:`.plan`'s
tiles (and on small forced tiles): the shared memory of a block filled
with junk first, then the padded band staged as the kernel stages it,
each band row starting at the address of its first byte in x mod 16 (x's
address modelled by an offset, so every alignment shows), the pad code in
whole rows outside the map and in the columns outside it, the map's bytes
in 16-byte pieces (each checked 16-byte aligned in both memories) where
x's rows are whole pieces and bytes around and otherwise; every band byte
staged exactly once.  Then each thread's chunk column: the runs its
16-byte chunk meets ("pieces"), their byte masks, and for each pixel of
its passes the aligned little-endian 32-bit words of each piece (only the
words a mask needs, else 0), ``__funnelshift_r``, the masks, the OR, one
16-byte store; every chunk of every row written exactly once.  Tolerance
0, at ragged maps, k ∈ {1, 3, 5, 7}, strides 1 and 2, asymmetric pads,
C ∈ {3, 5, 16, 24, 40, 64}, pad codes −128, −3 and 0.  The plans: taken,
within shared memory, and covering every output once at ResNet-50's stem.
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import int8_im2col as I

JUNK = 0xA5              # what a shared byte holds before it is staged
SMEM_LIMIT = 232448      # an H100 block's shared memory (227 KB)


def byte_mask(lo: int, hi: int) -> int:
    if lo >= hi:
        return 0
    return ((1 << (8 * (hi - lo))) - 1) << (8 * lo)


def funnelshift_r(lo, hi, sh):
    """CUDA's ``__funnelshift_r(lo, hi, sh)`` on uint64 arrays of uint32."""
    return ((hi << np.uint64(32) | lo) >> sh) & np.uint64(0xFFFFFFFF)


def pieces(j: int, run: int, k_total: int, pitch: int, lead: int,
           maxp: int):
    """The kernel's pieces of chunk column ``j``: (poff, masks[4])."""
    out = []
    k, kend = 16 * j, min(16 * j + 16, k_total)
    dy, rem = k // run, k % run
    for _ in range(maxp):
        lo = k - 16 * j
        nb = min(run - rem, kend - k) if k < kend else 0
        poff = dy * pitch + lead + rem - lo if nb > 0 else 0
        masks = [byte_mask(max(lo, 4 * u) - 4 * u,
                           min(lo + nb, 4 * u + 4) - 4 * u) if nb > 0 else 0
                 for u in range(4)]
        out.append((poff, masks))
        k += nb
        dy += 1
        rem = 0
    assert k == max(kend, 16 * j), "a chunk met more runs than MAXP"
    return out


def emulate(x: np.ndarray, kernel: int, stride: int, pads, pad: int, p=None,
            base_addr: int = 0) -> np.ndarray:
    n0, h, w, c = x.shape
    pads = tuple(map(tuple, pads))
    p = p or I.plan(n0, h, w, c, kernel, stride, pads)
    (top, _), (left, _) = pads
    flat_x = x.reshape(-1).view(np.uint8)
    k_total = kernel * kernel * c
    run = kernel * c
    maxp = 3 if kernel == 1 or run >= 8 else 16
    vec = (w * c) % 16 == 0
    out = np.full((n0 * p.ho * p.wo, p.kp), JUNK, np.uint8)
    written = np.zeros((n0 * p.ho * p.wo, p.per_row), np.int64)
    assert p.smem <= I.MAX_SMEM and p.pitch % 16 == 0
    for block in range(p.tiles):
        tx = block % p.tiles_x
        ty = block // p.tiles_x % p.tiles_y
        n = block // (p.tiles_x * p.tiles_y)
        p0, q0 = ty * p.th, tx * p.tw
        th, tw = min(p.th, p.ho - p0), min(p.tw, p.wo - q0)
        rows = (th - 1) * stride + kernel
        cols = (tw - 1) * stride + kernel
        iy0, ix0 = p0 * stride - top, q0 * stride - left
        span = cols * c
        assert p.pitch >= span + 15
        smem = np.full(p.smem, JUNK, np.uint8)
        staged = np.zeros(p.smem, np.int64)
        band = I.GUARD
        cx_lo = max(0, -ix0)
        cx_hi = max(cx_lo, min(cols, w - ix0))
        lo_b, hi_b = cx_lo * c, cx_hi * c
        lead = (base_addr + ix0 * c) % 16 if vec else 0

        def put(addr, value):
            smem[addr] = value
            staged[addr] += 1

        # 1. the pad code
        for r in range(rows):
            row = band + r * p.pitch + lead
            iy = iy0 + r
            js = range(span) if not 0 <= iy < h else \
                list(range(lo_b)) + list(range(hi_b, span))
            for j in js:
                put(row + j, pad & 0xFF)
        # 2. the map's bytes
        r_lo = max(0, -iy0)
        r_hi = max(r_lo, min(rows, h - iy0))
        if hi_b > lo_b and r_hi > r_lo:
            head = min(hi_b - lo_b, (16 - (lead + lo_b) % 16) % 16) if vec \
                else hi_b - lo_b
            count = (hi_b - lo_b - head) // 16
            tail_b = lo_b + head + 16 * count
            for r in range(r_lo, r_hi):
                g0 = ((n * h + iy0 + r) * w + ix0) * c      # x's byte of j = 0
                row = band + r * p.pitch + lead
                for i in range(count):
                    j = lo_b + head + 16 * i
                    assert (row + j) % 16 == 0
                    assert (base_addr + g0 + j) % 16 == 0
                    for b in range(16):
                        put(row + j + b, flat_x[g0 + j + b])
                for j in list(range(lo_b, lo_b + head)) + \
                        list(range(tail_b, hi_b)):
                    put(row + j, flat_x[g0 + j])
        for r in range(rows):
            row = band + r * p.pitch + lead
            assert (staged[row:row + span] == 1).all(), \
                "a band byte not staged exactly once"
        assert staged.sum() == rows * span
        # 3. the rows: a thread per (chunk column j, pixel of a pass)
        words = smem.view(np.uint32).astype(np.uint64)   # little-endian
        for tid in range(I.THREADS):
            j, pix = tid % p.per_row, tid // p.per_row
            if pix >= p.step:
                continue
            ps = pieces(j, run, k_total, p.pitch, lead, maxp)
            pr, pq = divmod(pix, tw)
            dr, dq = divmod(p.step, tw)
            while pr < th:
                base = pr * stride * p.pitch + pq * stride * c
                v = [np.uint64(0)] * 4
                for poff, masks in ps:
                    a = band + base + poff
                    a4, sh = (a & ~3) // 4, np.uint64(8 * (a & 3))
                    need = [(e < 4 and masks[e] != 0)
                            or (e > 0 and masks[e - 1] != 0)
                            for e in range(5)]
                    wd = [words[a4 + e] if need[e] else np.uint64(0)
                          for e in range(5)]
                    for u in range(4):
                        v[u] |= funnelshift_r(wd[u], wd[u + 1], sh) \
                            & np.uint64(masks[u])
                orow = (n * p.ho + p0 + pr) * p.wo + q0 + pq
                out[orow, 16 * j:16 * j + 16] = np.array(
                    v, np.uint32).view(np.uint8)
                written[orow, j] += 1
                pq += dq
                pr += dr
                if pq >= tw:
                    pq -= tw
                    pr += 1
    assert (written == 1).all(), "a chunk not written exactly once"
    return out.view(np.int8)


CASES = [  # (n, h, w, c, kernel, stride, pads)
    (1, 17, 15, 3, 7, 2, ((2, 3), (3, 2))),
    (2, 9, 11, 16, 3, 1, ((1, 1), (1, 1))),
    (1, 13, 10, 24, 3, 2, ((0, 1), (1, 0))),
    (2, 7, 6, 64, 1, 1, ((0, 0), (0, 0))),
    (1, 9, 7, 40, 1, 2, ((1, 0), (0, 1))),
    (1, 10, 9, 5, 5, 1, ((2, 1), (0, 3))),
    (2, 11, 12, 5, 5, 2, ((1, 2), (2, 2))),
    (1, 12, 8, 16, 5, 1, ((2, 2), (2, 2))),
    (1, 6, 7, 3, 3, 1, ((1, 1), (1, 1))),
    (1, 16, 16, 3, 7, 2, ((2, 3), (2, 3))),
]


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape,
                                                dtype=np.int8)


def _plain(x, k, s, pads, pad):
    return I.int8_im2col_plain(torch.from_numpy(x), kernel=k, stride=s,
                               pads=pads, pad=pad).numpy()


@pytest.mark.parametrize("pad", [-128, -3, 0])
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:6])) for c in CASES])
def test_emulation_on_the_plan_equals_plain(case, pad):
    n, h, w, c, k, s, pads = case
    x = _codes((n, h, w, c), n * h * w + c + k)
    got = emulate(x, k, s, pads, pad)
    assert np.array_equal(got, _plain(x, k, s, pads, pad))


@pytest.mark.parametrize("tile,base", [((1, 1), 0), ((2, 3), 5),
                                       ((3, 2), 13), ((4, 5), 8)])
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:6])) for c in CASES])
def test_emulation_on_small_tiles_equals_plain(case, tile, base):
    """Forced small tiles (column tiles, a band that ends on the map's last
    row, halo rows of neighbouring bands) at x's address ``base`` mod 16."""
    n, h, w, c, k, s, pads = case
    x = _codes((n, h, w, c), h * w + k)
    p = I.make_plan(n, h, w, c, k, s, pads, *tile)
    got = emulate(x, k, s, pads, -7, p, base)
    assert np.array_equal(got, _plain(x, k, s, pads, -7))


def test_sixteen_pieces_a_chunk():
    """kw·C < 8 with kh > 1 (a 3×3 window of 2 channels): a chunk meets up
    to four runs, the kernel's 16-piece instantiation."""
    x = _codes((1, 6, 5, 2), 3)
    pads = ((1, 1), (1, 1))
    got = emulate(x, 3, 1, pads, 9)
    assert np.array_equal(got, _plain(x, 3, 1, pads, 9))


@pytest.mark.parametrize("n", [8, 256])
def test_plan_at_the_stem(n):
    """ResNet-50's stem, (N, 224, 224, 3) 7×7/s2 pads (2, 3): full-width
    bands of 4 output rows (13 input rows) at batch 256, within shared
    memory, every output once."""
    p = I.plan(n, 224, 224, 3, 7, 2, ((2, 3), (2, 3)))
    assert (p.ho, p.wo, p.kp, p.tw, p.per_row, p.step) == (112, 112, 160,
                                                           112, 10, 25)
    assert p.smem <= I.MAX_SMEM <= SMEM_LIMIT and p.pitch >= 229 * 3 + 15
    assert p.th == 4 if n == 256 else p.th >= 1
    covered = np.zeros((p.ho, p.wo), np.int64)
    for ty in range(p.tiles_y):
        for tx in range(p.tiles_x):
            covered[ty * p.th:(ty + 1) * p.th, tx * p.tw:(tx + 1) * p.tw] += 1
    assert (covered == 1).all() and p.tiles == n * p.tiles_y * p.tiles_x


def test_plan_takes_column_tiles_where_a_row_is_wide():
    """A band of 4000 columns of 64 channels is beyond shared memory: column
    tiles, each within it, covering every output once."""
    p = I.plan(1, 64, 4000, 64, 5, 1, ((2, 2), (2, 2)))
    assert p.tw < p.wo and p.smem <= I.MAX_SMEM
    assert p.tiles_x * p.tw >= p.wo > (p.tiles_x - 1) * p.tw


# ---------------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, (1, 1), (2, 3), (3, 2), (4, 5)])
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:6])) for c in CASES])
def test_card_kernel_on_the_emulated_tiles(case, tile):
    """The kernel at the plans the emulation runs, with x at every address
    mod 16 (so every lead of the band rows), against the plain version,
    tolerance 0."""
    dev = _card()
    n, h, w, c, k, s, pads = case
    x = torch.from_numpy(_codes((n, h, w, c), n * h + 5 * c))
    p = I.plan(n, h, w, c, k, s, pads) if tile is None else \
        I.make_plan(n, h, w, c, k, s, pads, *tile)
    want = torch.from_numpy(_plain(x.numpy(), k, s, pads, -3))
    buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=dev)
    for base in range(16):
        xd = buf[base:base + x.numel()].view(x.shape)
        xd.copy_(x)
        got = I.launch(xd, k, s, pads, -3, p)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), base

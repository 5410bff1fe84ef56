"""A tile-faithful CPU emulation of the int8 window-sum kernel
(``ops/cuda/csrc/int8_window_sum.cu``), held equal to its plain version.

The emulation does the kernel's work block by block on :func:`.plan`'s
tiles (and on small forced tiles, so that halos and ragged edges show at
toy sizes): the tile's region in compact coordinates (only the touched
rows and columns where k < s), the pixel sums with the kernel's split of
a pixel's 16-byte chunks over ``lanes`` lanes, a pixel a group a pass,
the shuffle tree over the lanes, 0 for a cell outside the map, the
flat view of a 1×1 window at stride 1, then the separable box sum at the
stride from the shared region (sums over dx, then over dy) and the
coalesced writes.  The region starts as junk, so a cell read but never
written shows; every output must be written exactly once.  Tolerance 0,
at ragged H and W, k ∈ {1, 3, 5, 7}, strides 1 and 2, asymmetric pads,
C ∈ {3, 5, 16, 24, 40, 64} and zero codes −128, −3 and 0.  The plans
themselves: taken, within shared memory and covering every output once
at every window-sum shape of config #5's ResNet-50 (batch 128) and the
ResNet-50 stem and head.  In G = 2 and 4 groups (a grouped conv's sums,
one a group): a lane group a (pixel, group), group fastest, its lanes
over that group's chunks, G sums a pixel in the region and the box sums
per group, at every case whose C the groups divide, on the plan's tiles
and on forced small ones; and the plan at RepVGG-B2g4's grouped shapes.
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import int8_window_sum as WS

JUNK = -777777           # what a shared cell holds before it is written
SMEM_LIMIT = 232448      # an H100 block's shared memory (227 KB)


def region(i, k, s):
    """The kernel's compact → region coordinate."""
    return (i // k) * s + i % k if k < s else i


def lane_sums(pixel: np.ndarray, lanes: int) -> int:
    """A pixel's codes summed as the kernel does: lane j takes 16-byte
    chunks j, j + lanes, ...; then the shuffle tree (xor offsets lanes/2,
    ..., 1) leaves the total in lane 0."""
    chunks = -(-pixel.size // 16)
    vals = np.zeros(lanes, np.int64)
    for ch in range(chunks):
        vals[ch % lanes] += int(pixel[16 * ch:16 * ch + 16].astype(
            np.int64).sum())
    off = lanes // 2
    while off:
        vals = vals + vals[np.arange(lanes) ^ off]
        off //= 2
    return int(vals[0])


def emulate(x: np.ndarray, zero: int, kernel: int, stride: int, pads,
            p=None, groups: int = 1) -> np.ndarray:
    """The kernel's result on ``x`` (N, H, W, C) int8 with plan ``p`` (in
    ``groups`` > 1 groups: :func:`emulate_grouped`)."""
    if groups > 1:
        return emulate_grouped(x, zero, kernel, stride, pads, p, groups)
    n0, h0, w0, c = x.shape
    pads = tuple(map(tuple, pads))
    p = p or WS.plan(n0, h0, w0, c, kernel, stride, pads)
    xs = x.reshape(p.n, p.h, p.w, c)
    (top, _), (left, _) = pads
    if WS.flat(kernel, stride, pads):
        top = left = 0
    out = np.zeros(p.n * p.ho * p.wo, np.int64)
    written = np.zeros(p.n * p.ho * p.wo, np.int64)
    groups = WS.THREADS // p.lanes
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32
    for block in range(p.tiles):
        tx = block % p.tiles_x
        ty = block // p.tiles_x % p.tiles_y
        n = block // (p.tiles_x * p.tiles_y)
        p0, q0 = ty * p.th, tx * p.tw
        th, tw = min(p.th, p.ho - p0), min(p.tw, p.wo - q0)
        rh, rw = (th - 1) * p.se + kernel, (tw - 1) * p.se + kernel
        iy0, ix0 = p0 * stride - top, q0 * stride - left
        npix = rh * rw
        smem_cells = npix + (rh * tw if kernel > 1 else 0)
        assert 4 * smem_cells <= p.smem <= WS.MAX_SMEM
        pix = np.full(npix, JUNK, np.int64)
        for base in range(0, npix, groups):
            for group in range(groups):
                i = base + group
                if i >= npix:
                    continue
                iy = iy0 + region(i // rw, kernel, stride)
                ix = ix0 + region(i % rw, kernel, stride)
                if 0 <= iy < p.h and 0 <= ix < p.w:
                    pix[i] = lane_sums(xs[n, iy, ix], p.lanes) - c * zero
                else:
                    pix[i] = 0
        rows_out = (n * p.ho + p0 + np.arange(th))[:, None] * p.wo \
            + q0 + np.arange(tw)[None, :]
        if kernel == 1:
            got = pix.reshape(rh, rw)[:th, :tw]
        else:
            grid = pix.reshape(rh, rw)
            rows = np.stack([grid[:, q * p.se:q * p.se + kernel].sum(1)
                             for q in range(tw)], 1)          # (rh, tw)
            got = np.stack([rows[r * p.se:r * p.se + kernel].sum(0)
                            for r in range(th)], 0)           # (th, tw)
        assert not (got <= JUNK // 2).any(), "a cell read before written"
        out[rows_out.reshape(-1)] = got.reshape(-1)
        written[rows_out.reshape(-1)] += 1
    assert (written == 1).all(), "an output not written exactly once"
    ho, wo = WS.out_hw(h0, w0, kernel, stride, pads)
    return out.reshape(n0, ho, wo)


def emulate_grouped(x, zero, kernel, stride, pads, p, groups):
    """The grouped kernel (``grouped_sums``): items (pixel, group), group
    fastest, a lane group an item; G sums a pixel in the region; the box
    sums and the writes per group, (N, Ho, Wo, G)."""
    n0, h0, w0, c = x.shape
    cg = c // groups
    pads = tuple(map(tuple, pads))
    p = p or WS.plan(n0, h0, w0, c, kernel, stride, pads, groups)
    assert p.groups == groups
    xs = x.reshape(p.n, p.h, p.w, c)
    (top, _), (left, _) = pads
    if WS.flat(kernel, stride, pads):
        top = left = 0
    out = np.zeros((p.n * p.ho * p.wo, groups), np.int64)
    written = np.zeros(out.shape, np.int64)
    lane_groups = WS.THREADS // p.lanes
    for block in range(p.tiles):
        tx = block % p.tiles_x
        ty = block // p.tiles_x % p.tiles_y
        n = block // (p.tiles_x * p.tiles_y)
        p0, q0 = ty * p.th, tx * p.tw
        th, tw = min(p.th, p.ho - p0), min(p.tw, p.wo - q0)
        rh, rw = (th - 1) * p.se + kernel, (tw - 1) * p.se + kernel
        iy0, ix0 = p0 * stride - top, q0 * stride - left
        items = rh * rw * groups
        smem_cells = groups * (rh * rw + (rh * tw if kernel > 1 else 0))
        assert 4 * smem_cells <= p.smem <= WS.MAX_SMEM
        pix = np.full(items, JUNK, np.int64)
        for base in range(0, items, lane_groups):
            for group in range(lane_groups):
                i = base + group
                if i >= items:
                    continue
                pixel, gg = divmod(i, groups)
                iy = iy0 + region(pixel // rw, kernel, stride)
                ix = ix0 + region(pixel % rw, kernel, stride)
                if 0 <= iy < p.h and 0 <= ix < p.w:
                    pix[i] = lane_sums(xs[n, iy, ix, gg * cg:(gg + 1) * cg],
                                       p.lanes) - cg * zero
                else:
                    pix[i] = 0
        grid = pix.reshape(rh, rw, groups)
        if kernel == 1:
            got = grid[:th, :tw]
        else:
            rows = np.stack([grid[:, q * p.se:q * p.se + kernel].sum(1)
                             for q in range(tw)], 1)    # (rh, tw, G)
            got = np.stack([rows[r * p.se:r * p.se + kernel].sum(0)
                            for r in range(th)], 0)     # (th, tw, G)
        assert not (got <= JUNK // 2).any(), "a cell read before written"
        rows_out = (n * p.ho + p0 + np.arange(th))[:, None] * p.wo \
            + q0 + np.arange(tw)[None, :]
        out[rows_out.reshape(-1)] = got.reshape(-1, groups)
        written[rows_out.reshape(-1)] += 1
    assert (written == 1).all(), "an output not written exactly once"
    ho, wo = WS.out_hw(h0, w0, kernel, stride, pads)
    return out.reshape(n0, ho, wo, groups)


# (n, h, w, c, kernel, stride, pads): ragged maps, asymmetric pads
CASES = [
    (2, 9, 11, 16, 3, 1, ((1, 1), (1, 1))),
    (1, 13, 10, 24, 3, 2, ((0, 1), (1, 0))),
    (2, 7, 6, 64, 1, 1, ((0, 0), (0, 0))),
    (3, 9, 7, 40, 1, 2, ((0, 0), (0, 0))),
    (1, 10, 9, 5, 5, 1, ((2, 1), (0, 3))),
    (1, 17, 15, 3, 7, 2, ((2, 3), (3, 2))),
    (2, 11, 12, 5, 5, 2, ((1, 2), (2, 2))),
    (1, 8, 8, 3, 1, 2, ((1, 0), (0, 1))),
    (2, 12, 5, 64, 7, 1, ((3, 3), (3, 3))),
    (4, 1, 1, 40, 1, 1, ((0, 0), (0, 0))),
]


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape,
                                                dtype=np.int8)


@pytest.mark.parametrize("zero", [-128, -3, 0])
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:6])) for c in CASES])
def test_emulation_on_the_plan_equals_plain(case, zero):
    n, h, w, c, k, s, pads = case
    x = _codes((n, h, w, c), n * h * w + c + k)
    want = WS.int8_window_sum_plain(torch.from_numpy(x), zero=zero,
                                    kernel=k, stride=s, pads=pads)
    got = emulate(x, zero, k, s, pads)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("tile", [(1, 1), (2, 3), (3, 2), (4, 5)])
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:6])) for c in CASES])
def test_emulation_on_small_tiles_equals_plain(case, tile):
    """Forced small tiles: halo rows and columns shared between tiles, a
    last tile that ends on the map's last row or column, ragged tiles."""
    n, h, w, c, k, s, pads = case
    x = _codes((n, h, w, c), h + w + 7 * c)
    p = WS.make_plan(n, h, w, c, k, s, pads, *tile)
    want = WS.int8_window_sum_plain(torch.from_numpy(x), zero=-3, kernel=k,
                                    stride=s, pads=pads)
    assert np.array_equal(emulate(x, -3, k, s, pads, p), want.numpy())


def test_lane_split_covers_wide_pixels():
    """C = 2048 (128 chunks): 16 lanes of 8 chunks, the shuffle tree; and
    other splits of its chunks over lanes."""
    x = _codes((1, 2, 3, 2048), 5)
    pads = ((0, 0), (0, 0))
    p = WS.plan(1, 2, 3, 2048, 1, 1, pads)
    assert p.lanes == 16
    want = WS.int8_window_sum_plain(torch.from_numpy(x), zero=-128).numpy()
    assert np.array_equal(emulate(x, -128, 1, 1, pads), want)
    for lanes in (1, 4, 32):
        q = WS.make_plan(1, 2, 3, 2048, 1, 1, pads, 1, 4, lanes)
        assert np.array_equal(emulate(x, -128, 1, 1, pads, q), want)


# every window-sum launch shape of BASELINE config #5 (RootQ W4A4
# ResNet-50, 224², batch 128), the stem's at batch 256 and the head
R50 = [((128, 56, 56, 64), 3, 1, ((1, 1), (1, 1))),
       ((128, 28, 28, 128), 3, 1, ((1, 1), (1, 1))),
       ((128, 14, 14, 256), 3, 1, ((1, 1), (1, 1))),
       ((128, 7, 7, 512), 3, 1, ((1, 1), (1, 1))),
       ((128, 56, 56, 128), 3, 2, ((0, 1), (0, 1))),
       ((128, 28, 28, 256), 3, 2, ((0, 1), (0, 1))),
       ((128, 14, 14, 512), 3, 2, ((0, 1), (0, 1))),
       ((128, 56, 56, 256), 1, 2, ((0, 0), (0, 0))),
       ((128, 28, 28, 512), 1, 2, ((0, 0), (0, 0))),
       ((128, 14, 14, 1024), 1, 2, ((0, 0), (0, 0))),
       ((256, 224, 224, 3), 7, 2, ((2, 3), (2, 3))),
       ((128, 1, 1, 2048), 1, 1, ((0, 0), (0, 0)))] + [
    ((128, hw, hw, c), 1, 1, ((0, 0), (0, 0)))
    for hw, cs in ((56, (64, 256)), (28, (128, 256, 512)),
                   (14, (256, 512, 1024)), (7, (512, 1024, 2048)))
    for c in cs]


@pytest.mark.parametrize("shape,k,s,pads", R50,
                         ids=[f"{'x'.join(map(str, a[0]))}k{a[1]}s{a[2]}"
                              for a in R50])
def test_plan_at_resnet50_shapes(shape, k, s, pads):
    n, h, w, c = shape
    p = WS.plan(n, h, w, c, k, s, pads)
    assert p.smem <= WS.MAX_SMEM <= SMEM_LIMIT and p.rh * p.rw <= WS.MAX_REGION
    assert p.tiles < 2 ** 31 - 1 and 1 <= p.lanes <= 32
    # the tiles cover the outputs exactly once: a grid of th x tw tiles,
    # each cut at the map's edge
    covered = np.zeros((p.n, p.ho, p.wo), np.int8)
    for ty in range(p.tiles_y):
        for tx in range(p.tiles_x):
            covered[:, ty * p.th:(ty + 1) * p.th,
                    tx * p.tw:(tx + 1) * p.tw] += 1
    assert (covered == 1).all()
    ho, wo = WS.out_hw(h, w, k, s, pads)
    assert p.n * p.ho * p.wo == n * ho * wo
    # the region a tile reads: each touched pixel once, halo rows aside
    if WS.flat(k, s, pads):
        assert (p.n, p.h, p.ho) == (1, 1, 1) and p.w == n * h * w
    if n == 128 and h > 1:
        assert p.tiles >= WS.MIN_TILES or p.th == 1


def test_plan_refuses_a_window_beyond_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        WS.plan(1, 100, 100, 8, 70, 1, ((0, 0), (0, 0)))


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
    """The kernel at the plans the emulation runs (the wrapper's, and the
    forced small tiles), against the plain version, tolerance 0."""
    dev = _card()
    n, h, w, c, k, s, pads = case
    x = torch.from_numpy(_codes((n, h, w, c), h * w + 3 * c))
    p = WS.plan(n, h, w, c, k, s, pads) if tile is None else \
        WS.make_plan(n, h, w, c, k, s, pads, *tile)
    for zero in (-128, -3, 0):
        want = WS.int8_window_sum_plain(x, zero=zero, kernel=k, stride=s,
                                        pads=pads)
        got = WS.launch(x.to(dev), zero, k, s, pads, p)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), zero


GROUPED = [(case, g) for case in CASES for g in (2, 4) if case[3] % g == 0]


@pytest.mark.parametrize("tile", [None, (2, 3)])
@pytest.mark.parametrize("case,groups", GROUPED,
                         ids=[f"{'x'.join(map(str, c[:6]))}g{g}"
                              for c, g in GROUPED])
def test_emulation_grouped_equals_plain(case, groups, tile):
    """G sums a pixel, on the plan's tiles and on forced small ones."""
    n, h, w, c, k, s, pads = case
    x = _codes((n, h, w, c), h * w + c + groups)
    p = tile and WS.make_plan(n, h, w, c, k, s, pads, *tile,
                              groups=groups)
    want = WS.int8_window_sum_plain(torch.from_numpy(x), zero=-3, kernel=k,
                                    stride=s, pads=pads, groups=groups)
    assert want.shape == (n,) + WS.out_hw(h, w, k, s, pads) + (groups,)
    got = emulate(x, -3, k, s, pads, p, groups)
    assert np.array_equal(got, want.numpy())


# RepVGG-B2g4's grouped convs at batch 64 (3×3 pad 1, the train form's 1×1)
B2G4 = [((64, hw, hw, c), k, 1, ((k // 2,) * 2,) * 2)
        for hw, c in ((56, 160), (28, 320), (14, 640)) for k in (3, 1)]


@pytest.mark.parametrize("shape,k,s,pads", B2G4,
                         ids=[f"{'x'.join(map(str, a[0]))}k{a[1]}"
                              for a in B2G4])
def test_plan_at_b2g4_grouped_shapes(shape, k, s, pads):
    n, h, w, c = shape
    p = WS.plan(n, h, w, c, k, s, pads, 4)
    assert p.groups == 4 and p.smem <= WS.MAX_SMEM
    assert p.rh * p.rw * 4 <= WS.MAX_REGION and p.tiles < 2 ** 31 - 1
    assert p.tiles_y * p.th >= p.ho and p.tiles_x * p.tw >= p.wo
    assert p == WS.make_plan(n, h, w, c, k, s, pads, p.th, p.tw,
                             groups=4)

"""The ImageNet stem's int8 7×7/s2 conv + 3×3/s2 max pool in one kernel
(``ops/cuda/int8_stem_pool.py``) against the JAX package.

* The plain version equals JAX's integer path at the stem exactly: the
  codes padded with a nonzero pad code (``jnp.pad``), the int32
  ``conv_general_dilated``, then ``flax.linen.pooling.pool`` with
  ``iinfo(int32).min`` (what ``chain.qmaxpool`` runs), at 224², 64², 65²
  and a ragged 37×50, the pads flax's SAME.
* A tile-faithful emulation of the kernel equals the plain version over
  band sizes, ragged maps, 1 to 4 input channels, two column bands and two
  channel tiles: its walk over units (image, pooled rows, pooled columns,
  channels), the cells built from x with the pad code, the wgmma's B read
  straight from the cells as the unswizzled descriptor addresses it, the
  accumulator's lane map, the shuffle that pools columns, the borders
  (only where a window reaches past the map), the running max over conv
  rows with the first row recomputed, and the staged 16-byte stores (each
  output written once).
* The weight packing round-trips; the wrapper raises on what the kernel
  does not take; ``qmaxpool`` runs the chain's pending stem through it.
* ``cuda``-marked tests hold the kernel against its plain version on the
  card (tolerance 0) at ragged shapes, every band size, and ResNet-50's
  stem at batch 8 and 256, and skip here:
  ``python -m pytest --noconftest tests/test_torch_stem_pool.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
from dlmc_quant_torch.ops.cuda.int8_im2col import pack_weight as pack_rows
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingWideConv,
                                          qmaxpool)
from dlmc_quant_torch.quant.layers import QConv

torch.set_num_threads(1)

INT_MIN = np.iinfo(np.int32).min


def _same_pads(h, w):
    """flax's SAME pads of the 7×7/s2 window, as the stem computes them."""
    return QConv(3, 64, 7, 2, "SAME").spatial_pads(h, w)


def _operands(seed, n, h, w, c=3, o=64):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wk = rng.integers(-128, 128, (7, 7, c, o), dtype=np.int8)
    return x, wk


def _jax_stem_pool(x, wk, pads, pad):
    import jax
    import jax.numpy as jnp
    from flax.linen import pooling
    xp = jnp.pad(jnp.asarray(x), ((0, 0),) + tuple(pads) + ((0, 0),),
                 constant_values=jnp.int8(pad))
    acc = jax.lax.conv_general_dilated(
        xp, jnp.asarray(wk), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return np.asarray(pooling.pool(acc, jnp.iinfo(jnp.int32).min,
                                   jax.lax.max, (3, 3), (2, 2),
                                   ((1, 1), (1, 1))))


@pytest.mark.parametrize("n,h,w", [(1, 224, 224), (2, 64, 64), (2, 65, 65),
                                   (2, 37, 50)])
def test_plain_equals_jax(n, h, w):
    x, wk = _operands(h * w, n, h, w)
    pads, pad = _same_pads(h, w), -37
    want = _jax_stem_pool(x, wk, pads, pad)
    got = S.int8_stem_pool(torch.from_numpy(x),
                           S.pack_weight(torch.from_numpy(wk)), pads=pads,
                           pad=pad)
    assert got.dtype == torch.int32
    assert got.shape == want.shape == (n,) + S.geometry(h, w, pads)[2:] + (64,)
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------ emulation
# The lane map of a warpgroup's m64nN accumulator (wgmma_s8.cuh): register
# k = 4 i + 2 h + e of thread t holds row (channel) 16 (t // 32) +
# (t % 32) // 4 + 8 h and column (pixel) 8 i + 2 (t % 4) + e.
PIX, CELLS = 128, 131         # conv columns and cells of a unit
ACC, HP = PIX // 2, PIX // 4  # a thread's accumulator and pooled values
_T = np.arange(128)[:, None]
_K = np.arange(ACC)[None, :]
_I, _H, _E = _K // 4, (_K // 2) % 2, _K % 2
ROW = 16 * (_T // 32) + (_T % 32) // 4 + 8 * _H
COL = 8 * _I + 2 * (_T % 4) + _E
_LANE = np.arange(128) % 32
QUAD = _LANE % 4
# the lane that sends each lane the pixel after its pair
FROM = (np.arange(128) // 32) * 32 + ((_LANE & ~3) | ((_LANE + 1) & 3))


def _cells(x, n, r0, c0, rows, pads, pad):
    """The unit's cells: (2 rows + 4, 131, 16) bytes, cell (R, Q) byte
    (2 py + px) C + ch = xpad[2 (r0 + R) + py][2 (c0 + Q) + px][ch]."""
    _, h, w, c = x.shape
    (top, _), (left, _) = pads
    sr = np.arange(2 * rows + 4)[:, None, None, None, None]
    sc = np.arange(CELLS)[None, :, None, None, None]
    py = np.arange(2)[None, None, :, None, None]
    px = np.arange(2)[None, None, None, :, None]
    ch = np.arange(c)[None, None, None, None, :]
    y = 2 * (r0 + sr) - top + py
    xx = 2 * (c0 + sc) - left + px
    inside = (y >= 0) & (y < h) & (xx >= 0) & (xx < w)
    vals = np.where(inside, x[n, np.clip(y, 0, h - 1), np.clip(xx, 0, w - 1),
                              ch], pad)
    cells = np.zeros((2 * rows + 4, CELLS, S.CELL), np.int64)
    cells[..., :4 * c] = vals.reshape(2 * rows + 4, CELLS, 4 * c)
    return cells


def emulate(x, wp, pads, pad, band):
    """The kernel's walk, unit by unit, thread by thread (see the .cu)."""
    n, h, w, c = x.shape
    o = wp.shape[1]
    hc, wc, hp, wpool = S.geometry(h, w, pads)
    o_tiles = -(-o // S.OT)
    # the resident weight: tile, chunk, row (channel), byte; rows past O 0
    wt = np.zeros((o_tiles * S.OT, S.TAPS ** 2, S.CELL), np.int64)
    wt[:o] = wp.numpy().transpose(1, 0, 2)
    wt = wt.reshape(o_tiles, S.OT, S.TAPS ** 2, S.CELL)
    bands, col_bands = -(-hp // band), -(-wpool // S.POOL_COLS)
    out = np.zeros((n, hp, wpool, o), np.int64)
    writes = np.zeros(out.shape, np.int64)
    for u in range(n * bands * col_bands * o_tiles):
        rest = u
        ct = rest % o_tiles
        rest //= o_tiles
        cb = rest % col_bands
        rest //= col_bands
        i0, nn = (rest % bands) * band, rest // bands
        j0 = cb * S.POOL_COLS
        rows, cols = min(band, hp - i0), min(S.POOL_COLS, wpool - j0)
        r0, c0 = 2 * i0 - 1, 2 * j0 - 1
        cells = _cells(x, nn, r0, c0, rows, pads, pad)
        run = None
        for rr in range(2 * rows + 1):
            hpv = np.full((128, HP), INT_MIN, np.int64)
            if 0 <= r0 + rr < hc:
                # D (64 x 128) over 8 K slices; B row p, chunk (a, b) is
                # cell (rr + a, p + b): what the descriptor reads
                acc = np.zeros((S.OT, PIX), np.int64)
                for a in range(S.TAPS):
                    for b in range(S.TAPS):
                        acc += wt[ct, :, a * S.TAPS + b] @ \
                            cells[rr + a, b:b + PIX].T
                reg = acc[ROW, COL]
                # borders: the first pixel of pooled column 4 i + q lies
                # left of the map only at the image's column 0, the third
                # right of it where 8 i >= Wc - c0 - 2 - 2 q
                left_in = j0 + QUAD > 0
                right_room = wc - c0 - 2 - 2 * QUAD
                for i in range(PIX // 8):
                    for hh in range(2):
                        k0 = 4 * i + 2 * hh
                        v0, v1 = reg[:, k0], reg[:, k0 + 1]
                        later = reg[:, k0 + 4] if i + 1 < PIX // 8 else \
                            np.full(128, INT_MIN)
                        send = np.where(QUAD != 0, v0, later)
                        first = v0 if i else np.where(left_in, v0, v1)
                        third = np.where(8 * i < right_room, send[FROM], v1)
                        hpv[:, 2 * i + hh] = np.maximum.reduce(
                            [v1, first, third])
            if rr == 0:
                run = hpv
            elif rr % 2:
                run = np.maximum(run, hpv)
            else:
                stg = np.zeros((S.POOL_COLS + 1, S.OT), np.int64)
                for k in range(HP):
                    reg_k = 2 * k       # k = 2 i + h: register 4 i + 2 h
                    stg[COL[:, reg_k] // 2, ROW[:, reg_k]] = np.maximum(
                        run[:, k], hpv[:, k])
                run = hpv
                ip, o_here = i0 + rr // 2 - 1, min(S.OT, o - ct * S.OT)
                dst = (nn, ip, slice(j0, j0 + cols),
                       slice(ct * S.OT, ct * S.OT + o_here))
                out[dst] = stg[:cols, :o_here]
                writes[dst] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("n,h,w,c,o,band", [
    (1, 37, 50, 3, 64, 1), (1, 37, 50, 3, 64, 2), (1, 37, 50, 3, 64, 3),
    (2, 65, 65, 3, 16, 4), (1, 31, 29, 1, 32, 8), (1, 20, 23, 2, 48, 5),
    (1, 9, 260, 4, 128, 2), (1, 224, 224, 3, 64, 4)])
def test_emulation_equals_plain(n, h, w, c, o, band):
    x, wk = _operands(n + h + w + c, n, h, w, c, o)
    pads = _same_pads(h, w) if c != 1 else ((3, 3), (3, 1))
    wp = S.pack_weight(torch.from_numpy(wk))
    want = S.int8_stem_pool_plain(torch.from_numpy(x), wp, pads=pads, pad=23)
    assert np.array_equal(emulate(x, wp, pads, 23, band), want.numpy())


def test_band_rows():
    # ResNet-50's stem: at batch 256 bands of 7 pooled rows (56 = 8 x 7,
    # 15 conv rows for 14); batch 8 needs bands of 2 to fill the card
    assert S.band_rows(256, 56, 56, 64) == 7
    assert S.band_rows(8, 56, 56, 64) == 2
    assert S.band_rows(1, 56, 56, 64) == 1
    assert S.units(256, 56, 56, 64, 7) == 256 * 8


@pytest.mark.parametrize("c,o", [(3, 64), (1, 16), (4, 128)])
def test_pack_weight_round_trip(c, o):
    _, wk = _operands(c * o, 1, 1, 1, c, o)
    wp = S.pack_weight(torch.from_numpy(wk))
    assert wp.shape == (16, o, 16)
    assert torch.equal(S.unpack_weight(wp, c), torch.from_numpy(wk))
    assert not bool(wp[:, :, 4 * c:].any())
    # the cell taps past the 7×7 window are zero: cell row 3's py = 1 and
    # cell column 3's px = 1
    taps = wp[:, :, :4 * c].reshape(4, 4, o, 2, 2, c)
    assert not bool(taps[3, :, :, 1].any()) and not bool(taps[:, 3, :, :, 1]
                                                         .any())


@pytest.mark.parametrize("bad", ["c5", "o24", "o144", "pad", "strided",
                                 "small", "pads"])
def test_raises(bad):
    x = torch.zeros((1, 16, 16, 3), dtype=torch.int8)
    wp = S.pack_weight(torch.zeros((7, 7, 3, 64), dtype=torch.int8))
    kw = dict(pads=((2, 3), (2, 3)), pad=0)
    if bad == "c5":
        x = torch.zeros((1, 16, 16, 5), dtype=torch.int8)
    elif bad == "o24":
        wp = torch.zeros((16, 24, 16), dtype=torch.int8)
    elif bad == "o144":
        wp = torch.zeros((16, 144, 16), dtype=torch.int8)
    elif bad == "pad":
        kw["pad"] = 200
    elif bad == "strided":
        x = torch.zeros((1, 16, 32, 3), dtype=torch.int8)[:, :, ::2]
    elif bad == "small":
        x = torch.zeros((1, 3, 3, 3), dtype=torch.int8)
        kw["pads"] = ((0, 0), (0, 0))
    else:
        kw["pads"] = ((-1, 3), (2, 3))
    with pytest.raises(ValueError):
        S.int8_stem_pool(x, wp, **kw)


def test_qmaxpool_runs_the_pending_stem():
    """The chain's pending stem, ReLU-flagged and pooled: the kernel's
    accumulator, and the same conv as im2col rows through the GEMM
    (materialize's route) before a pool; other pools are refused."""
    x, wk = _operands(7, 2, 28, 30)
    pads, pad = _same_pads(28, 30), 5
    wt = torch.from_numpy(wk)
    pending = PendingWideConv(torch.from_numpy(x), pack_rows(wt),
                              S.pack_weight(wt), 7, 2, pads, pad)
    ones = torch.ones(64)
    de = DeferredEpilogue(pending, ones, torch.zeros(64), relu=True)
    pooled = qmaxpool(de, (3, 3), (2, 2), ((1, 1), (1, 1)))
    assert pooled.relu and pooled.acc.dtype == torch.int32
    assert np.array_equal(pooled.acc.numpy(),
                          _jax_stem_pool(x, wk, pads, pad))
    acc = pending.run(mode="int32")
    assert acc.shape == (2, 14, 15, 64)
    want = torch.nn.functional.max_pool2d(
        acc.permute(0, 3, 1, 2).double(), 3, 2, 1).permute(0, 2, 3, 1)
    assert torch.equal(pooled.acc, want.to(torch.int32))
    with pytest.raises(NotImplementedError):
        qmaxpool(de, (2, 2), (2, 2), ((0, 0), (0, 0)))
    with pytest.raises(NotImplementedError):
        qmaxpool(DeferredEpilogue(
            PendingWideConv(pending.x, pending.weight, None, 7, 2, pads, pad),
            ones, torch.zeros(64)), (3, 3), (2, 2), ((1, 1), (1, 1)))


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (n, h, w, c, o, pads): ragged maps, every C, two column bands, two
# channel tiles, pads that are not SAME
CARD_CASES = [(2, 37, 50, 3, 64, None), (3, 65, 65, 3, 64, None),
              (1, 9, 260, 4, 128, None), (2, 31, 29, 1, 32, ((3, 3), (3, 1))),
              (1, 20, 23, 2, 48, None), (2, 64, 64, 3, 16, ((0, 6), (1, 2)))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=["x".join(map(str, c[:5])) for c in CARD_CASES])
@pytest.mark.parametrize("band", [None, 1, 2, 3, 8])
def test_kernel_matches_plain(case, band):
    dev = _card()
    n, h, w, c, o, pads = case
    pads = pads or _same_pads(h, w)
    x, wk = (torch.from_numpy(t).to(dev)
             for t in _operands(h * w + o, n, h, w, c, o))
    wp = S.pack_weight(wk)
    got = S.int8_stem_pool(x, wp, pads=pads, pad=-99, _band=band)
    torch.cuda.synchronize()
    assert torch.equal(got, S.int8_stem_pool_plain(x, wp, pads=pads,
                                                   pad=-99))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 256])
def test_kernel_matches_plain_resnet50_stem(n):
    dev = _card()
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-128, 128, (n, 224, 224, 3), generator=g,
                      dtype=torch.int8).to(dev)
    wk = torch.randint(-128, 128, (7, 7, 3, 64), generator=g,
                       dtype=torch.int8).to(dev)
    wp = S.pack_weight(wk)
    pads = ((2, 3), (2, 3))
    got = S.int8_stem_pool(x, wp, pads=pads, pad=7)
    torch.cuda.synchronize()
    assert got.shape == (n, 56, 56, 64)
    assert torch.equal(got, S.int8_stem_pool_plain(x, wp, pads=pads, pad=7))

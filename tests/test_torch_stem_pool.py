"""The ImageNet stem's int8 7×7/s2 conv + 3×3/s2 max pool + the consumer's
epilogue in one kernel (``ops/cuda/int8_stem_pool.py``) against the JAX
package.

* The plain version equals JAX's integer path at the stem exactly: the
  codes padded with a nonzero pad code (``jnp.pad``), the int32
  ``conv_general_dilated``, then ``flax.linen.pooling.pool`` with
  ``iinfo(int32).min`` (what ``chain.qmaxpool`` runs), at 224², 64², 65²
  and a ragged 37×50, the pads flax's SAME; in codes and f32 modes, run by
  the chain's pending stem for its consumer, followed by JAX's
  ``fold_quantize`` or ``materialize`` (a ReLU or ReLU6 boundary, W8 and
  W4 weights).
* A tile-faithful emulation of the kernel equals the plain version in each
  mode over band sizes, ragged maps, 1 to 4 input channels, two column
  bands and two channel tiles: its walk over units (image, pooled rows,
  pooled columns, channels), the band staged as whole aligned 16-byte
  pieces of x (or bytes) with the pad code outside the map, the cells put
  together from the band's 32-bit words, the wgmma's B read straight from
  the cells as the unswizzled descriptor addresses it, the accumulator's
  lane map and the order of the two accumulators' rows, the shuffle that
  pools columns, the borders (only where a window reaches past the map),
  the running max over conv rows with the first row recomputed, the
  epilogue, and each warp's staged 16-byte stores (each output written
  once).
* The weight packing round-trips; the wrapper raises on what the kernel
  does not take; ``qmaxpool`` leaves the chain's stem pending and each
  consumer's launch carries its own fold.
* ``cuda``-marked tests hold the kernel against its plain version on the
  card (tolerance 0) at ragged shapes, every band size, each mode, and
  ResNet-50's stem at batch 8 and 256 (W8 and W4), and skip here:
  ``python -m pytest --noconftest tests/test_torch_stem_pool.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import int8_stem_pool as S
from dlmc_quant_torch.ops.cuda.int8_im2col import pack_weight as pack_rows
from dlmc_quant_torch.ops.cuda.int8_im2col import \
    pack_weight_int4 as pack_rows_int4
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingStemPool,
                                          PendingWideConv, fold_params,
                                          fold_quantize, materialize,
                                          qmaxpool)
from dlmc_quant_torch.utils.launches import LaunchRecorder
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


def _folds(seed, o, relu6):
    """A consumer's fold as the chain builds it: per-channel scale > 0 and
    bias of the stem's epilogue, the consumer's inverse scale and shifted
    zero (Python floats holding float32 values) and code range; the
    boundary has a ReLU (the lower clamp at the zero code), or a ReLU6
    (the upper one too)."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(2e-4, 8e-4, o).astype(np.float32)
    bias = rng.normal(0.0, 20.0, o).astype(np.float32)
    inv, qbias = float(np.float32(1.7)), float(np.float32(-3.4))
    return scale, bias, inv, qbias, (-128, 127), 6.0 if relu6 else None


def _jax_pooled_epilogue(x, wk, pads, pad, fold, mode):
    """JAX's integer path at the stem: the pooled accumulator, then the
    consumer's ``fold_quantize`` (codes) or ``materialize`` (f32)."""
    import jax.numpy as jnp
    from dlmc_quant_tpu.quant import chain as jchain
    scale, bias, inv, qbias, (qmin, qmax), clamp_hi = fold
    de = jchain.DeferredEpilogue(
        jnp.asarray(_jax_stem_pool(x, wk, pads, pad)), jnp.asarray(scale),
        jnp.asarray(bias), relu=True, clamp_hi=clamp_hi)
    if mode == "codes":
        return np.asarray(jchain.fold_quantize(de, inv, qbias, qmin, qmax))
    return np.asarray(jchain.materialize(de))


def _pending_stem(x, wk, pads, pad, fold=None, w4=False):
    """The port's pending stem on the chain, ReLU-flagged (and ReLU6 where
    the fold says so), pooled; its weights nibble-packed with ``w4``."""
    wt = torch.from_numpy(wk)
    w_gemm = (pack_rows_int4 if w4 else pack_rows)(wt)
    w_stem = (S.pack_weight_int4 if w4 else S.pack_weight)(wt)
    pending = PendingWideConv(torch.from_numpy(x), w_gemm, w_stem, 7, 2,
                              pads, pad)
    o = wk.shape[-1]
    scale, bias = (torch.ones(o), torch.zeros(o)) if fold is None else \
        (torch.from_numpy(fold[0]), torch.from_numpy(fold[1]))
    de = DeferredEpilogue(pending, scale, bias, relu=True,
                          clamp_hi=None if fold is None else fold[5])
    return qmaxpool(de, (3, 3), (2, 2), ((1, 1), (1, 1)))


@pytest.mark.parametrize("relu6", [False, True], ids=["relu", "relu6"])
@pytest.mark.parametrize("w4", [False, True], ids=["w8", "w4"])
@pytest.mark.parametrize("mode", ["codes", "f32"])
@pytest.mark.parametrize("n,h,w", [(2, 64, 64), (2, 65, 65), (2, 37, 50)])
def test_plain_modes_equal_jax(n, h, w, mode, w4, relu6):
    """The pending stem's consumer on the chain (the plain version of a
    codes or f32 launch) against JAX's qmaxpool, then fold_quantize or
    materialize, bit for bit."""
    x, wk = _operands(h * w + 1, n, h, w)
    if w4:
        wk = np.clip(wk >> 4, -8, 7).astype(np.int8)
    pads, pad = _same_pads(h, w), -37
    fold = _folds(h + w, 64, relu6)
    want = _jax_pooled_epilogue(x, wk, pads, pad, fold, mode)
    pooled = _pending_stem(x, wk, pads, pad, fold, w4)
    assert pooled.acc.int4 == w4
    got = fold_quantize(pooled, fold[2], fold[3], *fold[4]) \
        if mode == "codes" else materialize(pooled)
    assert got.dtype == (torch.int8 if mode == "codes" else torch.float32)
    assert got.shape == want.shape == (n,) + S.geometry(h, w, pads)[2:] + \
        (64,)
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------ emulation
# The lane map of a warpgroup's m64nN accumulator (wgmma_s8.cuh): register
# k = 4 i + 2 h + e of thread t holds row (channel) 16 (t // 32) +
# (t % 32) // 4 + 8 h and column (pixel) 8 i + 2 (t % 4) + e.
PIX, CELLS = 128, 131         # conv columns and cells of a unit
BAND_PIX = 2 * CELLS          # pixels of a staged band row
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


def _band_pitch(c):
    return (BAND_PIX * c + 32 + 15) // 16 * 16


def _stage_band(x, n, y0, x0, nr, pad, vec, rng):
    """The unit's staged band as the kernel leaves it in shared memory:
    (nr, pitch) bytes, band row k's byte j (pixel x0 + j / C of x's row
    y0 + k) at k pitch + lead + j; bytes the kernel never writes hold
    garbage.  Where x's rows are whole 16-byte pieces (``vec``, x aligned)
    a band row is written in 16-byte pieces: the aligned pieces of x's own
    row that hold the map's bytes (bytes beside the band included), the
    pad code in the others; else byte by byte."""
    _, h, w, c = x.shape
    span, pitch = BAND_PIX * c, _band_pitch(c)
    lead = (x0 * c) % 16 if vec else 0
    band = rng.integers(0, 256, (nr, pitch), dtype=np.uint8)
    cx_lo = min(max(0, -x0), BAND_PIX)
    cx_hi = max(cx_lo, min(BAND_PIX, w - x0))
    lo_b, hi_b = cx_lo * c, cx_hi * c
    r_lo = min(max(0, -y0), nr)
    r_hi = max(r_lo, min(nr, h - y0))
    flat = x.reshape(-1).view(np.uint8)
    if vec:
        p_lo = (lead + lo_b) // 16
        p_hi = (lead + hi_b + 15) // 16 if hi_b > lo_b else p_lo
        for k in range(nr):
            for p in range(-(-(lead + span) // 16)):
                if r_lo <= k < r_hi and p_lo <= p < p_hi:
                    # the piece of x's row y0 + k at pixel x0's byte
                    # 16 p - lead: aligned, inside that row
                    row = (n * h + y0 + k) * w * c
                    src = row + x0 * c + 16 * p - lead
                    assert src % 16 == 0 and row <= src
                    assert src + 16 <= row + w * c
                    band[k, 16 * p:16 * p + 16] = flat[src:src + 16]
                else:
                    band[k, 16 * p:16 * p + 16] = pad & 0xFF
    else:
        for k in range(nr):
            band[k, :span] = pad & 0xFF
            if r_lo <= k < r_hi:
                row = ((n * h + y0 + k) * w + x0) * c
                band[k, lo_b:hi_b] = flat[row + lo_b:row + hi_b]
    return band, lead


def _build_cells(band, lead, c, rows_c):
    """The cells from the staged band as build_cells puts them together,
    two at a time: from each of band rows 2R and 2R + 1 the 4 C bytes at
    4 C m, from C + 1 aligned 32-bit words by the funnel shift, split into
    the runs of cells (R, 2m) and (R, 2m + 1); a cell is the run of band
    row 2R, then that of 2R + 1, then zeros."""
    pitch = band.shape[1]
    words = np.zeros(band.size // 4 + 8, np.uint64)
    words[:band.size // 4] = band.reshape(-1).view("<u4")
    pairs = (CELLS + 1) // 2
    r = np.arange(rows_c)[:, None]
    m = np.arange(pairs)[None, :]
    bits = 16 * c
    u64 = np.uint64
    mask = u64((1 << bits) - 1) if bits < 64 else u64(0xFFFFFFFFFFFFFFFF)
    low32 = u64(0xFFFFFFFF)

    def runs(at):
        sh = (8 * (at & 3)).astype(np.uint64)
        w = [words[(at >> 2) + j] if j < c + 1 else np.zeros_like(at, u64)
             for j in range(5)]
        u = [((w[j] | (w[j + 1] << u64(32))) >> sh) & low32
             if j + 1 < c + 1 else np.zeros_like(at, u64) for j in range(4)]
        lo = u[0] | (u[1] << u64(32))
        hi = u[2] | (u[3] << u64(32))
        if bits == 64:
            return lo & mask, hi
        second = lo >> u64(bits)
        if bits > 32:
            second |= hi << u64(64 - bits)
        return lo & mask, second & mask

    at = 2 * r * pitch + lead + 4 * c * m
    (t0, t1), (b0, b1) = runs(at), runs(at + pitch)
    top = np.stack([t0, t1], -1).reshape(rows_c, 2 * pairs)[:, :CELLS]
    bot = np.stack([b0, b1], -1).reshape(rows_c, 2 * pairs)[:, :CELLS]
    if bits == 64:
        lo, hi = top, bot
    else:
        lo = top | (bot << u64(bits))
        hi = bot >> u64(64 - bits) if bits > 32 else np.zeros_like(bot)
    cells = np.stack([lo, hi], -1).astype("<u8").view(np.int8)
    return cells.reshape(rows_c, CELLS, S.CELL).astype(np.int64)


MAGIC, MAGIC_BITS = np.float32(12582912.0), 0x4B400000


def _epilogue(v, mode, a, b, lo, hi, relu):
    """One value per (thread, register) of a closed pooled row through the
    mode's epilogue as the kernel computes it: float32 ops rounded one by
    one; float(v) as the float of the bits MAGIC_BITS + v less MAGIC, the
    code as the low byte of the clamped value plus MAGIC (rounded half to
    even)."""
    if mode == "int32":
        return v
    assert np.abs(v).max() < 2 ** 22
    fv = (MAGIC_BITS + v).astype(np.int32).view(np.float32) - MAGIC
    y = (fv * a).astype(np.float32) + b
    if mode == "codes":
        c = np.minimum(np.maximum(y, np.float32(lo)), np.float32(hi))
        return ((c + MAGIC).view(np.int32) & 0xFF).astype(np.uint8) \
            .view(np.int8).astype(np.int64)
    return np.maximum(y, np.float32(0)) if relu else y


def emulate(x, wp, pads, pad, band, mode="int32", a=None, b=None, lo=-128,
            hi=127, relu=False, seed=0):
    """The kernel's walk, unit by unit, thread by thread (see the .cu)."""
    rng = np.random.default_rng(seed)
    n, h, w, c = x.shape
    o = wp.shape[1]
    vec = (w * c) % 16 == 0
    hc, wc, hp, wpool = S.geometry(h, w, pads)
    (top, _), (left, _) = pads
    o_tiles = -(-o // S.OT)
    # the resident weight: tile, chunk, row (channel), byte; rows past O 0
    wt = np.zeros((o_tiles * S.OT, S.TAPS ** 2, S.CELL), np.int64)
    wt[:o] = S.pack_weight(S.unpack_weight(wp, c)).numpy().transpose(1, 0, 2)
    wt = wt.reshape(o_tiles, S.OT, S.TAPS ** 2, S.CELL)
    a = np.zeros(o_tiles * S.OT, np.float32) if a is None else \
        np.concatenate([a, np.zeros(o_tiles * S.OT - o, np.float32)])
    b = np.zeros(o_tiles * S.OT, np.float32) if b is None else \
        np.concatenate([b, np.zeros(o_tiles * S.OT - o, np.float32)])
    bands, col_bands = -(-hp // band), -(-wpool // S.POOL_COLS)
    out = np.zeros((n, hp, wpool, o), np.float32 if mode == "f32"
                   else np.int64)
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
        staged, lead = _stage_band(x, nn, 2 * r0 - top, 2 * c0 - left,
                                   4 * rows + 8, pad, vec, rng)
        cells = _build_cells(staged, lead, c, 2 * rows + 4)
        ch = ct * S.OT + ROW[:, ::2]           # (thread, k = 2 i + h)
        a_t, b_t = a[ch], b[ch]
        left_in = j0 + QUAD > 0
        right_room = wc - c0 - 2 - 2 * QUAD
        # only where the unit holds the image's last pooled column and Wc
        # is odd does a stored column's third pixel lie right of the map
        right = wc % 2 == 1 and j0 + cols == wpool
        # the kernel's order: conv rows 0 and 1, then per pooled row k >= 1
        # conv row 2k (closing pooled row k - 1) and 2k + 1; the last, 2 rows
        order = [0, 1] + [rr for k in range(1, rows)
                          for rr in (2 * k, 2 * k + 1)] + [2 * rows]
        run = None
        for rr in order:
            # D (64 x 128) over 8 K slices; B row p, chunk (a, b) is cell
            # (rr + a, p + b): what the descriptor reads
            acc = np.zeros((S.OT, PIX), np.int64)
            for ta in range(S.TAPS):
                for tb in range(S.TAPS):
                    acc += wt[ct, :, ta * S.TAPS + tb] @ \
                        cells[rr + ta, tb:tb + PIX].T
            reg = acc[ROW, COL]
            hpv = np.full((128, HP), INT_MIN, np.int64)
            for i in range(PIX // 8):
                for hh in range(2):
                    k0 = 4 * i + 2 * hh
                    v0, v1 = reg[:, k0], reg[:, k0 + 1]
                    later = reg[:, k0 + 4] if i + 1 < PIX // 8 else \
                        np.full(128, INT_MIN)
                    send = np.where(QUAD != 0, v0, later)
                    first = v0 if i else np.where(left_in, v0, v1)
                    third = np.where(8 * i < right_room, send[FROM], v1) \
                        if right else send[FROM]
                    hpv[:, 2 * i + hh] = np.maximum.reduce(
                        [v1, first, third])
            if not 0 <= r0 + rr < hc:
                # only the unit's first and last conv rows are tested
                assert rr in (0, 2 * rows)
                hpv[:] = INT_MIN
            if rr == 0:
                run = hpv
            elif rr % 2:
                run = np.maximum(run, hpv)
            else:
                vals = _epilogue(np.maximum(run, hpv), mode, a_t, b_t, lo,
                                 hi, relu)
                run = hpv
                ip = i0 + rr // 2 - 1
                for warp in range(4):
                    # the warp's staging: 64 pooled columns x 16 channels
                    stg = np.zeros((S.POOL_COLS + 1, 16), out.dtype)
                    t = slice(32 * warp, 32 * warp + 32)
                    for k in range(HP):
                        stg[COL[t, 2 * k] // 2, ROW[t, 2 * k] - 16 * warp] = \
                            vals[t, k]
                    ch0 = ct * S.OT + 16 * warp
                    if ch0 >= o:
                        continue
                    dst = (nn, ip, slice(j0, j0 + cols),
                           slice(ch0, ch0 + 16))
                    out[dst] = stg[:cols]
                    writes[dst] += 1
    assert (writes == 1).all()
    return out


# ... and (1, 31, 32, 1, 32, 3): whole 16-byte rows with an odd left pad,
# so that the band's words are taken at an offset of 3 bytes
EMULATED = [(1, 37, 50, 3, 64, 1), (1, 37, 50, 3, 64, 2),
            (1, 37, 50, 3, 64, 3), (2, 65, 65, 3, 16, 4),
            (1, 31, 29, 1, 32, 8), (1, 20, 23, 2, 48, 5),
            (1, 9, 260, 4, 128, 2), (1, 224, 224, 3, 64, 4),
            (1, 31, 32, 1, 32, 3)]


def _emulated_case(n, h, w, c, o, band, mode):
    x, wk = _operands(n + h + w + c, n, h, w, c, o)
    pads = _same_pads(h, w) if c != 1 else ((3, 3), (3, 1))
    wp = S.pack_weight(torch.from_numpy(wk))
    a = b = None
    epi = dict(lo=-20, hi=100) if mode == "codes" else \
        dict(relu=mode == "f32")
    if mode != "int32":
        scale, b, *_ = _folds(h, o, False)
        a = scale * np.float32(0.5)
    want = S.int8_stem_pool_plain(
        torch.from_numpy(x), wp,
        *(None if t is None else torch.from_numpy(t) for t in (a, b)),
        pads=pads, pad=23, mode=mode, **epi)
    got = emulate(x, wp, pads, 23, band, mode, a, b, **epi)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("n,h,w,c,o,band", EMULATED)
def test_emulation_equals_plain(n, h, w, c, o, band):
    _emulated_case(n, h, w, c, o, band, "int32")


@pytest.mark.parametrize("mode", ["codes", "f32"])
@pytest.mark.parametrize("n,h,w,c,o,band", EMULATED)
def test_emulation_modes_equal_plain(n, h, w, c, o, band, mode):
    _emulated_case(n, h, w, c, o, band, mode)


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
                                 "small", "pads", "mode", "int32_epilogue",
                                 "codes_without_a", "codes_relu"])
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
    elif bad == "mode":
        kw["mode"] = "int8"
    elif bad == "int32_epilogue":
        kw.update(a=torch.ones(64), b=torch.zeros(64))
    elif bad == "codes_without_a":
        kw.update(mode="codes", b=torch.zeros(64))
    elif bad == "codes_relu":
        kw.update(mode="codes", a=torch.ones(64), b=torch.zeros(64),
                  relu=True)
    else:
        kw["pads"] = ((-1, 3), (2, 3))
    with pytest.raises(ValueError):
        S.int8_stem_pool(x, wp, **kw)


def test_qmaxpool_runs_the_pending_stem():
    """The chain's pending stem, ReLU-flagged and pooled: qmaxpool launches
    nothing and leaves a PendingStemPool whose int32 run is the pooled
    accumulator (JAX's, and the same conv as im2col rows through the GEMM,
    materialize's route, before a pool); each consumer's launch carries its
    own fold; other pools are refused."""
    x, wk = _operands(7, 2, 28, 30)
    pads, pad = _same_pads(28, 30), 5
    with LaunchRecorder() as rec:
        pooled = _pending_stem(x, wk, pads, pad)
    assert rec.calls == []
    assert pooled.relu and isinstance(pooled.acc, PendingStemPool)
    acc = pooled.acc.run(mode="int32")
    assert acc.dtype == torch.int32 and acc.shape == (2, 7, 8, 64)
    assert np.array_equal(acc.numpy(), _jax_stem_pool(x, wk, pads, pad))
    wt = torch.from_numpy(wk)
    pending = PendingWideConv(torch.from_numpy(x), pack_rows(wt),
                              S.pack_weight(wt), 7, 2, pads, pad)
    conv = pending.run(mode="int32")
    assert conv.shape == (2, 14, 15, 64)
    want = torch.nn.functional.max_pool2d(
        conv.permute(0, 3, 1, 2).double(), 3, 2, 1).permute(0, 2, 3, 1)
    assert torch.equal(acc, want.to(torch.int32))
    # two consumers (a block's conv1 and its downsample), two folds: one
    # launch each, in codes mode with its own A, B, L and hi
    folds = [(0.01, 2.0, -128, 127), (0.02, -1.5, 0, 255 - 128)]
    with LaunchRecorder() as rec:
        codes = [fold_quantize(pooled, *f) for f in folds]
    assert [call[0] for call in rec.calls] == ["stem_pool"] * 2
    for (_, args, kw, out), fold, q in zip(rec.calls, folds, codes):
        a, b, lo, hi = fold_params(pooled, *fold)
        assert kw["mode"] == "codes" and (kw["lo"], kw["hi"]) == (lo, hi)
        assert torch.equal(args[2], a) and torch.equal(args[3], b)
        assert out is q and q.dtype == torch.int8
        assert torch.equal(q, torch.round(acc.float() * a + b).clamp_(
            lo, hi).to(torch.int8))
    assert not torch.equal(codes[0], codes[1])
    de = DeferredEpilogue(pending, torch.ones(64), torch.zeros(64), relu=True)
    with pytest.raises(NotImplementedError):
        qmaxpool(de, (2, 2), (2, 2), ((0, 0), (0, 0)))
    with pytest.raises(NotImplementedError):
        qmaxpool(DeferredEpilogue(
            PendingWideConv(pending.x, pending.weight, None, 7, 2, pads, pad),
            torch.ones(64), torch.zeros(64)), (3, 3), (2, 2),
            ((1, 1), (1, 1)))
    with pytest.raises(ValueError):
        pooled.acc.run(torch.ones(64), torch.zeros(64), row=(None, None))


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (n, h, w, c, o, pads): ragged maps, every C, two column bands, two
# channel tiles, pads that are not SAME
CARD_CASES = [(2, 37, 50, 3, 64, None), (3, 65, 65, 3, 64, None),
              (1, 9, 260, 4, 128, None), (2, 31, 29, 1, 32, ((3, 3), (3, 1))),
              (1, 20, 23, 2, 48, None), (2, 64, 64, 3, 16, ((0, 6), (1, 2))),
              (2, 31, 32, 1, 32, ((3, 3), (3, 1)))]


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


def _card_epilogue(mode, o, dev, seed):
    """The card tests' epilogue: a consumer's fold of ``o`` channels."""
    if mode == "int32":
        return (), {}
    scale, bias, *_ = _folds(seed, o, False)
    ab = (torch.from_numpy(scale * np.float32(0.5)).to(dev),
          torch.from_numpy(bias).to(dev))
    return ab, (dict(lo=-20, hi=100) if mode == "codes" else
                dict(relu=True))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=["x".join(map(str, c[:5])) for c in CARD_CASES])
@pytest.mark.parametrize("band", [None, 1])
@pytest.mark.parametrize("mode", ["codes", "f32"])
def test_kernel_modes_match_plain(case, band, mode):
    dev = _card()
    n, h, w, c, o, pads = case
    pads = pads or _same_pads(h, w)
    x, wk = (torch.from_numpy(t).to(dev)
             for t in _operands(h * w + o, n, h, w, c, o))
    wp = S.pack_weight(wk)
    ab, epi = _card_epilogue(mode, o, dev, h + w)
    got = S.int8_stem_pool(x, wp, *ab, pads=pads, pad=-99, mode=mode,
                           _band=band, **epi)
    torch.cuda.synchronize()
    assert torch.equal(got, S.int8_stem_pool_plain(
        x, wp, *ab, pads=pads, pad=-99, mode=mode, **epi))


@pytest.mark.cuda
@pytest.mark.parametrize("w4", [False, True], ids=["w8", "w4"])
@pytest.mark.parametrize("mode", S.MODES)
@pytest.mark.parametrize("n", [8, 256])
def test_kernel_modes_match_plain_resnet50_stem(n, mode, w4):
    dev = _card()
    g = torch.Generator().manual_seed(n + 1)
    x = torch.randint(-128, 128, (n, 224, 224, 3), generator=g,
                      dtype=torch.int8).to(dev)
    wk = torch.randint(-8 if w4 else -128, 8 if w4 else 128, (7, 7, 3, 64),
                       generator=g, dtype=torch.int8).to(dev)
    wp = (S.pack_weight_int4 if w4 else S.pack_weight)(wk)
    pads = ((2, 3), (2, 3))
    ab, epi = _card_epilogue(mode, 64, dev, n)
    got = S.int8_stem_pool(x, wp, *ab, pads=pads, pad=7, mode=mode, **epi)
    torch.cuda.synchronize()
    assert got.shape == (n, 56, 56, 64)
    assert torch.equal(got, S.int8_stem_pool_plain(
        x, wp, *ab, pads=pads, pad=7, mode=mode, **epi))

"""The int8 GEMM's epilogue modes, the int8 im2col and ``qmaxpool``: the
kernels of the ImageNet ResNet path against the JAX package.

* The plain epilogue (``ops/cuda/epilogue.py``, which the GEMM and the
  conv share) on an int32 accumulator equals the JAX package's
  ``fold_quantize`` (codes), ``materialize`` (f32, with and without the
  ReLU) and ``fold_sum_quantize`` (codes with an int8, int32 or f32
  shortcut) on the same accumulator, exactly: JAX runs eagerly here, one
  rounded float32 op at a time in the same order (C2's one code is not
  needed).  ``int8_gemm`` on CPU tensors gives the same.
* The 7×7/s2 stem as ``int8_im2col`` rows through ``int8_gemm``: equal to
  JAX's int8 conv over the pad-code-padded codes (SAME pads (2, 3)), and
  the plain im2col to a float64 ``F.conv2d``, at ragged shapes.
* ``qmaxpool`` on the stem's pending conv (conv and pool in
  ``int8_stem_pool``) and on int8 codes equals JAX's ``qmaxpool``
  exactly.
* The compiled epilogue tiles are the source's; the wrappers raise on
  what the kernels do not take.
* ``cuda``-marked tests hold both kernels against their plain versions on
  the card (tolerance 0) at ragged M, every epilogue tile and every
  residual dtype, and skip here:
  ``python -m pytest --noconftest tests/test_torch_gemm_epilogue.py -m cuda``.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda import build
from dlmc_quant_torch.ops.cuda import int8_gemm as G
from dlmc_quant_torch.ops.cuda import int8_stem_pool as stem_pool
from dlmc_quant_torch.ops.cuda.epilogue import epilogue_plain
from dlmc_quant_torch.ops.cuda.int8_im2col import (int8_im2col,
                                                   int8_im2col_plain,
                                                   out_hw, pack_weight)
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingGemm,
                                          PendingWideConv, QuantizedTensor,
                                          fold_quantize, fold_sum_quantize,
                                          qmaxpool)

torch.set_num_threads(1)

M, K, N = 300, 96, 40


def _operands(seed, m=M, k=K, n=N):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    a = (np.abs(rng.standard_normal(n)) * 1e-3 + 1e-4).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0).astype(np.float32)
    return x, w, a, b


def _jax():
    """JAX and the JAX package's chain, imported where a test compares with
    them: the card's machine runs this file's cuda tests without JAX."""
    import jax
    import jax.numpy as jnp
    from dlmc_quant_tpu.quant import chain as jchain
    return jax, jnp, jchain


def _acc(x, w):
    _, jnp, _ = _jax()
    return np.asarray(jnp.matmul(jnp.asarray(x), jnp.asarray(w),
                                 preferred_element_type=jnp.int32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("relu", [False, True])
def test_codes_equal_jax_fold_quantize(relu):
    _, jnp, jchain = _jax()
    x, w, a, b = _operands(1)
    acc = _acc(x, w)
    inv, qbias = np.float32(1 / 0.0371), np.float32(-13.37)
    de = jchain.DeferredEpilogue(jnp.asarray(acc), jnp.asarray(a),
                                 jnp.asarray(b), relu=relu)
    want = np.asarray(jchain.fold_quantize(de, inv, qbias, -128, 127))
    # the port's folded affine, as chain.fold_params computes it
    fa, fb = (torch.from_numpy(a) * float(inv),
              torch.from_numpy(b) * float(inv) + float(qbias))
    lo = min(max(round(float(qbias)), -128), 127) if relu else -128
    got = G.int8_gemm(*_t(x), G.pack_b(torch.from_numpy(w)), fa, fb,
                      mode="codes", lo=lo, hi=127)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    assert torch.equal(epilogue_plain(torch.from_numpy(np.array(acc)), fa, fb,
                                      mode="codes", lo=lo, hi=127), got)
    assert len(np.unique(want)) > 50     # not all clamps


@pytest.mark.parametrize("relu", [False, True])
def test_f32_equals_jax_materialize(relu):
    _, jnp, jchain = _jax()
    x, w, a, b = _operands(2)
    acc = _acc(x, w)
    want = np.asarray(jchain.materialize(jchain.DeferredEpilogue(
        jnp.asarray(acc), jnp.asarray(a), jnp.asarray(b), relu=relu)))
    got = G.int8_gemm(*_t(x), G.pack_b(torch.from_numpy(w)), *_t(a, b),
                      mode="f32", relu=relu)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def _shortcut(kind, rng, shape):
    """A shortcut term of ``kind`` as (JAX term, port term)."""
    _, jnp, jchain = _jax()
    if kind == "int8":
        r = rng.integers(-128, 128, shape, dtype=np.int8)
        s, o = np.float32(0.0173), np.float32(2.31)
        return (jchain.QuantizedTensor(jnp.asarray(r), s, o),
                QuantizedTensor(torch.from_numpy(r), float(s), float(o)))
    if kind == "int32":
        r = rng.integers(-40000, 40000, shape).astype(np.int32)
        s = (np.abs(rng.standard_normal(shape[-1])) * 1e-3).astype(np.float32)
        o = rng.standard_normal(shape[-1]).astype(np.float32)
        return (jchain.DeferredEpilogue(jnp.asarray(r), jnp.asarray(s),
                                        jnp.asarray(o)),
                DeferredEpilogue(*_t(r, s, o)))
    r = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
    return jnp.asarray(r), torch.from_numpy(r)


@pytest.mark.parametrize("kind", ["int8", "int32", "f32"])
def test_residual_equals_jax_fold_sum_quantize(kind):
    """A Bottleneck's conv3 closing its block: the trunk a pending GEMM,
    the shortcut term of each kind, as fold_sum_quantize folds it."""
    _, jnp, jchain = _jax()
    x, w, a, b = _operands(3)
    rng = np.random.default_rng(4)
    term_j, term_p = _shortcut(kind, rng, (2, 10, 15, N))
    inv, qbias, lo = np.float32(1 / 3.71), np.float32(-13.37), -40
    y_j = jchain.DeferredEpilogue(
        jnp.asarray(_acc(x, w)).reshape(2, 10, 15, N), jnp.asarray(a),
        jnp.asarray(b))
    want = np.asarray(jchain.fold_sum_quantize([y_j, term_j], inv, qbias, lo,
                                               127))
    x_t, w_t, a_t, b_t = _t(x, w, a, b)
    y_p = DeferredEpilogue(PendingGemm(x_t, G.pack_b(w_t), (2, 10, 15)), a_t,
                           b_t)
    got = fold_sum_quantize([y_p, term_p], float(inv), float(qbias), lo, 127)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 50


def test_stem_im2col_gemm_equals_jax_conv():
    """The 7×7/s2 stem on a 64×64 map (SAME: pads (2, 3)), the pad code at
    the borders: im2col rows through the GEMM give JAX's int32 conv."""
    jax, jnp, _ = _jax()
    rng = np.random.default_rng(5)
    x = rng.integers(-128, 128, (2, 64, 64, 3), dtype=np.int8)
    wk = rng.integers(-128, 128, (7, 7, 3, 64), dtype=np.int8)
    pad, pads = -37, ((2, 3), (2, 3))
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (2, 3), (2, 3), (0, 0)),
                 constant_values=jnp.int8(pad))
    want = np.asarray(jax.lax.conv_general_dilated(
        xp, jnp.asarray(wk), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    rows = int8_im2col(torch.from_numpy(x), kernel=7, stride=2, pads=pads,
                       pad=pad)
    assert rows.shape == (2 * 32 * 32, 160)
    assert not bool(rows[:, 147:].any())
    acc = G.int8_gemm(rows, pack_weight(torch.from_numpy(wk)))
    assert np.array_equal(acc.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("n,h,w,c,k,s,pads", [
    (2, 9, 7, 3, 7, 2, ((3, 3), (2, 4))), (1, 5, 6, 5, 5, 1, ((2, 2), (2, 2))),
    (3, 8, 8, 4, 3, 3, ((0, 1), (1, 0)))])
def test_im2col_plain_equals_padded_conv(n, h, w, c, k, s, pads):
    rng = np.random.default_rng(n * h + k)
    x = torch.from_numpy(rng.integers(-128, 128, (n, h, w, c),
                                      dtype=np.int8))
    wk = torch.from_numpy(rng.integers(-128, 128, (k, k, c, 6),
                                       dtype=np.int8))
    pad = 11
    rows = int8_im2col_plain(x, kernel=k, stride=s, pads=pads, pad=pad)
    (top, bottom), (left, right) = pads
    xp = F.pad(x.permute(0, 3, 1, 2).double(), (left, right, top, bottom),
               value=pad)
    want = F.conv2d(xp, wk.permute(3, 2, 0, 1).double(), stride=s)
    ho, wo = out_hw(h, w, k, s, pads)
    assert want.shape[2:] == (ho, wo)
    got = G.int8_gemm_plain(rows, pack_weight(wk)).reshape(n, ho, wo, 6)
    assert torch.equal(got, want.permute(0, 2, 3, 1).to(torch.int32))


def test_qmaxpool_equals_jax():
    """The stem's pending conv (7×7/s2 on a 28×28 map, SAME pads (2, 3),
    run with its pool by int8_stem_pool) and int8 codes, pooled 3×3/s2
    with pads 1, as JAX pools them; the stem's consumer's codes as JAX
    folds them."""
    jax, jnp, jchain = _jax()
    rng = np.random.default_rng(6)
    x = rng.integers(-128, 128, (2, 28, 28, 3), dtype=np.int8)
    wk = rng.integers(-128, 128, (7, 7, 3, 16), dtype=np.int8)
    pad, pads = 9, ((2, 3), (2, 3))
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (2, 3), (2, 3), (0, 0)),
                 constant_values=jnp.int8(pad))
    acc = jax.lax.conv_general_dilated(
        xp, jnp.asarray(wk), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    scale, bias = np.ones(16, np.float32), np.zeros(16, np.float32)
    args = ((3, 3), (2, 2), ((1, 1), (1, 1)))
    want = jchain.qmaxpool(jchain.DeferredEpilogue(
        acc, jnp.asarray(scale), jnp.asarray(bias), relu=True), *args)
    w_t = torch.from_numpy(wk)
    de = DeferredEpilogue(PendingWideConv(
        torch.from_numpy(x), pack_weight(w_t), stem_pool.pack_weight(w_t), 7,
        2, pads, pad), *_t(scale, bias), True)
    got = qmaxpool(de, *args)
    acc = got.acc.run(mode="int32")
    assert got.relu and acc.dtype == torch.int32
    assert acc.shape == (2, 7, 7, 16)
    assert np.array_equal(acc.numpy(), np.asarray(want.acc))
    # the consumer's folded codes, in the stem's own launch
    inv, qbias = float(np.float32(0.37)), float(np.float32(-2.5))
    codes = fold_quantize(got, inv, qbias, -128, 127)
    assert codes.dtype == torch.int8
    assert np.array_equal(codes.numpy(), np.asarray(
        jchain.fold_quantize(want, inv, qbias, -128, 127)))

    q = rng.integers(-128, 128, (2, 13, 12, 8), dtype=np.int8)
    want_q = jchain.qmaxpool(jchain.QuantizedTensor(
        jnp.asarray(q), jnp.float32(0.02), jnp.float32(1.5)), *args)
    got_q = qmaxpool(QuantizedTensor(torch.from_numpy(q), 0.02, 1.5), *args)
    assert got_q.q.dtype == torch.int8
    assert np.array_equal(got_q.q.numpy(), np.asarray(want_q.q))


def test_epilogue_tiles_are_the_sources():
    text = (build.CSRC / "int8_gemm.cu").read_text()
    compiled = {(int(a), int(b)): int(c) for a, b, c in re.findall(
        r"DLMCQ_EPILOGUE_TILE\((\d+), (\d+), (\d+)\)", text)}
    assert compiled == {t: G.TILE_STAGES[t] for t in G.EPILOGUE_TILES}
    for m, n in ((802816, 64), (200704, 256), (3, 1000), (100352, 2048)):
        assert G.default_tile(m, n, tiles=G.EPILOGUE_TILES) in \
            G.EPILOGUE_TILES


@pytest.mark.parametrize("bad", ["int32_a", "f32_residual", "a_shape",
                                 "r_shape", "tile", "relu_codes", "mode"])
def test_gemm_epilogue_raises(bad):
    x, w, a, b = _t(*_operands(7, 64, 32, 16))
    wp = G.pack_b(w)
    kw = dict(mode="codes")
    r = torch.zeros((64, 16), dtype=torch.int8)
    if bad == "int32_a":
        kw["mode"] = "int32"
    elif bad == "f32_residual":
        kw.update(mode="f32", residual=(r, a, b))
    elif bad == "a_shape":
        a = a[:8]
    elif bad == "r_shape":
        kw.update(residual=(r[:8], a, b))
    elif bad == "tile":
        kw["tile"] = (128, 48)     # compiled for int32 only
    elif bad == "relu_codes":
        kw["relu"] = True
    else:
        kw["mode"] = "int8"
    with pytest.raises(ValueError):
        G.int8_gemm(x, wp, a, b, **kw)


@pytest.mark.parametrize("bad", ["kp", "pads", "dtype"])
def test_im2col_raises(bad):
    x = torch.zeros((1, 8, 8, 3), dtype=torch.int8)
    kw = dict(kernel=7, stride=2, pads=((2, 3), (2, 3)), pad=0)
    if bad == "kp":
        x = torch.zeros((1, 8, 8, 64), dtype=torch.int8)    # K = 3136
    elif bad == "pads":
        kw["pads"] = ((-1, 0), (0, 0))
    else:
        x = x.to(torch.int32)
    with pytest.raises(ValueError):
        int8_im2col(x, **kw)


# --- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# (M, K, N): ResNet-50's 1x1 convs at batch 2 and ragged ones
EPI_CASES = [(6272, 64, 64), (6272, 64, 256), (1568, 256, 128),
             (392, 1024, 512), (98, 2048, 512), (98, 512, 2048),
             (300, 96, 40), (65, 32, 7), (1, 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["codes", "f32", "f32_relu", "int8",
                                  "int32", "f32_r"])
@pytest.mark.parametrize("case", EPI_CASES,
                         ids=["x".join(map(str, c)) for c in EPI_CASES])
def test_gemm_epilogue_kernel_matches_plain(case, mode):
    """Every epilogue tile; codes, f32 (with and without ReLU) and codes
    with a residual of each dtype (mode int8, int32, f32_r)."""
    dev = _card()
    m, k, n = case
    x, w, a, b = (t.to(dev) for t in _t(*_operands(m + n, m, k, n)))
    wp = G.pack_b(w)
    g = torch.Generator().manual_seed(k)
    kw = dict(mode="codes", lo=-100, hi=120)
    if mode.startswith("f32") and mode != "f32_r":
        kw = dict(mode="f32", relu=mode == "f32_relu")
    elif mode != "codes":
        dtype = {"int8": torch.int8, "int32": torch.int32,
                 "f32_r": torch.float32}[mode]
        r = (torch.rand((m, n), generator=g) * 3 if dtype == torch.float32
             else torch.randint(-128, 128, (m, n), generator=g).to(dtype))
        ar = torch.rand(n, generator=g) * 0.05
        br = torch.randn(n, generator=g)
        kw["residual"] = tuple(t.to(dev).contiguous() for t in (r, ar, br))
        kw["qb"] = -130.25
    want = G.int8_gemm_plain(x, wp, a, b, **kw)
    for tile in G.EPILOGUE_TILES:
        got = G.int8_gemm(x, wp, a, b, tile=tile, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile


STEM_CASES = [(2, 224, 224, 3, 7, 2, ((2, 3), (2, 3))),
              (3, 64, 64, 3, 7, 2, ((2, 3), (2, 3))),
              (1, 9, 7, 5, 7, 2, ((3, 3), (2, 4))),
              (2, 10, 10, 16, 5, 1, ((2, 2), (2, 2))),
              # column tiles (a band row beyond shared memory), and bands
              # of 6 rows whose last ends on the map's last row
              (1, 12, 3000, 16, 5, 1, ((2, 2), (2, 2))),
              (64, 100, 100, 3, 7, 2, ((2, 3), (2, 3)))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STEM_CASES,
                         ids=["x".join(map(str, c[:6])) for c in STEM_CASES])
def test_im2col_kernel_matches_plain(case):
    dev = _card()
    n, h, w, c, k, s, pads = case
    g = torch.Generator().manual_seed(h * w)
    x = torch.randint(-128, 128, (n, h, w, c), generator=g,
                      dtype=torch.int8).to(dev)
    got = int8_im2col(x, kernel=k, stride=s, pads=pads, pad=-7)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_im2col_plain(x, kernel=k, stride=s,
                                              pads=pads, pad=-7))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(1, 1), (2, 3), (3, 7), (8, 200)])
@pytest.mark.parametrize("case", STEM_CASES,
                         ids=["x".join(map(str, c[:6])) for c in STEM_CASES])
def test_im2col_kernel_forced_tiles_match_plain(case, tile):
    """The kernel at tiles the plan would not pick: band rows shared
    between tiles, column tiles, ragged last tiles, x at an odd address."""
    dev = _card()
    n, h, w, c, k, s, pads = case
    g = torch.Generator().manual_seed(h + w)
    x = torch.randint(-128, 128, (n, h, w, c), generator=g,
                      dtype=torch.int8).to(dev)
    from dlmc_quant_torch.ops.cuda import int8_im2col as I
    p = I.make_plan(n, h, w, c, k, s, pads, *tile)
    if p.smem > I.MAX_SMEM:
        pytest.skip("the band does not fit the kernel's shared memory")
    want = int8_im2col_plain(x, kernel=k, stride=s, pads=pads, pad=-7)
    got = I.launch(x, k, s, pads, -7, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # the same codes one byte into a buffer: every lead of the band rows
    xo = torch.empty(x.numel() + 1, dtype=torch.int8, device=dev)[1:] \
        .view(x.shape)
    xo.copy_(x)
    got = I.launch(xo, k, s, pads, -7, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

"""The int8 3×3 conv's two ResNet extensions, and the int8 GEMM at the
ResNet-18 shortcut shapes.

* SAME geometry of a stride-2 conv on an even map (``pad_lo=0``: the
  window of output p starts at row 2p, the pad is at the bottom and
  right): the plain version equals a float64 ``F.conv2d`` over
  ``F.pad(0, 1, 0, 1)`` and JAX's SAME conv with the same epilogue,
  exactly.
* The residual epilogue (``residual=(r, ar, br)``, codes mode) with int8,
  int32 and f32 ``r`` against the JAX package's ``fold_sum_quantize`` on
  the same accumulator: equal, with general affines (each side rounds
  the same f32 ops in the same order; C2's one code is not needed) and
  with power-of-two ones (where no op rounds).
* ``cuda``-marked tests hold the kernel against its plain version on the
  card at the ResNet-18 shapes (tolerance 0) and skip here:
  ``python -m pytest --noconftest tests/test_torch_resnet_conv.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dlmc_quant_torch.ops.cuda.int8_conv import (int8_conv3x3,
                                                 int8_conv3x3_plain,
                                                 pack_weight)
from dlmc_quant_torch.ops.cuda.int8_gemm import (int8_gemm, int8_gemm_plain,
                                                 pack_b)
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingConv,
                                          QuantizedTensor, fold_sum_quantize)

torch.set_num_threads(1)


def _inputs(seed, n, h, w, c, o, pow2=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wk = rng.integers(-128, 128, (3, 3, c, o), dtype=np.int8)
    if pow2:
        a = (2.0 ** rng.integers(-18, -14, o)).astype(np.float32)
        b = (rng.integers(-64, 64, o) / 4.0).astype(np.float32)
    else:
        a = (np.abs(rng.standard_normal(o)) * 1e-3 + 1e-4).astype(np.float32)
        b = (rng.standard_normal(o) * 2.0).astype(np.float32)
    return x, wk, a, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n,h,w,c,o", [(2, 16, 16, 16, 24), (3, 8, 6, 5, 7),
                                       (1, 4, 4, 64, 96)])
@pytest.mark.parametrize("mode", ["codes", "f32"])
def test_same_stride2_equals_padded_conv(n, h, w, c, o, mode):
    x, wk, a, b = _t(*_inputs(1, n, h, w, c, o))
    pad = -7
    got = int8_conv3x3(x, pack_weight(wk), a, b, stride=2, pad=pad,
                       pad_lo=0, lo=-100, hi=120, mode=mode)
    xp = F.pad(x.permute(0, 3, 1, 2).double(), (0, 1, 0, 1), value=pad)
    acc = F.conv2d(xp, wk.permute(3, 2, 0, 1).double(), stride=2)
    y = acc.permute(0, 2, 3, 1).float() * a
    y = y + b
    want = torch.round(y).clamp(-100, 120).to(torch.int8) \
        if mode == "codes" else y
    assert got.shape == (n, -(-h // 2), -(-w // 2), o)
    assert torch.equal(got, want)


def test_same_stride2_equals_jax_same_conv():
    """JAX's SAME conv with explicit pads ((0, 1), (0, 1)), the pad code as
    its border, and the same f32 epilogue."""
    import jax
    import jax.numpy as jnp
    x, wk, a, b = _inputs(2, 2, 16, 16, 16, 32)
    pad = 3
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 1), (0, 1), (0, 0)),
                 constant_values=jnp.int8(pad))
    acc = jax.lax.conv_general_dilated(
        xp, jnp.asarray(wk), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    want = np.asarray(jnp.clip(jnp.round(acc.astype(jnp.float32) * a + b),
                               -128, 127).astype(jnp.int8))
    got = int8_conv3x3(*_t(x), pack_weight(torch.from_numpy(wk)),
                       *_t(a, b), stride=2, pad=pad, pad_lo=0)
    assert np.array_equal(got.numpy(), want)


def _residual_case(kind, pow2, seed=3, n=2, h=8, w=8, c=16, o=24):
    """Inputs of one residual boundary, in numpy: the trunk conv's codes,
    weights and affine, the shortcut term and the output grid."""
    rng = np.random.default_rng(seed + 10)
    x, wk, scale, bias = _inputs(seed, n, h, w, c, o, pow2)
    shape = (n, h, w, o)
    if kind == "int8":
        r = rng.integers(-128, 128, shape, dtype=np.int8)
        r_aff = (np.float32(2.0 ** -6 if pow2 else 0.0173),
                 np.float32(2.0 if pow2 else 2.31))
    elif kind == "int32":
        r = rng.integers(-40000, 40000, shape).astype(np.int32)
        r_aff = _inputs(seed + 1, 1, 1, 1, 1, o, pow2)[2:]
    else:
        r = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
        if pow2:
            r = (np.round(r * 64) / 64).astype(np.float32)
        r_aff = None
    inv = np.float32(2.0 ** 4 if pow2 else 1 / 3.71)
    qbias = np.float32(-2.0 if pow2 else -13.37)
    return x, wk, scale, bias, r, r_aff, inv, qbias


def _jax_fold_sum(x, wk, scale, bias, r, r_aff, inv, qbias, kind, lo, hi):
    import jax
    import jax.numpy as jnp
    from dlmc_quant_tpu.quant import chain as jchain
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                 constant_values=jnp.int8(-5))
    acc = jax.lax.conv_general_dilated(
        xp, jnp.asarray(wk), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    y = jchain.DeferredEpilogue(acc, jnp.asarray(scale), jnp.asarray(bias))
    if kind == "int8":
        term = jchain.QuantizedTensor(jnp.asarray(r), jnp.float32(r_aff[0]),
                                      jnp.float32(r_aff[1]))
    elif kind == "int32":
        term = jchain.DeferredEpilogue(jnp.asarray(r), jnp.asarray(r_aff[0]),
                                       jnp.asarray(r_aff[1]))
    else:
        term = jnp.asarray(r)
    return np.asarray(jchain.fold_sum_quantize(
        [y, term], jnp.float32(inv), jnp.float32(qbias), lo, hi))


def _port_fold_sum(x, wk, scale, bias, r, r_aff, inv, qbias, kind, lo, hi):
    x_t, wk_t, scale_t, bias_t, r_t = _t(x, wk, scale, bias, r)
    y = DeferredEpilogue(PendingConv(x_t, pack_weight(wk_t), 1, -5),
                         scale_t, bias_t)
    if kind == "int8":
        term = QuantizedTensor(r_t, float(r_aff[0]), float(r_aff[1]))
    elif kind == "int32":
        term = DeferredEpilogue(r_t, *_t(*r_aff))
    else:
        term = r_t
    return fold_sum_quantize([y, term], float(inv), float(qbias), lo,
                             hi).numpy()


@pytest.mark.parametrize("pow2", [False, True], ids=["general", "pow2"])
@pytest.mark.parametrize("kind", ["int8", "int32", "f32"])
def test_residual_epilogue_matches_jax_fold_sum(kind, pow2):
    case = _residual_case(kind, pow2)
    lo, hi = -128, 127
    if not pow2:
        lo = -40     # a folded ReLU's lower bound
    want = _jax_fold_sum(*case, kind, lo, hi)
    got = _port_fold_sum(*case, kind, lo, hi)
    # C2 allows one code; JAX runs eagerly here, one rounded f32 op at a
    # time in fold_sum_quantize's order, as the plain version does, so the
    # codes are equal (on power-of-two affines no op even rounds)
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want)
    # the codes span the grid: the test is not all clamps
    assert len(np.unique(got)) > 50


@pytest.mark.parametrize("bad", ["pad_lo_s1", "pad_lo_2", "f32_mode",
                                 "r_shape", "r_dtype", "ar_shape",
                                 "qb_type"])
def test_extensions_raise(bad):
    x, wk, a, b = _t(*_inputs(6, 2, 8, 8, 16, 8))
    w = pack_weight(wk)
    r, ar, br = torch.zeros((2, 8, 8, 8), dtype=torch.int8), a, b
    kw = dict(stride=1, pad=0, pad_lo=1, mode="codes", qb=0.0)
    if bad == "pad_lo_s1":
        kw["pad_lo"] = 0
    elif bad == "pad_lo_2":
        kw.update(stride=2, pad_lo=2)
    elif bad == "f32_mode":
        kw["mode"] = "f32"
    elif bad == "r_shape":
        r = r[:, :4]
    elif bad == "r_dtype":
        r = r.to(torch.int16)
    elif bad == "ar_shape":
        ar = ar[:4]
    elif bad == "qb_type":
        kw["qb"] = torch.tensor(0.0)
    with pytest.raises(ValueError):
        int8_conv3x3(x, w, a, b, residual=(r, ar, br), **kw)


# --- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# ResNet-18's stride-2 convs at batch 8 (and ragged: odd O, M % 128 != 0)
SAME_CASES = [(8, 32, 32, 64, 128), (8, 16, 16, 128, 256),
              (8, 8, 8, 256, 512), (3, 10, 6, 16, 70), (5, 6, 6, 3, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["codes", "f32"])
@pytest.mark.parametrize("case", SAME_CASES,
                         ids=["x".join(map(str, c)) for c in SAME_CASES])
def test_same_stride2_kernel_matches_plain(case, mode):
    dev = _card()
    x, wk, a, b = (t.to(dev) for t in _t(*_inputs(7, *case)))
    kw = dict(stride=2, pad=-3, pad_lo=0, mode=mode)
    got = int8_conv3x3(x, pack_weight(wk), a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_conv3x3_plain(x, pack_weight(wk), a, b,
                                               **kw))


# ResNet-18's block-closing convs at batch 8: (n, h, w, c, o, stride, pad_lo)
RESIDUAL_CASES = [(8, 32, 32, 64, 64, 1, 1), (8, 16, 16, 128, 128, 1, 1),
                  (8, 8, 8, 256, 256, 1, 1), (8, 4, 4, 512, 512, 1, 1),
                  (3, 9, 7, 16, 70, 1, 1), (4, 8, 8, 64, 96, 2, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [torch.int8, torch.int32, torch.float32],
                         ids=["int8", "int32", "f32"])
@pytest.mark.parametrize("case", RESIDUAL_CASES,
                         ids=["x".join(map(str, c)) for c in RESIDUAL_CASES])
def test_residual_kernel_matches_plain(case, kind):
    dev = _card()
    n, h, w, c, o, stride, pad_lo = case
    x, wk, a, b = (t.to(dev) for t in _t(*_inputs(8, n, h, w, c, o)))
    g = torch.Generator().manual_seed(9)
    shape = (n, -(-h // stride), -(-w // stride), o)
    if kind == torch.float32:
        r = torch.rand(shape, generator=g) * 3
    else:
        r = torch.randint(-128, 128, shape, generator=g).to(kind)
    ar = torch.rand(o, generator=g) * 0.05
    br = torch.randn(o, generator=g)
    res = tuple(t.to(dev).contiguous() for t in (r, ar, br))
    kw = dict(stride=stride, pad=5, pad_lo=pad_lo, lo=-128 + 40, hi=127,
              residual=res, qb=-130.25)
    got = int8_conv3x3(x, pack_weight(wk), a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_conv3x3_plain(x, pack_weight(wk), a, b,
                                               **kw))


SHORTCUTS = [(65536, 64, 128), (16384, 128, 256), (4096, 256, 512),
             (1000, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHORTCUTS,
                         ids=["x".join(map(str, s)) for s in SHORTCUTS])
def test_gemm_at_shortcut_shapes(m, k, n):
    dev = _card()
    g = torch.Generator().manual_seed(m)
    x = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    w = pack_b(torch.randint(-128, 128, (k, n), generator=g,
                             dtype=torch.int8))
    x, w = x.to(dev), w.to(dev)
    got = int8_gemm(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_gemm_plain(x, w))

"""The int8 depthwise 3×3 conv (``ops/cuda/int8_dwconv.py``) and its place
on the chain, against the JAX package.

* The plain version, run through the port's chain (``PendingDwConv`` in a
  ``DeferredEpilogue``; ``fold_quantize`` for codes, ``materialize`` for
  f32), equals JAX's integer path exactly: the codes padded with a
  nonzero pad code (``jnp.pad``), the int32 ``conv_general_dilated`` at
  ``feature_group_count = C``, then JAX's ``chain.fold_quantize`` or
  ``chain.materialize`` on the same scales and grid.  Strides 1 and 2,
  pad 1 and flax's SAME, odd and even maps, C ∈ {16, 48, 144}, no clamp,
  a ReLU and a ReLU6 (``clamp_hi``).  Exact: the int8 inputs and the
  float32 epilogue inputs are equal (ROADMAP hazard C2).
* The packing round-trips; the wrapper raises on what neither route
  takes, and the kernel's own check on a C off its granule (C % 8) while
  the plain version runs it; a depthwise ``QConv`` fed codes on a producer's grid (a
  ``QuantizedTensor``) re-derives its epilogue from per-channel column
  sums over the nine taps and equals an f32 conv of the dequantized codes.
* ``cuda``-marked tests hold the kernel against its plain version on the
  card (tolerance 0) at MobileNetV2's and MobileOne-S1's depthwise shapes
  at batch 8 and 256, at ragged sizes (C = 8, 24 and 40 among them) and
  on plans other than ``plan()``'s; a C off the kernel's granule raises;
  they skip here:
  ``python -m pytest --noconftest tests/test_torch_dwconv.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dlmc_quant_torch.ops.cuda import int8_dwconv as D
from dlmc_quant_torch.quant import chain
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingDwConv,
                                          QuantizedTensor)
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import QConv, attach_scheme, calibrate

torch.set_num_threads(1)

PAD = -37                      # a nonzero pad code: real 0 is not code 0
INV_S, QBIAS = 0.0123, -3.25   # the consumer grid of the folded boundary
QMIN_S, QMAX_S = -128, 127
SCHEME = {"quantization_type": "FSPTQ",
          "weight": {"enable": True, "type": "minmax_channel",
                     "args": {"n_bits": 8, "signed": True}},
          "input": {"enable": True, "type": "minmax_tensor",
                    "args": {"n_bits": 8, "signed": False}}}


def _operands(seed, n, h, w, c):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wk = rng.integers(-128, 128, (3, 3, 1, c), dtype=np.int8)
    scale = (rng.random(c, dtype=np.float32) * 2e-3 + 1e-4).astype(np.float32)
    bias = (rng.standard_normal(c).astype(np.float32) * 3).astype(np.float32)
    return x, wk, scale, bias


def _pads(h, w, stride, padding):
    """((top, bottom), (left, right)) of the port's QConv geometry."""
    return QConv(16, 16, 3, stride, padding, groups=16).spatial_pads(h, w)


def _jax_acc(x, wk, stride, pads):
    import jax
    import jax.numpy as jnp
    xp = jnp.pad(jnp.asarray(x), ((0, 0),) + tuple(pads) + ((0, 0),),
                 constant_values=jnp.int8(PAD))
    return jax.lax.conv_general_dilated(
        xp, jnp.asarray(wk), (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=x.shape[-1], preferred_element_type=jnp.int32)


# (n, h, w, c, stride, padding): odd and even maps, both geometries
CASES = [(2, 8, 8, 16, 1, 1), (2, 8, 8, 48, 2, "SAME"), (2, 8, 8, 48, 2, 1),
         (1, 7, 9, 144, 2, "SAME"), (2, 7, 7, 16, 1, "SAME"),
         (1, 6, 5, 144, 1, 1), (3, 9, 4, 48, 2, 1)]
CLAMPS = {"none": (False, None), "relu": (True, None), "relu6": (True, 6.0)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("mode", ["codes", "f32"])
@pytest.mark.parametrize("clamp", list(CLAMPS))
def test_plain_on_the_chain_equals_jax(case, mode, clamp):
    import jax.numpy as jnp
    from dlmc_quant_tpu.quant import chain as jchain
    n, h, w, c, stride, padding = case
    relu, clamp_hi = CLAMPS[clamp]
    x, wk, scale, bias = _operands(h * w * c + stride, n, h, w, c)
    pads = _pads(h, w, stride, padding)
    acc = _jax_acc(x, wk, stride, pads)
    jde = jchain.DeferredEpilogue(acc, jnp.asarray(scale),
                                  jnp.asarray(bias), relu=relu,
                                  clamp_hi=clamp_hi)
    pending = PendingDwConv(torch.from_numpy(x),
                            D.pack_weight(torch.from_numpy(wk)), stride,
                            PAD, pads[0][0])
    de = DeferredEpilogue(pending, torch.from_numpy(scale),
                          torch.from_numpy(bias), relu=relu,
                          clamp_hi=clamp_hi)
    if mode == "codes":
        want = np.asarray(jchain.fold_quantize(
            jde, jnp.float32(INV_S), jnp.float32(QBIAS), QMIN_S, QMAX_S))
        got = chain.fold_quantize(de, float(np.float32(INV_S)),
                                  float(np.float32(QBIAS)), QMIN_S, QMAX_S)
        assert got.dtype == torch.int8
    else:
        want = np.asarray(jchain.materialize(jde))
        got = chain.materialize(de)
        assert got.dtype == torch.float32
    assert got.shape == want.shape == (n, -(-h // stride), -(-w // stride),
                                       c)
    assert np.array_equal(got.numpy(), want)


def test_pack_weight_round_trip():
    wk = torch.randint(-128, 128, (3, 3, 1, 48), dtype=torch.int8)
    wp = D.pack_weight(wk)
    assert wp.shape == (9, 48) and wp.is_contiguous()
    assert torch.equal(wp[3 * 2 + 1], wk[2, 1, 0])
    assert torch.equal(D.unpack_weight(wp), wk)


@pytest.mark.parametrize("bad", ["channels", "stride", "pad_lo", "weight",
                                 "pad", "epilogue"])
def test_raises(bad):
    c = 20 if bad == "channels" else 32
    x = torch.zeros((1, 6, 6, c), dtype=torch.int8)
    w = torch.zeros((9, 16 if bad == "weight" else c), dtype=torch.int8)
    a, b = torch.ones(c), torch.zeros(c)
    kw = dict(stride=3 if bad == "stride" else 1, pad=300 if bad == "pad"
              else 0, pad_lo=0 if bad == "pad_lo" else 1)
    if bad == "epilogue":
        kw["relu"] = True          # codes fold the ReLU into lo
    if bad == "channels":
        # the kernel's granule is checked on the CUDA route only: the plain
        # version takes C = 20
        with pytest.raises(ValueError, match=r"C % 8 == 0"):
            D.check_kernel(x, w, 1)
        assert D.int8_dwconv3x3(x, w, a, b, **kw).shape == (1, 6, 6, c)
        return
    with pytest.raises(ValueError):
        D.int8_dwconv3x3(x, w, a, b, **kw)


def test_codes_on_a_producer_grid():
    """A depthwise QConv fed a QuantizedTensor: its epilogue comes from
    per-channel column sums over the nine taps (the JAX package's sum over
    HWI with I = 1) and the result is the f32 conv of the dequantized
    codes with the dequantized weights."""
    g = torch.Generator().manual_seed(5)
    conv = QConv(32, 32, 3, 2, "SAME", groups=32, generator=g)
    with torch.no_grad():
        conv.bias.copy_(torch.randn(32, generator=g))
    attach_scheme(conv, scheme_from_dict(SCHEME))
    x = torch.rand((2, 10, 10, 32), generator=g)
    calibrate(conv, [x])
    prepare_deploy(conv)
    w_int = conv.w_int.to(torch.int32)
    assert torch.equal(conv.colsum, w_int.sum(dim=(1, 2, 3)).float())
    q = torch.randint(-128, 128, (2, 10, 10, 32), generator=g,
                      dtype=torch.int8)
    qt = QuantizedTensor(q, 0.02, -0.3)
    with torch.no_grad():
        got = conv(qt, qmode="int")
        w_real = conv.w_int.float() * conv.w_scale.reshape(-1, 1, 1, 1)
        want = conv._conv(q.float() * 0.02 + -0.3, w_real, bias=False) \
            + conv.bias
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_other_groupings_raise():
    conv = QConv(32, 32, 3, 1, 1, groups=2)
    attach_scheme(conv, scheme_from_dict(SCHEME))
    x = torch.rand((1, 6, 6, 32))
    calibrate(conv, [x])
    prepare_deploy(conv)
    assert not hasattr(conv, "w_dw")
    with pytest.raises(NotImplementedError, match=r"item 7"):
        conv(x, qmode="intc")


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# the depthwise convs of MobileNetV2 and MobileOne-S1 at 224²: (h, w, c,
# stride, pad_lo)
MOBILENET_V2 = [(112, 112, 32, 1, 1), (112, 112, 96, 2, 0),
                (56, 56, 144, 1, 1), (56, 56, 144, 2, 0),
                (28, 28, 192, 1, 1), (28, 28, 192, 2, 0),
                (14, 14, 384, 1, 1), (14, 14, 576, 1, 1),
                (14, 14, 576, 2, 0), (7, 7, 960, 1, 1)]
MOBILEONE_S1 = [(112, 112, 64, 2, 1), (56, 56, 96, 1, 1), (56, 56, 96, 2, 1),
                (28, 28, 192, 1, 1), (28, 28, 192, 2, 1), (14, 14, 512, 1, 1),
                (14, 14, 512, 2, 1)]
# and C = 8, 24, 40: the 8-byte granule and a masked tail slice
RAGGED = [(1, 1, 16, 1, 1), (3, 5, 16, 2, 1), (9, 13, 48, 2, 1),
          (2, 17, 2880, 1, 1), (31, 30, 80, 2, 0), (15, 1, 32, 2, 1),
          (5, 7, 8, 1, 1), (12, 10, 24, 2, 0), (9, 11, 40, 1, 1),
          (20, 19, 24, 1, 1), (13, 6, 40, 2, 1)]


def _card_operands(n, h, w, c, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, (n, h, w, c), generator=g,
                      dtype=torch.int8).to(dev)
    wp = torch.randint(-128, 128, (9, c), generator=g,
                       dtype=torch.int8).to(dev)
    a = (torch.rand(c, generator=g) * 1e-3 + 1e-5).to(dev)
    b = (torch.randn(c, generator=g) * 4).to(dev)
    return x, wp, a, b


def _kernel_vs_plain(n, h, w, c, stride, pad_lo, seed):
    """Both modes, with and without the clamps and the ReLU; at the serving
    batch the clamped codes and the ReLU'd f32 only (the plain version's
    float64 conv dominates the card tests' time)."""
    dev = _card()
    x, wp, a, b = _card_operands(n, h, w, c, dev, seed)
    modes = [dict(mode="codes", lo=-3, hi=90), dict(mode="f32", relu=True)]
    if n < 256:
        modes += [dict(mode="codes"), dict(mode="f32")]
    for kw in modes:
        got = D.int8_dwconv3x3(x, wp, a, b, stride=stride, pad=-11,
                               pad_lo=pad_lo, **kw)
        torch.cuda.synchronize()
        want = D.int8_dwconv3x3_plain(x, wp, a, b, stride=stride, pad=-11,
                                      pad_lo=pad_lo, **kw)
        assert torch.equal(got, want), kw


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 256])
@pytest.mark.parametrize("shape", MOBILENET_V2 + MOBILEONE_S1,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_mobile_shapes(shape, n):
    _kernel_vs_plain(n, *shape, seed=n + shape[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_ragged(shape):
    _kernel_vs_plain(3, *shape, seed=shape[0] * shape[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 13, 11, 24, 1, 1, (32, 2, 2, 3)),
                                  (4, 12, 9, 96, 2, 0, (64, 2, 1, 2)),
                                  (3, 9, 16, 40, 2, 1, (32, 3, 3, 1)),
                                  (2, 30, 30, 64, 1, 1, (64, 4, 4, 8))],
                         ids=["s1_c24", "s2_c96_cb64_tail", "s2_c40",
                              "s1_c64_cb64"])
def test_kernel_matches_plain_on_other_plans(case):
    """Plans other than plan()'s: small tiles, so that a block walks many
    (both halo buffers), a 64-channel slice with a masked tail."""
    n, h, w, c, stride, pad_lo, override = case
    dev = _card()
    x, wp, a, b = _card_operands(n, h, w, c, dev, c)
    for kw in (dict(mode="codes", lo=-3, hi=90), dict(mode="f32")):
        got = D.int8_dwconv3x3(x, wp, a, b, stride=stride, pad=7,
                               pad_lo=pad_lo, _plan=override, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, D.int8_dwconv3x3_plain(
            x, wp, a, b, stride=stride, pad=7, pad_lo=pad_lo, **kw)), kw


@pytest.mark.cuda
def test_kernel_refuses_channels_off_its_granule():
    dev = _card()
    x, wp, a, b = _card_operands(2, 5, 5, 20, dev, 3)
    with pytest.raises(ValueError, match=r"C % 8 == 0"):
        D.int8_dwconv3x3(x, wp, a, b, stride=1, pad=0)


@pytest.mark.cuda
def test_kernel_counts_its_launches():
    dev = _card()
    x, wp, a, b = _card_operands(2, 9, 9, 32, dev, 1)
    before = D.int8_dwconv3x3.launches
    D.int8_dwconv3x3(x, wp, a, b, stride=1, pad=0)
    D.int8_dwconv3x3_plain(x, wp, a, b, stride=1, pad=0)
    assert D.int8_dwconv3x3.launches == before + 1

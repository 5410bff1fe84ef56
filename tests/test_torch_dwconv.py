"""The int8 depthwise 3×3 and 5×5 conv (``ops/cuda/int8_dwconv.py``) and
its place on the chain, against the JAX package.

* The plain version, run through the port's chain (``PendingDwConv`` in a
  ``DeferredEpilogue``; ``fold_quantize`` for codes, ``materialize`` for
  f32), equals JAX's integer path exactly: the codes padded with a
  nonzero pad code (``jnp.pad``), the int32 ``conv_general_dilated`` at
  ``feature_group_count = C``, then JAX's ``chain.fold_quantize`` or
  ``chain.materialize`` on the same scales and grid.  Strides 1 and 2,
  pad 1 and flax's SAME, odd and even maps, C ∈ {16, 48, 144}, no clamp,
  a ReLU and a ReLU6 (``clamp_hi``).  Exact: the int8 inputs and the
  float32 epilogue inputs are equal (ROADMAP hazard C2).  The same for
  the 5×5 window and for any C (GhostNet's and EfficientNet's): k ∈ {3,
  5}, every pad form the kernel takes (k // 2 at strides 1 and 2, SAME
  on even and odd maps), C ∈ {1, 3, 6, 12, 18, 20, 36, 92, 100, 672}; at
  W4 the plain version equals itself at W8 on the same values.
* The packing round-trips (at 5×5 too); the wrapper raises on what
  neither route takes (a stride, a pad form or a window the kernel has
  not, a weight of another shape); a C off the aligned granule (C % 8)
  takes the ragged path, whose plan and staging granule :func:`route`
  and :func:`check_kernel` give, and the kernel refuses a tile count past
  32 bits; a depthwise ``QConv`` fed codes on a producer's grid (a
  ``QuantizedTensor``) re-derives its epilogue from per-channel column
  sums over the nine taps and equals an f32 conv of the dequantized codes.
* ``cuda``-marked tests hold the kernel against its plain version on the
  card (tolerance 0) at MobileNetV2's and MobileOne-S1's depthwise shapes
  at batch 8 and 256, at ragged sizes (C = 8, 24 and 40 among them) and
  on plans other than ``plan()``'s; the 5×5 window and the ragged path
  at every case of the CPU tests (W8 and W4, with and without a weight
  offset's term), at GhostNet-1.0's and EfficientNet-B0's depthwise
  shapes at batch 8 and on forced small tiles; every instantiation of the
  wide build (both windows and strides, codes with and without a clamp,
  f32 with and without the ReLU, the term, W8 and W4, row runs and byte
  staging) and the row runs from codes 4, 8 and 12 bytes past a 16-byte
  boundary; they count their launches by window and path; they skip
  here:
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


# any window and C: GhostNet's cheap convs (C = 12, 20, 36, 60, 92, 100 at
# width 1.0, 18 at 0.5), EfficientNet's 5x5 convs, odd and tiny C
WIDE_C = [1, 3, 6, 12, 18, 20, 36, 92, 100, 672]
# (stride, padding, h, w): k // 2 explicit at both strides, and flax's SAME
# at stride 1 and at stride 2 on an even and an odd map
WIDE_GEOMETRIES = [(1, "half", 7, 9), (2, "half", 8, 8), (1, "SAME", 6, 5),
                   (2, "SAME", 8, 6), (2, "SAME", 7, 9)]


def _wide_pads(k, h, w, stride, padding):
    return QConv(4, 4, k, stride, k // 2 if padding == "half" else padding,
                 groups=4).spatial_pads(h, w)


@pytest.mark.parametrize("c", WIDE_C)
@pytest.mark.parametrize("k", D.WINDOWS)
def test_plain_on_the_chain_equals_jax_any_window_and_c(k, c):
    """The plain version through ``PendingDwConv`` at window k and any C
    equals JAX's grouped int32 conv + fold_quantize / materialize at every
    pad form the kernel takes; at W4 it equals itself at W8."""
    import jax.numpy as jnp
    from dlmc_quant_tpu.quant import chain as jchain
    for stride, padding, h, w in WIDE_GEOMETRIES:
        rng = np.random.default_rng(k * 1000 + c * 10 + stride)
        x = rng.integers(-128, 128, (2, h, w, c), dtype=np.int8)
        wk = rng.integers(-128, 128, (k, k, 1, c), dtype=np.int8)
        scale = (rng.random(c, dtype=np.float32) * 2e-3 + 1e-4)
        bias = rng.standard_normal(c).astype(np.float32) * 3
        pads = _wide_pads(k, h, w, stride, padding)
        assert pads[0][0] in D.pad_los(k, stride)
        acc = _jax_acc(x, wk, stride, pads)
        jde = jchain.DeferredEpilogue(acc, jnp.asarray(scale),
                                      jnp.asarray(bias), relu=True)
        wp = D.pack_weight(torch.from_numpy(wk))
        pending = PendingDwConv(torch.from_numpy(x), wp, stride, PAD,
                                pads[0][0])
        assert pending.kernel == k and wp.shape == (k * k, c)
        de = DeferredEpilogue(pending, torch.from_numpy(scale),
                              torch.from_numpy(bias), relu=True)
        want = np.asarray(jchain.fold_quantize(
            jde, jnp.float32(INV_S), jnp.float32(QBIAS), QMIN_S, QMAX_S))
        got = chain.fold_quantize(de, float(np.float32(INV_S)),
                                  float(np.float32(QBIAS)), QMIN_S, QMAX_S)
        assert got.shape == (2, -(-h // stride), -(-w // stride), c)
        assert np.array_equal(got.numpy(), want), (stride, padding)
        assert np.array_equal(chain.materialize(de).numpy(),
                              np.asarray(jchain.materialize(jde)))
        w4 = torch.from_numpy(wk // 16)          # in [-8, 7]
        kw = dict(stride=stride, pad=PAD, pad_lo=pads[0][0], mode="f32")
        a, b = torch.from_numpy(scale), torch.from_numpy(bias)
        assert torch.equal(
            D.int8_dwconv3x3(torch.from_numpy(x), D.pack_weight_int4(w4), a,
                             b, **kw),
            D.int8_dwconv3x3(torch.from_numpy(x), D.pack_weight(w4), a, b,
                             **kw))


def test_pack_weight_round_trip():
    wk = torch.randint(-128, 128, (3, 3, 1, 48), dtype=torch.int8)
    wp = D.pack_weight(wk)
    assert wp.shape == (9, 48) and wp.is_contiguous()
    assert torch.equal(wp[3 * 2 + 1], wk[2, 1, 0])
    assert torch.equal(D.unpack_weight(wp), wk)
    wk5 = torch.randint(-8, 8, (5, 5, 1, 19), dtype=torch.int8)
    wp5 = D.pack_weight_int4(wk5)
    assert wp5.shape == (25, 10) and D.window(wp5) == 5
    assert torch.equal(D.unpack_weight(wp5, 19), wk5)
    assert torch.equal(D.pack_weight(wk5)[5 * 3 + 4], wk5[3, 4, 0])


@pytest.mark.parametrize("bad", ["channels", "stride", "pad_lo", "weight",
                                 "pad", "epilogue", "window", "pad_lo_5x5"])
def test_raises(bad):
    c = 20 if bad == "channels" else 32
    x = torch.zeros((1, 6, 6, c), dtype=torch.int8)
    w = torch.zeros((9, 16 if bad == "weight" else c), dtype=torch.int8)
    a, b = torch.ones(c), torch.zeros(c)
    kw = dict(stride=3 if bad == "stride" else 1, pad=300 if bad == "pad"
              else 0, pad_lo=0 if bad == "pad_lo" else 1)
    if bad == "window":           # a 7x7 window: no kernel, no plain path
        w = torch.zeros((49, c), dtype=torch.int8)
    if bad == "pad_lo_5x5":       # 5x5 at stride 1 pads 2 at the top
        w = torch.zeros((25, c), dtype=torch.int8)
    if bad == "epilogue":
        kw["relu"] = True          # codes fold the ReLU into lo
    if bad == "channels":
        # a C off the aligned path's granule takes the ragged path on the
        # CUDA route (4-byte granules at C % 4 == 0, whole quads a slice);
        # the plain version takes C = 20 as it is
        assert D.route(x, w) == 4
        p = D.check_kernel(x, w, 1)
        assert (p.cb, p.granule, p.slices) == (20, 4, 1)
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
    """Groupings other than the depthwise 3×3 take their own routes, each
    equal to its plain version: a grouped 3×3 (1 < groups < C, RepVGG's
    g2/g4) runs the conv kernel's grouped tiles; a depthwise 1×1
    (MobileOne's scale branch) the depthwise kernel's 1×1 window, and a
    grouped 5×5 an im2col and an int32 GEMM a group, each against a
    float64 grouped conv of the layer's input codes with its epilogue."""
    from dlmc_quant_torch.ops.cuda.epilogue import epilogue_plain
    from dlmc_quant_torch.quant.chain import PendingWideConv
    conv = QConv(32, 32, 3, 1, 1, groups=2)
    attach_scheme(conv, scheme_from_dict(SCHEME))
    x = torch.rand((1, 6, 6, 32))
    calibrate(conv, [x])
    prepare_deploy(conv)
    assert not hasattr(conv, "w_dw")
    assert conv(x, qmode="intc").acc.groups == 2
    for k, groups in ((1, 32), (5, 2)):
        conv = QConv(32, 32, k, 1, k // 2, groups=groups)
        attach_scheme(conv, scheme_from_dict(SCHEME))
        calibrate(conv, [x])
        prepare_deploy(conv)
        assert hasattr(conv, "w_dw") == (k == 1)
        with torch.no_grad():
            de = conv(x, qmode="intc")
            assert isinstance(de.acc, PendingDwConv if k == 1
                              else PendingWideConv)
            got = chain.materialize(de)
            assert torch.equal(conv(x, qmode="int"), got)
            xp = torch.nn.functional.pad(
                conv._input_codes(x).permute(0, 3, 1, 2).double(),
                (k // 2,) * 4, value=float(conv.plan_scalars["pad_val"]))
            acc = torch.nn.functional.conv2d(xp, conv.w_int.double(),
                                             groups=groups)
            want = epilogue_plain(acc.permute(0, 2, 3, 1), conv.epi_scale,
                                  conv.bias_eff, mode="f32")
        assert torch.equal(got, want), (k, groups)


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


def test_kernel_refuses_what_it_cannot_take():
    """No fallback: past 32 bits of tiles the CUDA route's check raises
    (shapes on the meta device: nothing is allocated), and the library of
    the aligned 3x3 path holds no 5x5 or ragged instantiation."""
    for k, c in ((3, 16), (5, 16), (3, 20)):
        x = torch.empty((2 ** 24, 1024, 1024, c), dtype=torch.int8,
                        device="meta")
        w = torch.empty((k * k, c), dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match=r"too many tiles"):
            D.check_kernel(x, w, 1)
    assert D.library_name(3, 0) == "int8_dwconv3x3"
    assert {D.library_name(3, 4), D.library_name(3, 1),
            D.library_name(5, 0), D.library_name(5, 1)} == {"int8_dwconv5x5"}


def _wide_operands(n, h, w, c, k, w4, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, (n, h, w, c), generator=g,
                      dtype=torch.int8)
    lo, hi = (-8, 8) if w4 else (-128, 128)
    wk = torch.randint(lo, hi, (k, k, 1, c), generator=g, dtype=torch.int8)
    wp = (D.pack_weight_int4 if w4 else D.pack_weight)(wk)
    a = torch.rand(c, generator=g) * 1e-3 + 1e-5
    b = torch.randn(c, generator=g) * 4
    oc = torch.randn(c, generator=g) * 1e-3
    return [t.to(dev) for t in (x, wp, a, b, oc)]


def _wide_vs_plain(n, h, w, c, k, stride, pad_lo, w4, term, seed,
                   modes=None, **over):
    dev = _card()
    x, wp, a, b, oc = _wide_operands(n, h, w, c, k, w4, dev, seed)
    offset = oc if term else None
    for kw in modes or (dict(mode="codes", lo=-3, hi=90),
                        dict(mode="f32", relu=True)):
        got = D.int8_dwconv3x3(x, wp, a, b, stride=stride, pad=-11,
                               pad_lo=pad_lo, offset=offset, **kw, **over)
        torch.cuda.synchronize()
        want = D.int8_dwconv3x3_plain(x, wp, a, b, stride=stride, pad=-11,
                                      pad_lo=pad_lo, offset=offset, **kw)
        assert torch.equal(got, want), (kw, k, c, stride, pad_lo, w4, term)


@pytest.mark.cuda
@pytest.mark.parametrize("c", WIDE_C)
@pytest.mark.parametrize("k", D.WINDOWS)
def test_kernel_matches_plain_any_window_and_c(k, c):
    """Every geometry of the CPU tests, at W8 and W4, with and without a
    weight offset's term: the 5x5 window on either path, the 3x3 window on
    the ragged one where C % 8 != 0."""
    for i, (stride, padding, h, w) in enumerate(WIDE_GEOMETRIES):
        pad_lo = _wide_pads(k, h, w, stride, padding)[0][0]
        for w4 in (False, True):
            for term in (False, True):
                _wide_vs_plain(3, h, w, c, k, stride, pad_lo, w4, term,
                               seed=100 * k + c + i)


# the depthwise convs of GhostNet-1.0 and EfficientNet-B0 at 224² that the
# 3x3 aligned path does not take: (h, w, c, k, stride, pad_lo)
GHOST_EFFNET = [(56, 56, 12, 3, 1, 1), (56, 56, 36, 3, 1, 1),
                (28, 28, 20, 3, 1, 1), (28, 28, 60, 3, 1, 1),
                (14, 14, 92, 3, 1, 1), (14, 14, 100, 3, 1, 1),
                (56, 56, 72, 5, 2, 2), (56, 56, 24, 5, 2, 2),
                (14, 14, 672, 5, 2, 2), (14, 14, 112, 5, 2, 2),
                (56, 56, 144, 5, 2, 2), (28, 28, 240, 5, 1, 2),
                (14, 14, 480, 5, 1, 2), (14, 14, 672, 5, 1, 2),
                (7, 7, 1152, 5, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GHOST_EFFNET,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_ghost_effnet_shapes(shape):
    h, w, c, k, stride, pad_lo = shape
    _wide_vs_plain(8, h, w, c, k, stride, pad_lo, False, False, seed=c + h,
                   modes=(dict(mode="codes", lo=-3, hi=90), dict(mode="codes"),
                          dict(mode="f32", relu=True), dict(mode="f32")))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(3, 13, 11, 24, 5, 1, 2, (32, 2, 2, 3)),
                                  (2, 12, 9, 96, 5, 2, 1, (64, 2, 1, 2)),
                                  (2, 13, 11, 20, 3, 1, 1, (8, 2, 2, 3)),
                                  (2, 12, 9, 18, 5, 2, 2, (8, 2, 1, 2)),
                                  (3, 9, 16, 100, 3, 2, 0, (32, 3, 3, 1))],
                         ids=["5x5_s1_c24", "5x5_s2_c96_cb64_tail",
                              "ragged_s1_c20", "ragged_5x5_s2_c18",
                              "ragged_s2_c100_cb32_tail"])
def test_kernel_matches_plain_wide_on_other_plans(case):
    """Plans other than plan()'s: small tiles, so that a block walks many
    (both halo buffers), masked tail slices on either path."""
    n, h, w, c, k, stride, pad_lo, override = case
    _wide_vs_plain(n, h, w, c, k, stride, pad_lo, False, True, seed=c,
                   _plan=override)


# every instantiation of the wide build: (k, C, granule) with the path each
# takes: the 5x5 window aligned (C = 24), row runs (C = 20), byte staging (C
# = 18); the 3x3 window's ragged path by runs and by bytes
WIDE_BUILD = [(5, 24, 0), (5, 20, 4), (5, 18, 1), (3, 20, 4), (3, 18, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("term", [False, True], ids=["bare", "term"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("build", WIDE_BUILD,
                         ids=lambda b: f"k{b[0]}_c{b[1]}_g{b[2]}")
def test_kernel_every_wide_instantiation(build, stride, term):
    """Each stride, mode (codes clamped and not, f32 with and without the
    ReLU) and term of the wide build on each of its paths, W8 and W4."""
    k, c, granule = build
    dev = _card()
    for w4 in (False, True):
        x, wp = _wide_operands(2, 11, 13, c, k, w4, dev, 0)[:2]
        assert D.route(x, wp) == granule
        _wide_vs_plain(2, 11, 13, c, k, stride, k // 2 - (stride - 1),
                       w4, term, seed=c + 7 * k + stride,
                       modes=(dict(mode="codes", lo=-3, hi=90),
                              dict(mode="codes"), dict(mode="f32"),
                              dict(mode="f32", relu=True)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", D.WINDOWS)
def test_kernel_row_runs_at_every_offset(k):
    """Codes 4, 8 and 12 bytes past a 16-byte boundary (views into a
    larger buffer) at C = 12 and 36: the row runs' shift in every tile."""
    dev = _card()
    for c, off in ((12, 4), (12, 8), (36, 12), (36, 4)):
        x, wp, a, b, oc = _wide_operands(3, 15, 17, c, k, False, dev, off)
        view = torch.empty(x.numel() + off, dtype=torch.int8,
                           device=dev)[off:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 == off and D.route(view, wp) == 4
        for stride in (1, 2):
            for kw in (dict(mode="codes"), dict(mode="f32", relu=True)):
                want = D.int8_dwconv3x3_plain(x, wp, a, b, stride=stride,
                                              pad=5, offset=oc, **kw)
                got = D.int8_dwconv3x3(view, wp, a, b, stride=stride, pad=5,
                                       offset=oc, **kw)
                assert torch.equal(got, want), (c, off, stride, kw)


@pytest.mark.cuda
def test_kernel_takes_codes_off_the_aligned_path():
    """C % 8 == 0 codes that are not 16-byte aligned (a view one pixel in)
    take the ragged path, byte-staged."""
    dev = _card()
    x, wp, a, b, _ = _wide_operands(2, 9, 10, 16, 3, False, dev, 5)
    view = torch.empty(2 * 9 * 10 * 16 + 1, dtype=torch.int8,
                       device=dev)[1:].view(2, 9, 10, 16)
    view.copy_(x)
    assert D.route(view, wp) == 1 and D.route(x, wp) == 0
    before = D.int8_dwconv3x3.launches_ragged
    for kw in (dict(mode="codes"), dict(mode="f32")):
        got = D.int8_dwconv3x3(view, wp, a, b, stride=1, pad=3, **kw)
        assert torch.equal(got, D.int8_dwconv3x3_plain(x, wp, a, b, stride=1,
                                                       pad=3, **kw))
    assert D.int8_dwconv3x3.launches_ragged == before + 2


@pytest.mark.cuda
def test_kernel_counts_its_launches():
    dev = _card()
    x, wp, a, b = _card_operands(2, 9, 9, 32, dev, 1)
    before = D.int8_dwconv3x3.launches
    D.int8_dwconv3x3(x, wp, a, b, stride=1, pad=0)
    D.int8_dwconv3x3_plain(x, wp, a, b, stride=1, pad=0)
    assert D.int8_dwconv3x3.launches == before + 1
    counts = (D.int8_dwconv3x3.launches, D.int8_dwconv3x3.launches_5x5,
              D.int8_dwconv3x3.launches_ragged)
    x5, wp5, a5, b5, _ = _wide_operands(2, 9, 9, 20, 5, False, dev, 2)
    D.int8_dwconv3x3(x5, wp5, a5, b5, stride=2, pad=0)
    D.int8_dwconv3x3(x5, wp5[:9].contiguous(), a5, b5, stride=1, pad=0)
    assert (D.int8_dwconv3x3.launches, D.int8_dwconv3x3.launches_5x5,
            D.int8_dwconv3x3.launches_ragged) == (counts[0] + 2,
                                                  counts[1] + 1,
                                                  counts[2] + 2)

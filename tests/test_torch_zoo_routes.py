"""The zoo's last integer routes against the JAX package: every geometry
that JAX's ``QConv._int_conv`` computes (one grouped
``conv_general_dilated``) has a route on the port's kernels.

* MobileOne's train form in ``int`` (and ``intc``, which the train form
  runs as ``int``), S0-shaped (4 conv branches) and S1-shaped (1) toys with
  one block a stage and narrow widths, 32×32: its depthwise blocks' 1×1
  scale branches run the depthwise kernel's 1×1 window.  The logits within
  relative L2 2e-2 of JAX's jitted ``int`` (C2: a code flipped at a tie
  moves the layers after it), and every scale branch fed JAX's own input
  (the output of the block before it in that forward) equal to JAX's eager
  ``int`` of the branch exactly (the same int32 accumulator, the same two
  float32 ops).
* A grouped 3×3 and a grouped 1×1 (RepVGG's g2/g4 deploy form and the
  train form's ``rbr_1x1``) with a weight offset, RootQ bounds spread
  (W4A4, and W8A8 on the 3×3s) and an LSQ per-channel ``wt_offset`` (W8A8,
  on the unpadded 1×1s: a padded conv pads with the zero code, whose real
  value on LSQ's offset input grid is not JAX's pad of 0): ``int`` and ``intc``
  equal the port's plain path computed here (a float64 grouped conv of
  the input codes, float64 window sums per group and
  :func:`.epilogue.epilogue_plain`) exactly, and JAX's ``eval`` within
  ``tests/test_torch_rootq_int.py``'s 1e-5 (JAX's ``int`` drops ``o_w``,
  hazard C1).
* Each other geometry: a grouped 5×5, a padded 1×1 (grouped too), a 3×3
  at VALID and at pad 2, a grouped 3×3 at SAME and stride 2 on a map whose
  height and width differ in parity (pads (0, 1) and (1, 1): not the conv
  kernel's one top/left pad), a grouped 3×3 of one input channel a group, a
  depthwise 3×3 at VALID, a depthwise 5×5 at pad 1, a padded depthwise
  1×1 and a depthwise 3×3 at stride 3, and past ``int8_im2col.MAX_KP`` =
  2,048 bytes of K a group (a 5×5 at C = 96, a VALID 3×3 at C = 240, a
  grouped 7×7 at Cg = 48, a 5×5 at C = 97 whose last run of channels is
  padded): ``int`` equal to JAX's ``int`` exactly (the epilogue's inputs
  are the same float32 values), ``intc`` to ``int``, and the launches
  each makes (a past-2,048 group: an im2col and a GEMM a run of
  channels).
* The window sums per group against a float64 numpy reference.
* ``cuda``-marked tests (skipped here) hold the three kernels this slice
  changed against their plain versions at tolerance 0: the depthwise
  kernel's 1×1 window at strides 1 and 2 on the aligned (granules of 16
  and 8) and ragged (4 and 1) paths, W8 and W4, codes, f32 and the term,
  and with pads passed in; ``int8_window_sum`` at G = 2 and 4; and the
  grouped conv's row term at RepVGG-B2g4's shapes:
  ``python -m pytest --noconftest tests/test_torch_zoo_routes.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dlmc_quant_torch.models.mobileone import MobileOne
from dlmc_quant_torch.ops.cuda import int8_conv as K
from dlmc_quant_torch.ops.cuda import int8_dwconv as D
from dlmc_quant_torch.ops.cuda import int8_gemm as G
from dlmc_quant_torch.ops.cuda import int8_window_sum as WS
from dlmc_quant_torch.ops.cuda.epilogue import epilogue_plain
from dlmc_quant_torch.ops.cuda.nibbles import W4
from dlmc_quant_torch.quant.chain import (PendingDwConv, PendingWideConv,
                                          materialize)
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import QConv, attach_scheme
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables
from dlmc_quant_torch.utils.launches import LaunchRecorder
from test_torch_rootq_int import (_jax, _jax_eval, _launches, _np, _rel,
                                  _scheme, _snap, _spread)

torch.set_num_threads(1)

FSPTQ = {"quantization_type": "FSPTQ",
         "weight": {"enable": True, "type": "minmax_channel",
                    "args": {"n_bits": 8, "signed": True}},
         "input": {"enable": True, "type": "minmax_tensor",
                   "args": {"n_bits": 8, "signed": False}}}
SIZE, BATCH = 32, 2
MOBILEONE = {"S0": dict(num_blocks=(1, 1, 1, 1),
                        width_multipliers=(0.25, 0.25, 0.25, 0.25),
                        num_conv_branches=4, num_classes=10),
             "S1": dict(num_blocks=(1, 1, 1, 1),
                        width_multipliers=(0.375, 0.375, 0.5, 0.625),
                        num_conv_branches=1, num_classes=10)}


def _images(seed, shape=(BATCH, SIZE, SIZE, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# ------------------------------------------------- MobileOne's train form

@pytest.fixture(scope="module", params=list(MOBILEONE))
def mobileone(request):
    """JAX's train form (its variables from ``jax.eval_shape`` with
    numpy-seeded leaves), its calibration, its prepare_deploy and its
    jitted ``int`` forward of seeded images, whose block outputs give each
    scale branch its input, and each scale branch's own eager ``int`` on
    that input (eager: XLA's jit may contract the epilogue into an fma);
    the port's twin on the same variables, prepared."""
    from dlmc_quant_tpu.models.mobileone import MobileOne as JMobileOne
    from test_torch_ghostnet import variables
    J = _jax()
    jax, jnp = J["jax"], J["jnp"]
    kw = MOBILEONE[request.param]
    scheme = J["scheme"](FSPTQ)
    jm = JMobileOne(**kw, scheme=scheme)
    v_cal = J["calibrate"](jm, variables(jm, SIZE, 1),
                           [jnp.asarray(_images(0)), jnp.asarray(_images(1))])
    x = _images(3)
    jv = J["dp"].prepare_deploy(jm, v_cal, sample_input=jnp.asarray(x))
    want, inter = jax.jit(lambda v, x: jm.apply(
        v, x, qmode="int", capture_intermediates=True))(jv, jnp.asarray(x))
    port = prepare_deploy(load_jax_variables(
        MobileOne(**kw, scheme=port_scheme(FSPTQ)).eval(), _np(v_cal)))
    inter = inter["intermediates"]
    seen, x_in = {}, x
    for name in port.block_names:
        block = getattr(port, name)
        if hasattr(block, "scale_branch"):
            m = block.scale_branch
            jl = J["QConv"](m.weight.shape[0], (1, 1), (m.stride,) * 2,
                            padding="VALID", feature_group_count=m.groups,
                            use_bias=False, scheme=scheme)
            sub = {col: tree[name]["scale_branch"] for col, tree in
                   jv.items() if name in tree
                   and "scale_branch" in tree[name]}
            seen[f"{name}.scale_branch"] = (
                np.asarray(x_in), np.asarray(jl.apply(
                    sub, jnp.asarray(x_in), qmode="int")))
        x_in = inter[name]["__call__"][0]
    return dict(name=request.param, port=port, x=x, want=np.asarray(want),
                seen=seen)


def test_mobileone_train_form_int_matches_jax(mobileone):
    """``int`` and ``intc`` on the port's routes against JAX's ``int``; one
    1×1 depthwise launch a depthwise block (its scale branch)."""
    port, x = mobileone["port"], torch.from_numpy(mobileone["x"])
    with torch.no_grad(), LaunchRecorder() as rec:
        got = port(x, qmode="int")
        assert torch.equal(port(x, qmode="intc"), got)
    windows = [D.window(args[1]) for kind, args, _, _ in rec.calls
               if kind == "dwconv"]
    blocks = sum(port.num_blocks)
    assert windows.count(1) == 2 * blocks      # two forwards
    assert got.shape == (BATCH, 10) and bool(torch.isfinite(got).all())
    assert _rel(got, mobileone["want"]) <= 2e-2, mobileone["name"]


def test_mobileone_scale_branches_exact_on_jax_input(mobileone):
    """Every scale branch (the stem's ungrouped 1×1 on the GEMM, the
    depthwise blocks' on the 1×1 window) fed JAX's input equals JAX's
    output."""
    port, seen = mobileone["port"], mobileone["seen"]
    assert len(seen) == 1 + sum(port.num_blocks)
    depthwise = 0
    for path, (x_in, want) in seen.items():
        m = port.get_submodule(path)
        depthwise += m.depthwise
        with torch.no_grad():
            got = m(torch.from_numpy(np.array(x_in)), qmode="int")
        assert np.array_equal(got.numpy(), want), path
    assert depthwise == sum(port.num_blocks)


# ------------------------------------------- a grouped conv's weight offset

# name → (JAX layer, port layer, input shape, launches of a forward)
GROUPED = {
    "grouped3x3_g2": (
        lambda J, s: J["QConv"](20, (3, 3), (1, 1), feature_group_count=2,
                                scheme=s),
        lambda: QConv(20, 20, 3, 1, "SAME", groups=2), (2, 7, 8, 20),
        dict(conv=1, window_sum=1)),
    "grouped3x3_g4_s2": (
        lambda J, s: J["QConv"](40, (3, 3), (2, 2), feature_group_count=4,
                                scheme=s),
        lambda: QConv(40, 40, 3, 2, "SAME", groups=4), (2, 10, 8, 40),
        dict(conv=1, window_sum=1)),
    "grouped1x1_g4": (
        lambda J, s: J["QConv"](40, (1, 1), (1, 1), feature_group_count=4,
                                scheme=s),
        lambda: QConv(40, 40, 1, 1, "SAME", groups=4), (2, 6, 7, 40),
        dict(gemm=4, window_sum=1)),
    "grouped1x1_g2_s2": (
        lambda J, s: J["QConv"](24, (1, 1), (2, 2), feature_group_count=2,
                                scheme=s),
        lambda: QConv(20, 24, 1, 2, "SAME", groups=2), (2, 7, 6, 20),
        dict(gemm=2, window_sum=1)),
}


def grouped_pair(name, family, bits, seed):
    """A grouped layer in both packages on JAX's calibrated variables
    (RootQ bounds spread, or an LSQ per-channel weight offset set), the
    port's prepared; the input a quarter step from every rounding tie."""
    J = _jax()
    jnp = J["jnp"]
    make_jax, make_port, shape, _ = GROUPED[name]
    rng = np.random.default_rng(seed)
    x0 = rng.random(shape, dtype=np.float32) * 3.0 - 0.5
    sd = _scheme(family, bits)
    jl = make_jax(J, J["scheme"](sd))
    v = J["jax"].jit(jl.init)(J["jax"].random.PRNGKey(seed),
                              jnp.asarray(x0))
    v = _np(J["calibrate"](jl, v, [jnp.asarray(x0)]))
    v["params"]["bias"] = rng.normal(
        0, 0.1, v["params"]["bias"].shape).astype(np.float32)
    qs = v["qstate"]
    if family == "rootq":
        _spread(v, rng)
        x = _snap(x0, qs["in_run_scale"], np.float32(0.0), rng)
    else:
        s_w = v["params"]["wt_scale"]
        qs["wt_offset"] = (rng.uniform(-0.5, 0.5, s_w.shape) * s_w) \
            .astype(np.float32)
        x = _snap(x0, v["params"]["in_scale"], qs["in_offset"], rng)
    pl = attach_scheme(make_port(), port_scheme(sd))
    load_jax_variables(pl, v)
    pl.prepare_deploy()
    return J, jl, v, pl, x


def int_weight(pl) -> torch.Tensor:
    """A prepared conv's int8 OIHW weight, unpacked from its kernel's
    layout at W4."""
    c, o, g, k = (pl.weight.shape[1] * pl.groups, pl.weight.shape[0],
                  pl.groups, pl.kernel_size)
    if hasattr(pl, "w_int"):
        return pl.w_int
    if hasattr(pl, "w_packed"):
        return K.unpack_weight(pl.w_packed, c, o, g).permute(3, 2, 0, 1)
    w = G.unpack_b(pl.w_gemm, k * k * (c // g))      # (G, K, Og)
    return w.reshape(g, k, k, c // g, o // g).permute(0, 4, 3, 1, 2) \
        .reshape(o, c // g, k, k)


def plain_path(pl, x: torch.Tensor) -> torch.Tensor:
    """The port's plain path of a prepared conv in float64: the grouped
    conv of its input codes, the window sums of the codes less the zero
    code per group, then the shared epilogue in f32 mode."""
    codes = pl._input_codes(x)
    pad = pl.plan_scalars["pad_val"]
    (top, bottom), (left, right) = pl.spatial_pads(*codes.shape[1:3])
    xp = F.pad(codes.permute(0, 3, 1, 2).double(), (left, right, top, bottom),
               value=float(pad))
    g, k, s = pl.groups, pl.kernel_size, pl.stride
    acc = F.conv2d(xp, int_weight(pl).double(), stride=s, groups=g)
    row = None
    if hasattr(pl, "w_offset"):
        ones = torch.ones((g, codes.shape[-1] // g, k, k),
                          dtype=torch.float64)
        sums = F.conv2d(xp - pad, ones, stride=s, groups=g)
        sums = sums.permute(0, 2, 3, 1)
        row = (sums if g > 1 else sums[..., 0], pl.off_scale)
    return epilogue_plain(acc.permute(0, 2, 3, 1), pl.epi_scale,
                          pl.bias_eff, mode="f32", row=row)


# RootQ at W4A4 everywhere; an LSQ offset on the 1x1s and RootQ W8A8 on
# the 3x3s: a padded integer conv pads with the zero code, whose real value
# on LSQ's offset input grid is not exactly JAX's pad of 0 (a border
# difference of every padded conv there, grouped or not)
GROUPED_CASES = [(name, fam, bits) for name in GROUPED
                 for fam, bits in (("rootq", 4),
                                   ("lsq", 8) if "1x1" in name
                                   else ("rootq", 8))]


@pytest.mark.parametrize("name,family,bits", GROUPED_CASES,
                         ids=[f"{n}-{f}-w{b}a{b}"
                              for n, f, b in GROUPED_CASES])
def test_grouped_offset_matches_plain_and_jax_eval(name, family, bits):
    J, jl, v, pl, x = grouped_pair(name, family, bits,
                                   seed=bits + len(name))
    assert bool((pl.w_offset != 0).any())
    xt = torch.from_numpy(x)
    with torch.no_grad():
        with LaunchRecorder() as rec:
            got = pl(xt, qmode="int")
        got_c = materialize(pl(xt, qmode="intc"))
        want = plain_path(pl, xt)
    assert rec.counts() == _launches(**GROUPED[name][3])
    sums = [out for kind, _, _, out in rec.calls if kind == "window_sum"]
    assert sums[0].shape[-1] == pl.groups      # one sum a group
    assert torch.equal(got, want) and torch.equal(got_c, want)
    ref = _jax_eval(J, jl, v, x, False)
    assert _rel(got, ref) <= 1e-5 and _rel(got_c, ref) <= 1e-5


# ------------------------------------------------- the other geometries

def _dw(c, k, s, pad, jpad):
    return (lambda J, sc: J["QConv"](c, (k, k), (s, s), padding=jpad,
                                     feature_group_count=c, scheme=sc),
            lambda: QConv(c, c, k, s, pad, groups=c))


# name → (JAX layer, port layer, input shape, launches of a forward)
GEOMETRIES = {
    "grouped5x5_g2": (
        lambda J, s: J["QConv"](16, (5, 5), (1, 1), feature_group_count=2,
                                padding=((2, 2), (2, 2)), scheme=s),
        lambda: QConv(16, 16, 5, 1, 2, groups=2), (2, 9, 8, 16),
        dict(im2col=2, gemm=2)),
    "grouped5x5_g4_s2_same": (
        lambda J, s: J["QConv"](24, (5, 5), (2, 2), feature_group_count=4,
                                scheme=s),
        lambda: QConv(16, 24, 5, 2, "SAME", groups=4), (2, 10, 9, 16),
        dict(im2col=4, gemm=4)),
    "padded1x1": (
        lambda J, s: J["QConv"](20, (1, 1), (1, 1),
                                padding=((1, 1), (1, 1)), scheme=s),
        lambda: QConv(12, 20, 1, 1, 1), (2, 6, 7, 12),
        dict(im2col=1, gemm=1)),
    "padded1x1_g2_s2": (
        lambda J, s: J["QConv"](16, (1, 1), (2, 2), feature_group_count=2,
                                padding=((1, 1), (1, 1)), scheme=s),
        lambda: QConv(12, 16, 1, 2, 1, groups=2), (2, 7, 6, 12),
        dict(im2col=2, gemm=2)),
    "conv3x3_valid": (
        lambda J, s: J["QConv"](16, (3, 3), (1, 1), padding="VALID",
                                scheme=s),
        lambda: QConv(8, 16, 3, 1, 0), (2, 9, 8, 8),
        dict(im2col=1, gemm=1)),
    "conv3x3_pad2_s2": (
        lambda J, s: J["QConv"](16, (3, 3), (2, 2),
                                padding=((2, 2), (2, 2)), scheme=s),
        lambda: QConv(8, 16, 3, 2, 2), (2, 9, 8, 8),
        dict(im2col=1, gemm=1)),
    "grouped3x3_s2_same_mixed_parity": (
        lambda J, s: J["QConv"](16, (3, 3), (2, 2), feature_group_count=2,
                                scheme=s),
        lambda: QConv(16, 16, 3, 2, "SAME", groups=2), (2, 10, 9, 16),
        dict(im2col=2, gemm=2)),
    "grouped3x3_cg1": (
        lambda J, s: J["QConv"](16, (3, 3), (1, 1), feature_group_count=8,
                                scheme=s),
        lambda: QConv(8, 16, 3, 1, "SAME", groups=8), (2, 7, 6, 8),
        dict(im2col=8, gemm=8)),
    "depthwise3x3_valid": _dw(24, 3, 1, 0, "VALID") + (
        (2, 9, 8, 24), dict(dwconv=1)),
    "depthwise5x5_pad1_s2": _dw(20, 5, 2, 1, ((1, 1), (1, 1))) + (
        (2, 11, 10, 20), dict(dwconv=1)),
    "depthwise1x1_pad1": _dw(24, 1, 1, 1, ((1, 1), (1, 1))) + (
        (2, 6, 7, 24), dict(dwconv=1)),
    "depthwise1x1_s2_valid": _dw(12, 1, 2, 0, "VALID") + (
        (2, 7, 6, 12), dict(dwconv=1)),
    "depthwise3x3_s3": _dw(8, 3, 3, 1, ((1, 1), (1, 1))) + (
        (2, 10, 11, 8), dict(im2col=8, gemm=8)),
    # past int8_im2col.MAX_KP = 2,048 bytes of K a group: runs of channels,
    # a launch pair a run, the int32 accumulators summed
    "conv5x5_c96_chunked": (
        lambda J, s: J["QConv"](16, (5, 5), (1, 1),
                                padding=((2, 2), (2, 2)), scheme=s),
        lambda: QConv(96, 16, 5, 1, 2), (2, 6, 5, 96),
        dict(im2col=2, gemm=2)),
    "conv3x3_valid_c240_chunked": (
        lambda J, s: J["QConv"](24, (3, 3), (1, 1), padding="VALID",
                                scheme=s),
        lambda: QConv(240, 24, 3, 1, 0), (2, 5, 6, 240),
        dict(im2col=2, gemm=2)),
    "grouped7x7_cg48_chunked": (
        lambda J, s: J["QConv"](32, (7, 7), (2, 2), feature_group_count=2,
                                padding=((3, 3), (3, 3)), scheme=s),
        lambda: QConv(96, 32, 7, 2, 3, groups=2), (2, 9, 8, 96),
        dict(im2col=4, gemm=4)),
    "conv5x5_c97_chunked_uneven": (
        lambda J, s: J["QConv"](8, (5, 5), (2, 2), padding="VALID",
                                scheme=s),
        lambda: QConv(97, 8, 5, 2, 0), (2, 7, 8, 97),
        dict(im2col=2, gemm=2)),
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_geometry_int_matches_jax_int(name):
    """The port's ``int`` equals JAX's ``int`` (its integer plan: the same
    codes, accumulator, scale and bias), ``intc`` equals ``int``; the
    depthwise convs whose pads the kernel's default does not give pass
    them in."""
    J = _jax()
    jnp = J["jnp"]
    make_jax, make_port, shape, launches = GEOMETRIES[name]
    rng = np.random.default_rng(len(name))
    x = rng.random(shape, dtype=np.float32) * 2.0 - 0.3
    jl = make_jax(J, J["scheme"](FSPTQ))
    v = J["jax"].jit(jl.init)(J["jax"].random.PRNGKey(len(name)),
                              jnp.asarray(x))
    v = J["calibrate"](jl, v, [jnp.asarray(x)])
    vd = J["dp"].prepare_deploy(jl, v, sample_input=jnp.asarray(x))
    want = np.asarray(jl.apply(vd, jnp.asarray(x), qmode="int"))
    pl = attach_scheme(make_port(), port_scheme(FSPTQ))
    load_jax_variables(pl, _np(v))
    pl.prepare_deploy()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        with LaunchRecorder() as rec:
            got = pl(xt, qmode="int")
        de = pl(xt, qmode="intc")
        assert torch.equal(materialize(de), got)
        assert torch.equal(got, plain_path(pl, xt))
    assert rec.counts() == _launches(**launches)
    assert isinstance(de.acc, PendingDwConv if "dwconv" in launches
                      else PendingWideConv)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want), name


# -------------------------------------------------- per-group window sums

@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("k,s,pads", [(3, 1, ((1, 1), (1, 1))),
                                      (1, 2, ((0, 0), (0, 0))),
                                      (5, 2, ((2, 1), (0, 3))),
                                      (1, 1, ((1, 0), (0, 1)))])
def test_window_sum_groups_match_float64(groups, k, s, pads):
    rng = np.random.default_rng(groups * 10 + k)
    x = rng.integers(-128, 128, (2, 9, 7, 24), dtype=np.int8)
    zero = -37
    (top, bottom), (left, right) = pads
    xp = np.pad(x.astype(np.float64) - zero,
                ((0, 0), (top, bottom), (left, right), (0, 0)))
    ho, wo = WS.out_hw(9, 7, k, s, pads)
    cg = 24 // groups
    want = np.zeros((2, ho, wo, groups))
    for p in range(ho):
        for q in range(wo):
            win = xp[:, p * s:p * s + k, q * s:q * s + k]
            want[:, p, q] = win.reshape(2, k * k, groups, cg).sum((1, 3))
    got = WS.int8_window_sum(torch.from_numpy(x), zero=zero, kernel=k,
                             stride=s, pads=pads, groups=groups)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want if groups > 1 else want[..., 0])


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _dw_operands(dev, n, h, w, c, w4, term, seed, offset=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8,
                      generator=gen)
    if offset:       # a view `offset` bytes past a 16-byte boundary
        buf = torch.empty(x.numel() + offset, dtype=torch.int8, device=dev)
        view = buf[offset:].view(x.shape)
        view.copy_(x.to(dev))
        xd = view
    else:
        xd = x.to(dev)
    span = 8 if w4 else 128
    wk = torch.randint(-span, span, (1, 1, 1, c), dtype=torch.int8,
                       generator=gen)
    wp = (D.pack_weight_int4 if w4 else D.pack_weight)(wk).to(dev)
    a = (torch.rand(c, generator=gen) * 1e-2 + 1e-4).to(dev)
    b = (torch.randn(c, generator=gen) * 4).to(dev)
    oc = (torch.randn(c, generator=gen) * 1e-2).to(dev) if term else None
    return xd, wp, a, b, oc


MODES = (dict(mode="codes", lo=-5, hi=90), dict(mode="codes"),
         dict(mode="f32"), dict(mode="f32", relu=True))


@pytest.mark.cuda
@pytest.mark.parametrize("c,offset,path", [
    (64, 0, 0), (96, 0, 0), (1280, 0, 0), (24, 0, 0), (40, 0, 0),
    (20, 0, 4), (32, 4, 4), (7, 0, 1), (48, 3, 1)])
def test_card_dwconv_1x1_matches_plain(c, offset, path):
    """The 1×1 window on each path (granules 16 or 8 aligned, 4 and 1
    ragged: a ragged C or codes off 16-byte alignment), strides 1 and 2,
    W8 and W4, every mode, with and without the term; MobileOne-S1's
    widths among them."""
    dev = _card()
    before = D.int8_dwconv3x3.launches_1x1
    runs = 0
    for stride in (1, 2):
        for w4 in (False, True):
            for term in (False, True):
                x, wp, a, b, oc = _dw_operands(dev, 3, 13, 11, c, w4, term,
                                               c + stride + 2 * w4 + term,
                                               offset)
                assert D.route(x, wp) == path
                xc = x.contiguous()
                for kw in MODES:
                    got = D.int8_dwconv3x3(x, wp, a, b, stride=stride,
                                           pad=-9, offset=oc, **kw)
                    want = D.int8_dwconv3x3_plain(xc.cpu(), wp.cpu(),
                                                  a.cpu(), b.cpu(),
                                                  stride=stride, pad=-9,
                                                  offset=None if oc is None
                                                  else oc.cpu(), **kw)
                    torch.cuda.synchronize()
                    assert torch.equal(got.cpu(), want), (stride, w4, term,
                                                          kw)
                    runs += 1
    assert D.int8_dwconv3x3.launches_1x1 == before + runs


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,stride", [(8, 56, 56, 64, 2),
                                             (8, 28, 28, 96, 1),
                                             (8, 14, 14, 192, 2),
                                             (8, 14, 14, 512, 1),
                                             (8, 7, 7, 1280, 1)])
def test_card_dwconv_1x1_mobileone_shapes(n, h, w, c, stride):
    """MobileOne-S1's scale-branch shapes (a batch of 8), f32 as the train
    form's ``int`` runs them, on the plan's grid and on one block a slice
    (every thread walks many pixels)."""
    dev = _card()
    x, wp, a, b, _ = _dw_operands(dev, n, h, w, c, False, False, c)
    want = D.int8_dwconv3x3_plain(x.cpu(), wp.cpu(), a.cpu(), b.cpu(),
                                  stride=stride, pad=3, mode="f32")
    p = D.check_kernel(x, wp, stride, mode="f32")
    for plan in (None, (p.cb, 1, 1, 1)):
        got = D.int8_dwconv3x3(x, wp, a, b, stride=stride, pad=3,
                               mode="f32", _plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), plan


@pytest.mark.cuda
@pytest.mark.parametrize("k,c,stride,pads", [
    (3, 32, 1, ((0, 0), (0, 0))), (3, 20, 2, ((2, 2), (2, 2))),
    (5, 24, 2, ((1, 1), (1, 1))), (5, 16, 1, ((0, 3), (1, 0))),
    (1, 32, 1, ((1, 1), (1, 1))), (1, 12, 2, ((0, 2), (1, 0)))])
def test_card_dwconv_pads_passed_in_match_plain(k, c, stride, pads):
    """The depthwise kernel with its pads and output size passed in (the
    3×3 and 5×5 halo tiles, the 1×1 window), W8 and W4, with the term."""
    dev = _card()
    gen = torch.Generator().manual_seed(k * 100 + c)
    x = torch.randint(-128, 128, (2, 11, 13, c), dtype=torch.int8,
                      generator=gen)
    for w4 in (False, True):
        wk = torch.randint(-8 if w4 else -128, 8 if w4 else 128,
                           (k, k, 1, c), dtype=torch.int8, generator=gen)
        wp = (D.pack_weight_int4 if w4 else D.pack_weight)(wk)
        a = torch.rand(c, generator=gen) * 1e-2 + 1e-4
        b = torch.randn(c, generator=gen)
        oc = torch.randn(c, generator=gen) * 1e-2
        for kw in MODES:
            want = D.int8_dwconv3x3_plain(x, wp, a, b, stride=stride,
                                          pad=6, pads=pads, offset=oc, **kw)
            got = D.int8_dwconv3x3(x.to(dev), wp.to(dev), a.to(dev),
                                   b.to(dev), stride=stride, pad=6,
                                   pads=pads, offset=oc.to(dev), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (w4, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("shape,k,s,pads", [
    ((2, 56, 56, 160), 3, 1, ((1, 1), (1, 1))),
    ((2, 28, 28, 320), 1, 1, ((0, 0), (0, 0))),
    ((3, 13, 11, 40), 3, 2, ((0, 1), (1, 0))),
    ((2, 9, 10, 24), 5, 1, ((2, 2), (2, 2))),
    ((2, 12, 9, 64), 1, 2, ((0, 0), (0, 0))),
    ((1, 7, 7, 1280), 3, 1, ((1, 1), (1, 1)))])
def test_card_window_sum_groups_match_plain(shape, k, s, pads, groups):
    dev = _card()
    x = torch.randint(-128, 128, shape, dtype=torch.int8,
                      generator=torch.Generator().manual_seed(groups + k))
    before = (WS.int8_window_sum.launches,
              WS.int8_window_sum.launches_grouped)
    for zero in (-128, 0, 11):
        want = WS.int8_window_sum_plain(x, zero=zero, kernel=k, stride=s,
                                        pads=pads, groups=groups)
        got = WS.int8_window_sum(x.to(dev), zero=zero, kernel=k, stride=s,
                                 pads=pads, groups=groups)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), zero
    assert (WS.int8_window_sum.launches,
            WS.int8_window_sum.launches_grouped) == (before[0] + 3,
                                                     before[1] + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("n,h,w,c", [(2, 56, 56, 160), (2, 28, 28, 320),
                                     (2, 14, 14, 640), (3, 9, 11, 40)])
def test_card_grouped_conv_row_term_matches_plain(n, h, w, c, w4):
    """The grouped build's row term at RepVGG-B2g4's grouped shapes (G =
    4: Cg = 40, 80, 160), S one sum a group, codes and f32."""
    dev = _card()
    g = 4
    gen = torch.Generator().manual_seed(c + w4)
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8,
                      generator=gen)
    span = 8 if w4 else 128
    wk = torch.randint(-span, span, (3, 3, c // g, c), dtype=torch.int8,
                       generator=gen)
    wp = (K.pack_weight_int4 if w4 else K.pack_weight)(wk, g)
    a = torch.rand(c, generator=gen) * 1e-4 + 1e-6
    b = torch.randn(c, generator=gen)
    sums = WS.int8_window_sum_plain(x, zero=-5, kernel=3,
                                    pads=((1, 1), (1, 1)), groups=g)
    row = (sums, torch.randn(c, generator=gen) * 1e-3)
    assert wp.dtype == (W4 if w4 else torch.int8)
    for kw in (dict(mode="codes", lo=-7, hi=100), dict(mode="f32"),
               dict(mode="f32", relu=True)):
        want = K.int8_conv3x3_plain(x, wp, a, b, stride=1, pad=-5, row=row,
                                    groups=g, **kw)
        got = K.int8_conv3x3(x.to(dev), wp.to(dev), a.to(dev), b.to(dev),
                             stride=1, pad=-5,
                             row=tuple(t.to(dev) for t in row), groups=g,
                             **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), kw

"""MobileNetV2 and MobileOne in the port against the JAX package, on the
same weights (carried over by ``load_jax_variables``) and the same seeded
numpy images, with bench.py's W8A8 scheme (FSPTQ, per-channel int8
weights, per-tensor unsigned int8 activations):

* ``cifar_mobilenet_v2`` at width 1.0, 32×32, batch 2: every published
  width, the 24-channel maps (K = 24 into the int8 GEMM, padded to 32),
  ReLU6, the linear-bottleneck residuals;
* ``MobileOne`` with one block a stage, widths 16…128 and two conv
  branches (so the fused branch sum has two terms), 64×64, batch 2.

BN statistics and affine are perturbed and the deploy biases are nonzero
(ROADMAP hazard C8).

* Train form: ``fp`` logits within relative L2 1e-4 (float sums in
  another order); after JAX's calibration, every quantized layer in
  ``eval``, fed JAX's input to it, within relative L2 1e-5 of JAX's.
* Fusers: ``mobilenet_deploy`` and ``mobileone_fuse`` give deploy ``fp``
  logits within rtol 2e-4, atol 2e-5 (of the largest logit) of the train
  form's, and kernels and biases within 1e-6 of JAX's fusers'.
* Integer paths on JAX's calibrated and deployed variables: every
  deploy conv fed JAX's input exact (its accumulator; its epilogue on
  codes inputs) or within 1e-6; every ``intc`` block output, the port
  block fed JAX's input to it, at most one code from JAX's (C2) on at
  most 0.1 % of the codes; the deploy form's ``int`` and ``intc`` logits
  and the train form's ``int`` logits within relative L2 2e-2 of JAX's,
  but cifar_mobilenet_v2's ``intc`` and train-form ``int`` logits within
  5e-2: the net is chaotic at random weights (JAX's own ``intc`` and
  ``int`` logits differ by 6.3e-2), and two codes of 49,152 one apart at
  ``block1_1`` (C2) move its ``intc`` logits by 3.19e-2, every block on
  JAX's inputs matching (measured on the CPU).
* ``qrelu6``, ``clamp_hi`` and ``QBlockOutput(relu=False)`` against JAX's
  chain functions and block on the same inputs: exact where the
  epilogue's inputs are identical.
* The launches of one ``intc`` request, the bridge of a depthwise kernel
  (HWIO (3, 3, 1, C) → OIHW (C, 1, 3, 3)), the registry's case folding,
  the FSPTQ entry's fusers, and the train forms' integer modes against
  JAX's ``int`` (MobileOne's depthwise 1×1 scale branches on the
  depthwise kernel's 1×1 window).
* ``cuda``-marked tests hold the other kernels of the two models' paths
  against their plain versions on the card (tolerance 0): the stems
  (3→32 and, at width 0.75, 3→24 3×3/s2 SAME; 3→64 3×3/s2 pad 1) and
  the GEMM at N = 24 in every mode, K = 24 padded, at batch 8 and 256;
  they skip here:
  ``python -m pytest --noconftest tests/test_torch_mobile.py -m cuda``.
"""

import types

import numpy as np
import pytest
import torch

from dlmc_quant_torch.examples.FSPTQuant import FUSERS, to_deploy
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import mobilenet_deploy
from dlmc_quant_torch.models.mobilenetv2 import MobileNetV2
from dlmc_quant_torch.models.mobileone import MobileOne, mobileone_fuse
from dlmc_quant_torch.models.resnet_cifar import BatchNorm
from dlmc_quant_torch.ops.cuda import int8_conv as K
from dlmc_quant_torch.ops.cuda import int8_gemm as G
from dlmc_quant_torch.quant import chain
from dlmc_quant_torch.quant.chain import (DeferredEpilogue, PendingDwConv,
                                          QuantizedTensor)
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import (QBlockOutput, QConv, QLayer,
                                           calibrate)
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables
from dlmc_quant_torch.utils.launches import LaunchRecorder

torch.set_num_threads(1)

BATCH = 2
SCHEME = {"quantization_type": "FSPTQ",
          "weight": {"enable": True, "type": "minmax_channel",
                     "args": {"n_bits": 8, "signed": True}},
          "input": {"enable": True, "type": "minmax_tensor",
                    "args": {"n_bits": 8, "signed": False}}}
# arch → (map size, launches of an intc request: conv, gemm, im2col,
# stem_pool, dwconv, window_sum; QConvs in the deploy form; QLayers in the
# train form)
ARCHS = {"mobilenet": (32, dict(conv=1, gemm=39, im2col=0, stem_pool=0,
                                dwconv=17, window_sum=0), 52, 53),
         "mobileone": (64, dict(conv=1, gemm=4, im2col=0, stem_pool=0,
                                dwconv=4, window_sum=0), 9, 23)}
MOBILEONE_SMALL = dict(num_blocks=(1, 1, 1, 1),
                       width_multipliers=(0.25, 0.25, 0.25, 0.25),
                       num_conv_branches=2, num_classes=10)


def _jax():
    """JAX, flax and the JAX package, imported where a test compares with
    them: the card's machine runs this file's cuda tests without JAX."""
    import flax
    import jax
    import jax.numpy as jnp
    from dlmc_quant_tpu.models import get_model as jax_get_model
    from dlmc_quant_tpu.models.fuse import mobilenet_deploy as jax_mn_deploy
    from dlmc_quant_tpu.models.mobileone import MobileOne as JMobileOne
    from dlmc_quant_tpu.models.mobileone import mobileone_fuse as jax_mo_fuse
    from dlmc_quant_tpu.quant import chain as jchain
    from dlmc_quant_tpu.quant import deploy as jdp
    from dlmc_quant_tpu.quant.config import scheme_from_dict
    from dlmc_quant_tpu.quant.layers import QConv as JQConv
    from dlmc_quant_tpu.quant.layers import QDense as JQDense
    from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
    return types.SimpleNamespace(**locals())


def _np(tree):
    j = _jax()
    return j.jax.tree_util.tree_map(np.asarray, j.flax.core.unfreeze(tree))


def _images(seed, size):
    return np.random.default_rng(seed).random((BATCH, size, size, 3),
                                              dtype=np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _jax_model(arch, deploy=False, width_mult=1.0):
    j = _jax()
    scheme = j.scheme_from_dict(SCHEME)
    if arch == "mobilenet":
        return j.jax_get_model("cifar_mobilenet_v2", num_classes=10,
                               scheme=scheme, deploy=deploy,
                               width_mult=width_mult)
    return j.JMobileOne(**MOBILEONE_SMALL, scheme=scheme, deploy=deploy)


def _port_model(arch, deploy=False, width_mult=1.0):
    if arch == "mobilenet":
        return get_model("cifar_mobilenet_v2", device="cpu", deploy=deploy,
                         scheme=port_scheme(SCHEME), width_mult=width_mult)
    return MobileOne(**MOBILEONE_SMALL, deploy=deploy,
                     scheme=port_scheme(SCHEME)).eval()


def _leaf(tree, path, name):
    node = tree
    for part in path.split(".") if path else ():
        node = node[part]
    return np.asarray(node[name])


@pytest.fixture(scope="module", params=list(ARCHS))
def case(request):
    return make_case(request.param)


def make_case(arch, width_mult=1.0):
    """JAX's train form (BN statistics and affine perturbed) and its
    calibration; JAX's fuser, calibration and prepare_deploy of the deploy
    form; the port's twins on the same variables."""
    j = _jax()
    size, launches, n_convs, n_layers = ARCHS[arch]
    x = j.jnp.asarray(_images(0, size))
    jm = _jax_model(arch, width_mult=width_mult)
    v = j.flax.core.unfreeze(j.jax.jit(jm.init)(j.jax.random.PRNGKey(1), x))
    rng = np.random.default_rng(2)
    v["batch_stats"] = j.jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.random(a.shape, dtype=np.float32),
        v["batch_stats"])
    for path, leaf in j.flax.traverse_util.flatten_dict(v["params"]).items():
        if path[-2].endswith("bn") or path[-2] == "bn_stem" \
                or path[-2] == "bn_head" or "_bn" in path[-2]:
            v["params"] = j.flax.traverse_util.unflatten_dict({
                **j.flax.traverse_util.flatten_dict(v["params"]),
                path: leaf * (0.8 + 0.4 * rng.random(leaf.shape,
                                                      dtype=np.float32))
                if path[-1] == "scale"
                else leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                    np.float32)})
    batches = [_images(0, size), _images(1, size)]
    v_cal = j.jax_calibrate(jm, v, [j.jnp.asarray(b) for b in batches],
                            observe_passes=2)
    example = j.jnp.zeros((1, size, size, 3))
    fuse = j.jax_mn_deploy if arch == "mobilenet" else j.jax_mo_fuse
    jdm, dv = fuse(jm, v, example)
    dv = j.jdp.prepare_deploy(jdm, j.jax_calibrate(jdm, dv, [x]),
                              sample_input=x)
    train = load_jax_variables(_port_model(arch, width_mult=width_mult),
                               _np(v))
    port = load_jax_variables(
        _port_model(arch, deploy=True, width_mult=width_mult),
        _np({k: t for k, t in dv.items() if k != "qint"}))
    prepare_deploy(port)
    return dict(arch=arch, size=size, launches=launches, n_convs=n_convs,
                n_layers=n_layers, jm=jm, v=v, v_cal=v_cal, jdm=jdm, dv=dv,
                qint=_np(dv["qint"]), train=train, port=port,
                batches=batches)


def test_train_fp_matches_jax(case):
    j = _jax()
    x = _images(3, case["size"])
    want = case["jm"].apply(case["v"], j.jnp.asarray(x), qmode="fp")
    with torch.no_grad():
        got = case["train"](torch.from_numpy(x), qmode="fp")
    assert got.shape == (BATCH, 10)
    assert _rel(got, want) <= 1e-4


def test_calibration_and_eval_layers_match_jax(case):
    """The port's calibration on the same batches, then every quantized
    layer in 'eval' on JAX's calibrated variables, fed the input JAX's
    forward gave it."""
    j = _jax()
    port = load_jax_variables(_port_model(case["arch"]), _np(case["v"]))
    calibrate(port, [torch.from_numpy(b) for b in case["batches"]],
              observe_passes=2)
    params = _np(case["v_cal"])["params"]
    qstate = _np(case["v_cal"])["qstate"]
    n = 0
    for path, m in port.named_modules():
        if isinstance(m, QLayer):
            for name, tree, rtol in (("in_scale", params, 2e-6),
                                     ("wt_scale", params, 1e-6),
                                     ("in_offset", qstate, 1e-6)):
                np.testing.assert_allclose(
                    getattr(m, name).detach(), _leaf(tree, path, name),
                    rtol=rtol, atol=1e-9, err_msg=f"{path}.{name}")
            n += 1
    assert n == case["n_layers"]
    seen = {}

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, (j.JQConv, j.JQDense)) \
                and context.method_name == "__call__":
            seen[".".join(context.module.scope.path)] = (
                np.asarray(args[0]), np.asarray(out))
        return out

    with j.flax.linen.intercept_methods(grab):
        case["jm"].apply(case["v_cal"], j.jnp.asarray(_images(3,
                                                              case["size"])),
                         qmode="eval")
    port = load_jax_variables(_port_model(case["arch"]),
                              _np(case["v_cal"]))
    for path, m in port.named_modules():
        if isinstance(m, QLayer):
            x, want = seen[path]
            with torch.no_grad():
                got = m(torch.from_numpy(np.array(x)), qmode="eval")
            assert _rel(got, want) <= 1e-5, path


def test_fuser_matches_train_and_jax(case):
    train = case["train"]
    dep = (mobilenet_deploy if case["arch"] == "mobilenet"
           else mobileone_fuse)(train)
    assert FUSERS[type(train).__name__] in (mobilenet_deploy,
                                            mobileone_fuse)
    x = torch.from_numpy(_images(3, case["size"]))
    with torch.no_grad():
        got, want = dep(x, qmode="fp"), train(x, qmode="fp")
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * float(want.abs().max()))
    assert not any(isinstance(m, BatchNorm) for m in dep.modules())
    jparams = _np(case["dv"])["params"]
    n = 0
    for path, m in dep.named_modules():
        if isinstance(m, QConv):
            kern = np.transpose(_leaf(jparams, path, "kernel"), (3, 2, 0, 1))
            np.testing.assert_allclose(m.weight.detach(), kern, rtol=1e-6,
                                       atol=1e-6 * np.abs(kern).max(),
                                       err_msg=path)
            bias = _leaf(jparams, path, "bias")
            np.testing.assert_allclose(m.bias.detach(), bias, rtol=1e-6,
                                       atol=1e-6 * np.abs(bias).max(),
                                       err_msg=path)
            n += 1
    assert n == case["n_convs"]


def test_train_form_int_matches_jax_or_raises(case):
    """Both train forms run 'int' (and 'intc' as 'int') against JAX's
    'int': MobileOne's depthwise blocks with their 1x1 scale branches on
    the depthwise kernel's 1x1 window."""
    j = _jax()
    x = _images(3, case["size"])
    port = prepare_deploy(load_jax_variables(_port_model(case["arch"]),
                                             _np(case["v_cal"])))
    jv = j.jdp.prepare_deploy(case["jm"], case["v_cal"],
                              sample_input=j.jnp.asarray(x))
    want = case["jm"].apply(jv, j.jnp.asarray(x), qmode="int")
    with torch.no_grad():
        got = port(torch.from_numpy(x), qmode="int")
        assert torch.equal(port(torch.from_numpy(x), qmode="intc"), got)
    # 52 layers that each quantize the f32 output of the one before: a
    # float difference flips a code now and then (C2), and the random net
    # amplifies it (module docstring; 2.02e-2 measured)
    assert _rel(got, want) < 5e-2


def _jax_intc(case, x):
    """JAX's deploy-form intc forward of ``x``: logits, and every QConv's
    and block's (input, output) by module path."""
    j = _jax()
    seen = {}

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            path = ".".join(context.module.scope.path)
            if isinstance(context.module, j.JQConv) or (
                    path.startswith(("block", "stage")) and "." not in path):
                seen[path] = (args[0], out)
        return out

    with j.flax.linen.intercept_methods(grab):
        logits = case["jdm"].apply(case["dv"], j.jnp.asarray(x),
                                   qmode="intc")
    return np.asarray(logits), seen


def _to_port(t):
    """A JAX chain value as the port's."""
    j = _jax()
    if isinstance(t, j.jchain.QuantizedTensor):
        return QuantizedTensor(torch.from_numpy(np.array(t.q)),
                               float(t.scale), float(t.bias))
    if isinstance(t, j.jchain.DeferredEpilogue):
        return DeferredEpilogue(
            torch.from_numpy(np.array(t.acc)),
            torch.from_numpy(np.array(t.scale)).reshape(-1),
            torch.from_numpy(np.array(t.bias)).reshape(-1), t.relu,
            t.clamp_hi)
    return torch.from_numpy(np.array(t))


def _jax_codes(x, plan):
    """The int8 codes JAX's QConv computed from its input ``x``."""
    j = _jax()
    if isinstance(x, j.jchain.QuantizedTensor):
        return np.asarray(x.q)
    if isinstance(x, j.jchain.DeferredEpilogue):
        return np.asarray(j.jchain.fold_quantize(
            x, plan["in_inv_scale"], plan["in_qbias"], -128, 127))
    q, _ = j.jdp.act_to_int8(x, plan["in_scale"], plan["in_offset"], 0, 255,
                             inv_s_x=plan["in_inv_scale"],
                             qbias=plan["in_qbias"])
    return np.asarray(q)


def test_intc_convs_match_jax_on_its_inputs(case):
    """Every deploy conv fed JAX's input: its codes at most one code from
    JAX's (C2; equal on codes inputs), its accumulator on JAX's codes
    exact (the depthwise and 3x3 kernels give it as f32 with a = 1, b =
    0), its epilogue exact on codes inputs, whose bias both sides derive
    eagerly, and within 1e-6 elsewhere."""
    j = _jax()
    _, seen = _jax_intc(case, _images(3, case["size"]))
    port, qint = case["port"], case["qint"]
    convs = [(p, m) for p, m in port.named_modules() if isinstance(m, QConv)]
    assert len(convs) == case["n_convs"]
    on_codes = 0
    for path, m in convs:
        x_j, y_j = seen[path]
        node = qint
        for part in path.split("."):
            node = node[part]
        codes_j = _jax_codes(x_j, node)
        with torch.no_grad():
            codes, epi_scale, bias_eff, pad = m._int_input(_to_port(x_j))
            dq = np.abs(codes.numpy().astype(int) - codes_j.astype(int))
            assert dq.max() <= 1, path
            if isinstance(x_j, j.jchain.QuantizedTensor):
                assert dq.max() == 0, path
            de = m.deferred(torch.from_numpy(np.array(codes_j)), epi_scale,
                            bias_eff, pad)
            if m.depthwise:
                assert isinstance(de.acc, PendingDwConv), path
            if isinstance(de.acc, chain.PendingGemm):
                acc = de.acc.run(mode="int32").numpy()
            else:
                ones = torch.ones_like(epi_scale)
                acc = de.acc.run(ones, torch.zeros_like(ones),
                                 mode="f32").numpy()
            assert np.array_equal(acc, np.asarray(y_j.acc).astype(acc.dtype)
                                  ), path
            got = chain.materialize(de).numpy()
        want = np.asarray(j.jchain.materialize(
            j.jchain.DeferredEpilogue(y_j.acc, y_j.scale, y_j.bias)))
        # one float32 product on either side
        assert np.array_equal(epi_scale.numpy(),
                              np.asarray(y_j.scale).reshape(-1)), path
        if isinstance(x_j, j.jchain.QuantizedTensor):
            # the bias re-derived from the column sums, eagerly on both
            # sides: the epilogue's inputs and its output are equal
            assert np.array_equal(bias_eff.numpy(),
                                  np.asarray(y_j.bias).reshape(-1)), path
            assert np.array_equal(got, want), path
            on_codes += 1
        else:
            # JAX's jitted prepare_deploy contracts the bias into an fma:
            # an ulp apart
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=path)
    assert on_codes == (10 if case["arch"] == "mobilenet" else 0)


def test_intc_blocks_and_logits_match_jax(case):
    """Every block fed JAX's input: a linear bottleneck's output codes on
    JAX's grid at most one code apart (C2) on at most 0.1 % of the values,
    any other block's deferred output within relative L2 1e-5; the int
    and intc logits (tolerances in the module docstring)."""
    j = _jax()
    x = _images(3, case["size"])
    want, seen = _jax_intc(case, x)
    port = case["port"]
    total = differ = residual = 0
    for name in port.block_names:
        x_j, y_j = seen[name]
        with torch.no_grad():
            out = getattr(port, name)(_to_port(x_j), qmode="intc")
        if isinstance(y_j, j.jchain.QuantizedTensor):
            residual += 1
            assert getattr(port, name).out_q.relu is False
            assert isinstance(out, QuantizedTensor), name
            assert (out.scale, out.bias) == (float(y_j.scale),
                                             float(y_j.bias))
            diff = np.abs(out.q.numpy().astype(int) - np.asarray(y_j.q, int))
            assert diff.max() <= 1, name
            total += diff.size
            differ += int((diff > 0).sum())
        else:
            assert isinstance(out, DeferredEpilogue), name
            assert (out.relu, out.clamp_hi) == (y_j.relu, y_j.clamp_hi)
            with torch.no_grad():
                got = chain.materialize(out)
            assert _rel(got, j.jchain.materialize(y_j)) <= 1e-5, name
    assert residual == (10 if case["arch"] == "mobilenet" else 0)
    assert differ <= 1e-3 * max(total, 1), (differ, total)
    with torch.no_grad():
        got = port(torch.from_numpy(x), qmode="intc")
        got_int = port(torch.from_numpy(x), qmode="int")
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) < (5e-2 if case["arch"] == "mobilenet" else 2e-2)
    want_int = case["jdm"].apply(case["dv"], j.jnp.asarray(x), qmode="int")
    assert _rel(got_int, want_int) < 2e-2


def test_linear_bottleneck_plan_matches_jax(case):
    """QBlockOutput(relu=False): the folded clamp's lower bound is the
    grid's minimum, and the plan equals JAX's."""
    blocks = [(p, m) for p, m in case["port"].named_modules()
              if isinstance(m, QBlockOutput)]
    assert len(blocks) == (10 if case["arch"] == "mobilenet" else 0)
    for path, m in blocks:
        assert not m.relu and m.plan_scalars["bq_lo"] == -128
        for key in ("bq_inv", "bq_qbias", "bq_lo", "bq_scale", "bq_bias"):
            want = float(_leaf(case["qint"], path, key))
            assert m.plan_scalars[key] == pytest.approx(want, rel=1e-6,
                                                        abs=1e-9), key


def test_request_launches(case):
    """One intc request: the kernels of each kind, and the 24-channel maps
    of MobileNetV2 into the GEMM as K = 32 with zero columns past 24."""
    with torch.no_grad(), LaunchRecorder() as rec:
        case["port"](torch.from_numpy(_images(4, case["size"])),
                     qmode="intc")
    assert rec.counts() == case["launches"]
    padded = [args[0] for kind, args, _, _ in rec.calls
              if kind == "gemm" and args[0].shape[1] == 32
              and not bool(args[0][:, 24:].any())]
    assert len(padded) == (2 if case["arch"] == "mobilenet" else 0)


def test_qrelu6_and_clamped_terms_match_jax():
    """qrelu6 on block-output codes, materialize and fold_quantize of a
    ReLU6-flagged accumulator, and such a term inside a residual sum,
    against JAX's chain on the same inputs."""
    j = _jax()
    rng = np.random.default_rng(7)
    q = rng.integers(-128, 128, (2, 5, 5, 16), dtype=np.int8)
    for scale, bias in ((0.05, -1.3), (0.031, 0.2), (0.004, -0.25)):
        jq = j.jchain.qrelu6(j.jchain.QuantizedTensor(
            j.jnp.asarray(q), j.jnp.float32(scale), j.jnp.float32(bias)))
        got = chain.qrelu6(QuantizedTensor(
            torch.from_numpy(q), float(np.float32(scale)),
            float(np.float32(bias))))
        assert np.array_equal(got.q.numpy(), np.asarray(jq.q))
    acc = rng.integers(-50000, 50000, (2, 5, 5, 16), dtype=np.int32)
    scale = (rng.random(16, dtype=np.float32) * 1e-3).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    jde = j.jchain.qrelu6(j.jchain.DeferredEpilogue(
        j.jnp.asarray(acc), j.jnp.asarray(scale), j.jnp.asarray(bias)))
    de = chain.qrelu6(DeferredEpilogue(torch.from_numpy(acc),
                                       torch.from_numpy(scale),
                                       torch.from_numpy(bias)))
    assert (de.relu, de.clamp_hi) == (jde.relu, jde.clamp_hi) == (True, 6.0)
    assert np.array_equal(chain.materialize(de).numpy(),
                          np.asarray(j.jchain.materialize(jde)))
    # hi = round(6·10 − 7.5) = round(52.5): a tie, to even
    inv, qb = np.float32(10.0), np.float32(-7.5)
    want = j.jchain.fold_quantize(jde, inv, qb, -128, 127)
    got = chain.fold_quantize(de, float(inv), float(qb), -128, 127)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) == 52      # the ReLU6 clamp binds
    # a clamped term inside a linear-bottleneck sum is materialized first
    y = rng.integers(-128, 128, (50, 16), dtype=np.int8)
    wk = rng.integers(-128, 128, (16, 16), dtype=np.int8)
    y_acc = (y.astype(np.int32) @ wk.astype(np.int32)).reshape(2, 5, 5, 16)
    jy = j.jchain.DeferredEpilogue(j.jnp.asarray(y_acc), j.jnp.asarray(scale),
                                   j.jnp.asarray(bias))
    want = j.jchain.fold_sum_quantize([jy, jde], inv, qb, -128, 127)
    py = DeferredEpilogue(
        chain.PendingGemm(torch.from_numpy(y), G.pack_b(torch.from_numpy(wk)),
                          (2, 5, 5)), torch.from_numpy(scale),
        torch.from_numpy(bias))
    got = chain.fold_sum_quantize([py, de], float(inv), float(qb), -128, 127)
    assert int(np.abs(got.numpy().astype(int)
                      - np.asarray(want).astype(int)).max()) <= 1


def test_block_output_without_relu():
    blk = QBlockOutput(relu=False)
    y, r = torch.randn(2, 3, 3, 4), torch.randn(2, 3, 3, 4)
    assert torch.equal(blk(y, r), y + r)
    assert bool((blk(y, r) < 0).any())
    assert torch.equal(QBlockOutput()(y, r), torch.relu(y + r))


def test_bridge_carries_the_depthwise_kernel(case):
    """HWIO (k, k, 1, C) → OIHW (C, 1, k, k) for every depthwise conv: the
    3×3s, and MobileOne's 1×1 scale branches."""
    params = _np(case["v"])["params"]
    n = 0
    for path, m in case["train"].named_modules():
        if isinstance(m, QConv) and m.depthwise:
            k = m.kernel_size
            want = _leaf(params, path, "kernel")
            assert want.shape == (k, k, 1, m.weight.shape[0])
            assert tuple(m.weight.shape) == (want.shape[3], 1, k, k)
            assert np.array_equal(m.weight.detach().numpy(),
                                  np.transpose(want, (3, 2, 0, 1)))
            n += 1
    # MobileOne: two 3x3 branches and a 1x1 scale branch a depthwise block
    assert n == (17 if case["arch"] == "mobilenet" else 4 * 3)


@pytest.mark.parametrize("name,cls,classes", [
    ("mobilenet_v2", MobileNetV2, 1000), ("MobileOne_S1", MobileOne, 1000)])
def test_registry_and_parameter_count(name, cls, classes):
    j = _jax()
    jm = j.jax_get_model(name)
    shapes = j.jax.eval_shape(jm.init, j.jax.random.PRNGKey(0),
                              j.jnp.zeros((1, 224, 224, 3)))
    want = sum(int(np.prod(a.shape))
               for a in j.jax.tree_util.tree_leaves(shapes["params"]))
    model = get_model(name.lower(), device="cpu")
    assert isinstance(model, cls) and model.linear.weight.shape[0] == classes
    bns = sum(2 * m.weight.numel() for m in model.modules()
              if isinstance(m, BatchNorm))
    assert sum(p.numel() for p in model.parameters()) == want
    assert bns > 0


def test_fsptq_entry_converts_both_families():
    log = types.SimpleNamespace(info=lambda *a: None)
    for model in (get_model("cifar_mobilenet_v2", device="cpu"),
                  MobileOne(**MOBILEONE_SMALL)):
        dep = to_deploy(model, log)
        assert dep.deploy and type(dep) is type(model)
        assert not any(isinstance(m, BatchNorm) for m in dep.modules())


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _codes(g, shape, dev):
    return torch.randint(-128, 128, shape, generator=g,
                         dtype=torch.int8).to(dev)


def _affine(g, o, dev):
    return ((torch.rand(o, generator=g) * 1e-3 + 1e-5).to(dev),
            (torch.randn(o, generator=g) * 4).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 256])
@pytest.mark.parametrize("o,pad_lo", [(32, 0), (64, 1), (24, 0)],
                         ids=["mobilenet_v2", "mobileone_s1",
                              "mobilenet_v2_w075"])
def test_stem_conv_matches_plain(o, pad_lo, n):
    dev = _card()
    g = torch.Generator().manual_seed(o + n)
    x = _codes(g, (n, 224, 224, 3), dev)
    wp = K.pack_weight(_codes(g, (3, 3, 3, o), dev))
    a, b = _affine(g, o, dev)
    for kw in (dict(mode="codes", lo=-20, hi=101), dict(mode="f32")):
        got = K.int8_conv3x3(x, wp, a, b, stride=2, pad=5, pad_lo=pad_lo,
                             **kw)
        torch.cuda.synchronize()
        assert got.shape[:3] == (n, 112, 112)
        assert torch.equal(got, K.int8_conv3x3_plain(
            x, wp, a, b, stride=2, pad=5, pad_lo=pad_lo, **kw)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 256])
def test_gemm_at_24_channels_matches_plain(n):
    """MobileNetV2's 24-channel maps at 56²: project 144 → 24 (codes, and
    codes + an int32 or int8 residual at that pitch, int32 for a
    shortcut term) and expand 24 → 144 on codes padded to K = 32."""
    dev = _card()
    g = torch.Generator().manual_seed(n)
    m = n * 56 * 56
    x = _codes(g, (m, 144), dev)
    wp = G.pack_b(_codes(g, (144, 24), dev))
    a, b = _affine(g, 24, dev)
    r32 = torch.randint(-2 ** 20, 2 ** 20, (m, 24), generator=g,
                        dtype=torch.int32).to(dev)
    r8 = _codes(g, (m, 24), dev)
    ar, br = _affine(g, 24, dev)
    for kw in (dict(mode="codes", lo=-128, hi=127),
               dict(mode="codes", residual=(r32, ar, br), qb=-2.5),
               dict(mode="codes", residual=(r8, ar, br), qb=1.0),
               dict(mode="f32", relu=True)):
        got = G.int8_gemm(x, wp, a, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, G.int8_gemm_plain(x, wp, a, b, **kw)), kw
    got = G.int8_gemm(x, wp)
    assert torch.equal(got, G.int8_gemm_plain(x, wp))
    x24 = G.pad_k(_codes(g, (m, 24), dev))
    assert x24.shape == (m, 32) and not bool(x24[:, 24:].any())
    wp = G.pack_b(_codes(g, (24, 144), dev))
    a, b = _affine(g, 144, dev)
    got = G.int8_gemm(x24, wp, a, b, mode="codes", lo=0, hi=90)
    torch.cuda.synchronize()
    assert torch.equal(got, G.int8_gemm_plain(x24, wp, a, b, mode="codes",
                                              lo=0, hi=90))

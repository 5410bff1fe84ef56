"""The port's residual ResNet path against the JAX package, on the same
weights (carried over by ``load_jax_variables``) and the same seeded numpy
images: ``cifar_resnet18`` at full width and ``CifarResNet(depth_n=1)``
(cifar_resnet20's stages, one block each; option-A shortcuts), 16×16,
batch 4, BASELINE config #1's scheme (plain family, per-channel int8
weights, per-tensor unsigned int8 activations).

* Train-form fp forward: relative L2 ≤ 1e-4 (float sums in another
  order).  The stride-2 convs are flax's SAME, pads (0, 1); with PyTorch's
  symmetric pad 1 instead the logits are far off.
* ``resnet_deploy``: deploy fp against train fp within rtol 2e-4, atol
  2e-5, BN statistics perturbed (tests/test_chain.py:113-117); folded
  kernels and biases equal JAX's within 1e-6 relative.
* Calibration (2 observe passes): every ``wt_scale`` and ``in_offset``
  within 1e-6 relative of JAX's, every ``in_scale`` within 2e-6 (an
  activation's min/max moves with the f32 conv sums of every layer
  before it: 1.16e-6 at cifar_resnet18's 13th conv, under 7e-7 at the
  others).  Fake-quant ``eval``: every quantized layer, fed JAX's input
  to it, within relative L2 1e-5 of JAX's output; the logits within 1e-3
  on the small net.  On cifar_resnet18 one rounding of a quantizer flips
  (at layer2_0.conv2, from a float difference of the layers before) and
  the flips compound through the 13 layers after it: its logits are
  held to the integer paths' 2e-2.
* ``bn_recalibrate`` from JAX's calibrated variables, in ``'fp'``: running
  mean and variance within 1e-4 relative of flax's (both update with the
  biased batch variance).  In ``'eval'`` (fake quant, the PTQ default) a
  float difference may flip a rounding, and a flipped code moves a mean
  over 64 values by a step: the stem's BN within 1e-4, all statistics
  within relative L2 1e-2.
* Integer paths from JAX's calibrated variables: ``int`` logits relative
  L2 < 2e-2; ``intc`` block-output codes, each port block fed JAX's input
  codes, at most one code apart (C2) on at most 0.1 % of the values (a
  one-ulp difference of a plan value that XLA's jitted ``prepare_deploy``
  contracts into an fma moves a tie); ``intc`` logits relative L2 < 2e-2.
* A deploy-form BasicBlock emits int8 codes (tests/test_chain.py:134-156).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.models.fuse import resnet_deploy as jax_resnet_deploy
from dlmc_quant_tpu.models.resnet_cifar import CifarResNet as JCifarResNet
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.deploy import prepare_deploy as jax_prepare
from dlmc_quant_tpu.quant.layers import QConv as JQConv
from dlmc_quant_tpu.quant.layers import QDense as JQDense
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_tpu.training.ptq import bn_recalibrate as jax_bn_recal
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import resnet_deploy
from dlmc_quant_torch.models.resnet_cifar import (BasicBlock, BatchNorm,
                                                  CifarResNet)
from dlmc_quant_torch.quant.chain import QuantizedTensor, materialize
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import QConv, QLayer, attach_scheme, \
    calibrate
from dlmc_quant_torch.training.ptq import bn_recalibrate
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

BATCH, SIZE = 4, 16
SCHEME = {"quantization_type": None,
          "weight": {"enable": True, "type": "minmax_channel",
                     "args": {"n_bits": 8, "signed": True}},
          "input": {"enable": True, "type": "minmax_tensor",
                    "args": {"n_bits": 8, "signed": False}}}
ARCHS = ["cifar_resnet18", "resnet_n1"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _images(seed, n=BATCH):
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 3),
                                              dtype=np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _jax_model(arch, deploy=False):
    if arch == "resnet_n1":
        return JCifarResNet(depth_n=1, scheme=jax_scheme(SCHEME),
                            deploy=deploy)
    return jax_get_model(arch, num_classes=10, scheme=jax_scheme(SCHEME),
                         deploy=deploy)


def _port_model(arch, deploy=False):
    if arch == "resnet_n1":
        return CifarResNet(depth_n=1, deploy=deploy,
                           scheme=port_scheme(SCHEME)).eval()
    return get_model(arch, device="cpu", deploy=deploy,
                     scheme=port_scheme(SCHEME))


def _leaf(tree, path, name):
    node = tree
    for part in path.split(".") if path else ():
        node = node[part]
    return np.asarray(node[name])


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """JAX train-form model and variables (BN statistics perturbed),
    calibrated too; the port's twin on the same variables."""
    arch = request.param
    jm = _jax_model(arch)
    x = jnp.asarray(_images(0))
    v = flax.core.unfreeze(jm.init(jax.random.PRNGKey(1), x))
    rng = np.random.default_rng(2)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.random(a.shape, dtype=np.float32),
        v["batch_stats"])
    batches = [_images(0), _images(1)]
    v_cal = jax_calibrate(jm, v, [jnp.asarray(b) for b in batches],
                          observe_passes=2)
    port = load_jax_variables(_port_model(arch), _np(v))
    return dict(arch=arch, jm=jm, v=v, v_cal=v_cal, port=port,
                batches=batches)


def test_train_fp_matches_jax(case):
    x = _images(3)
    want = case["jm"].apply(case["v"], jnp.asarray(x), qmode="fp")
    with torch.no_grad():
        got = case["port"](torch.from_numpy(x), qmode="fp")
    assert got.shape == (BATCH, 10)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("case", ["cifar_resnet18"], indirect=True)
def test_symmetric_padding_would_fail(case):
    """PyTorch's habit (padding=1 on every side) is off by a pixel on the
    stride-2 convs; SAME pads (0, 1) there."""
    x = _images(3)
    want = case["jm"].apply(case["v"], jnp.asarray(x), qmode="fp")
    port = case["port"]
    convs = [m for m in port.modules() if isinstance(m, QConv)
             and m.stride == 2 and m.kernel_size == 3]
    assert len(convs) == 3
    try:
        for m in convs:
            m.padding = 1
        with torch.no_grad():
            wrong = port(torch.from_numpy(x), qmode="fp")
    finally:
        for m in convs:
            m.padding = "SAME"
    assert _rel(wrong, want) > 1e-2


def test_resnet_deploy_matches_train_and_jax(case):
    train = case["port"]
    dep = resnet_deploy(train)
    x = torch.from_numpy(_images(3))
    with torch.no_grad():
        np.testing.assert_allclose(dep(x, qmode="fp"), train(x, qmode="fp"),
                                   rtol=2e-4, atol=2e-5)
    assert not any(isinstance(m, BatchNorm) for m in dep.modules())
    _, jdv = jax_resnet_deploy(case["jm"], case["v"],
                               jnp.zeros((1, SIZE, SIZE, 3)))
    jdv = _np(jdv)
    n = 0
    for path, m in dep.named_modules():
        if isinstance(m, QConv):
            kern = np.transpose(_leaf(jdv["params"], path, "kernel"),
                                (3, 2, 0, 1))
            np.testing.assert_allclose(m.weight.detach(), kern, rtol=1e-6,
                                       atol=1e-6 * np.abs(kern).max())
            bias = _leaf(jdv["params"], path, "bias")
            np.testing.assert_allclose(m.bias.detach(), bias, rtol=1e-6,
                                       atol=1e-6 * np.abs(bias).max())
            n += 1
    assert n == (20 if case["arch"] == "cifar_resnet18" else 7)


def test_calibration_matches_jax(case):
    port = _port_model(case["arch"])
    load_jax_variables(port, _np(case["v"]))
    calibrate(port, [torch.from_numpy(b) for b in case["batches"]],
              observe_passes=2)
    params, qstate = _np(case["v_cal"])["params"], \
        _np(case["v_cal"])["qstate"]
    n = 0
    for path, m in port.named_modules():
        if not isinstance(m, QLayer):
            continue
        for name, tree, rtol in (("in_scale", params, 2e-6),
                                 ("wt_scale", params, 1e-6),
                                 ("in_offset", qstate, 1e-6)):
            want = _leaf(tree, path, name)
            np.testing.assert_allclose(getattr(m, name).detach(), want,
                                       rtol=rtol, atol=1e-9,
                                       err_msg=f"{path}.{name}")
        n += 1
    assert n == (21 if case["arch"] == "cifar_resnet18" else 8)
    x = _images(3)
    want = case["jm"].apply(case["v_cal"], jnp.asarray(x), qmode="eval")
    with torch.no_grad():
        got = port(torch.from_numpy(x), qmode="eval")
    assert _rel(got, want) <= (2e-2 if case["arch"] == "cifar_resnet18"
                               else 1e-3)


def test_eval_layers_match_jax(case):
    """Each quantized layer in 'eval', fed the input JAX's forward gave
    it, on JAX's calibrated variables."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, (JQConv, JQDense)) \
                and context.method_name == "__call__":
            seen[".".join(context.module.scope.path)] = (
                np.asarray(args[0]), np.asarray(out))
        return out

    with flax.linen.intercept_methods(grab):
        case["jm"].apply(case["v_cal"], jnp.asarray(_images(3)),
                         qmode="eval")
    port = _calibrated_port(case)
    n = 0
    for path, m in port.named_modules():
        if isinstance(m, QLayer):
            x, want = seen[path]
            with torch.no_grad():
                got = m(torch.from_numpy(np.array(x)), qmode="eval")
            assert _rel(got, want) <= 1e-5, path
            n += 1
    assert n == (21 if case["arch"] == "cifar_resnet18" else 8)


def _calibrated_port(case):
    return load_jax_variables(_port_model(case["arch"]), _np(case["v_cal"]))


@pytest.mark.parametrize("case,qmode", [
    ("cifar_resnet18", "fp"), ("resnet_n1", "fp"), ("resnet_n1", "eval")],
    indirect=["case"])
def test_bn_recalibrate_matches_flax(case, qmode):
    batches = case["batches"]
    want = _np(jax_bn_recal(case["jm"], case["v_cal"],
                            [jnp.asarray(b) for b in batches], qmode=qmode))
    port = bn_recalibrate(_calibrated_port(case),
                          [torch.from_numpy(b) for b in batches], qmode)
    assert not port.training
    got_all, want_all = [], []
    for path, m in port.named_modules():
        if isinstance(m, BatchNorm):
            for name, key in (("running_mean", "mean"),
                              ("running_var", "var")):
                w = _leaf(want["batch_stats"], path, key)
                got_all.append(getattr(m, name).numpy())
                want_all.append(w)
                if qmode == "fp" or path == "bn1":
                    np.testing.assert_allclose(
                        got_all[-1], w, rtol=1e-4,
                        atol=1e-4 * np.abs(w).max(), err_msg=f"{path}.{key}")
    assert len(got_all) == 2 * (20 if case["arch"] == "cifar_resnet18"
                                else 7)
    assert _rel(np.concatenate(got_all), np.concatenate(want_all)) < 1e-2


def test_int_logits_match_jax(case):
    x = _images(3)
    jv = jax_prepare(case["jm"], case["v_cal"], sample_input=jnp.asarray(x))
    want = case["jm"].apply(jv, jnp.asarray(x), qmode="int")
    port = prepare_deploy(_calibrated_port(case))
    with torch.no_grad():
        got = port(torch.from_numpy(x), qmode="int")
        # a train-form model runs 'intc' as 'int'
        assert torch.equal(port(torch.from_numpy(x), qmode="intc"), got)
    assert _rel(got, want) < 2e-2


def test_intc_codes_and_logits_match_jax(case):
    """Deploy form: JAX folds and calibrates, the port takes JAX's
    variables; every block's output codes (the port block fed JAX's input
    codes) and the logits."""
    jm = _jax_model(case["arch"], deploy=True)
    x = jnp.asarray(_images(3))
    _, dv = jax_resnet_deploy(case["jm"], case["v"],
                              jnp.zeros((1, SIZE, SIZE, 3)))
    dv = jax_calibrate(jm, dv, [x])
    dv = jax_prepare(jm, dv, sample_input=x)
    want, inter = jm.apply(dv, x, qmode="intc", capture_intermediates=True,
                           mutable=["intermediates"])
    port = load_jax_variables(_port_model(case["arch"], deploy=True),
                              _np({k: v for k, v in dv.items()
                                   if k != "qint"}))
    prepare_deploy(port)
    outs = {}
    hooks = [getattr(port, n).register_forward_hook(
        lambda mod, args, out, n=n: outs.__setitem__(n, out))
        for n in port.block_names]
    with torch.no_grad():
        got = port(torch.from_numpy(_images(3)), qmode="intc")
    for h in hooks:
        h.remove()
    assert _rel(got, want) < 2e-2

    def jax_out(name):
        qt = inter["intermediates"][name]["__call__"][0]
        return QuantizedTensor(torch.from_numpy(np.array(qt.q)),
                               float(qt.scale), float(qt.bias))

    names = port.block_names
    total = differ = 0
    for i, name in enumerate(names):
        ref = jax_out(name)
        if i == 0:
            out = outs[name]     # from the stem, as JAX computed it
        else:
            with torch.no_grad():
                out = getattr(port, name)(jax_out(names[i - 1]),
                                          qmode="intc")
        assert isinstance(out, QuantizedTensor) and out.q.dtype == torch.int8
        assert (out.scale, out.bias) == (ref.scale, ref.bias)
        diff = (out.q.long() - ref.q.long()).abs()
        assert int(diff.max()) <= 1, name
        total += diff.numel()
        differ += int((diff > 0).sum())
    assert differ <= 1e-3 * total, (differ, total)


def test_basic_block_emits_codes():
    """tests/test_chain.py:134-156 in the port: a deploy-form block in
    'intc' gives int8 codes on its own grid, within one code of 'int'."""
    blk = BasicBlock(16, 16, deploy=True)
    attach_scheme(blk, port_scheme(SCHEME))
    x = torch.from_numpy(_images(4, 2)).repeat(1, 1, 1, 6)[..., :16]
    calibrate(blk, [x.contiguous()])
    prepare_deploy(blk)
    with torch.no_grad():
        out = blk(x, qmode="intc")
        ref = blk(x, qmode="int")
    assert isinstance(out, QuantizedTensor) and out.q.dtype == torch.int8
    err = float((materialize(out) - ref).abs().max())
    assert err <= 1.5 * out.scale

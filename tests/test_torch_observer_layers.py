"""Every observer of the JAX package wired into the port's quantized
layers, against the JAX package's layers on the same weights (carried over
by ``load_jax_variables``) and the same seeded numpy inputs.

* A toy net of a 3×3 ``QConv``, a depthwise 3×3 ``QConv``, a
  ``QBlockOutput`` closing the two as a residual block, and a ``QDense``
  head, a ReLU after the first conv and in the block output, and nonzero
  biases (ROADMAP hazard C8), in each family (plain/LSQ and FSPTQ); each
  case gives each layer its own input and weight observer (override
  options), so that across the cases every observer calibrates every kind
  of layer, per-channel activations (the plain family) and per-pixel
  weights (convs) included.  Calibration runs two observe passes, so the
  ``minmax*`` and ``percentile*`` inputs come from the stream (per channel
  where the observer is); the block output observes one batch
  (``percentile_tensor`` or ``minmax_tensor``; none for a per-channel
  observer).  Inputs are on the unsigned 8-bit grid, but an l2norm input
  on the signed one: the l2norm fixed point's update ignores the offset,
  and on an unsigned grid it runs some channels off to 0 or NaN,
  differently in each package's compiled form.  Calibrated ``in_scale``,
  ``wt_scale``, ``out_scale`` and offsets against JAX's: minmax to rtol
  1e-5 (the inputs after the first layer carry its float sums, ~1e-6
  apart); the rest to rtol 1e-4, the percentile's float32 index (C15),
  the fixed points' plateaus (one code flipped by the sums' rounding, C2,
  moves them by ~1e-5, tests/test_torch_observers.py) and the output
  observers' conv sums, each passed on to the layers after; zero-points
  exact.  With JAX's calibrated variables bridged in, the fake-quant
  outputs of both nets within 1e-5.
* Integer plans: per-pixel weights and per-channel activations raise
  ``ValueError`` in ``prepare_deploy``, as in the JAX package.
* BASELINE config #2's scheme (percentile_tensor inputs, minmax_channel
  weights, a minmax_tensor head) through ``run_ptq`` on cifar_mobilenet_v2
  at width 0.25, 32×32, batch 8, 2 observe passes, fake-quant and integer
  (``intc``, which the train form runs as ``int``) evaluation, against the
  JAX package's ``run_ptq`` on the same initial weights: fp32 metrics to
  rtol 1e-5; all 53 layers' calibrated scales to rtol 1e-4 (2.6e-5 on
  the CPU: the streamed percentiles' float32 index, C15); the fake-quant
  and integer losses to rtol 5e-3 (1.4e-3 and 9.3e-4 on the CPU; ROADMAP
  C14, MobileNetV2 is chaotic at random weights).  The BN refresh is off:
  its 50 train-mode forwards under fake quant pass every flipped code on,
  and with it the scales part by up to 1.6e-2 on the CPU
  (tests/test_torch_ptq.py holds the refresh's contracts).
"""

import copy
from typing import Any

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from dlmc_quant_tpu.quant import deploy as jdp
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import QBlockOutput as JQBlockOutput
from dlmc_quant_tpu.quant.layers import QConv as JQConv
from dlmc_quant_tpu.quant.layers import QDense as JQDense
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_tpu.training.ptq import run_ptq as jax_run_ptq
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import (QBlockOutput, QConv, QDense,
                                           attach_scheme, calibrate)
from dlmc_quant_torch.training.ptq import run_ptq
from dlmc_quant_torch.utils.checkpoint import save_checkpoint
from dlmc_quant_torch.utils.config import ConfigParser, read_yaml
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables
from dlmc_quant_torch.models import get_model

torch.set_num_threads(1)

LAYERS = ("conv", "dw", "head")
WEIGHT_OBSERVERS = ("minmax_tensor", "l2loss_tensor", "l2norm_tensor",
                    "percentile_tensor", "minmax_channel", "l2loss_channel",
                    "l2norm_channel", "minmax_pixel", "l2norm_pixel",
                    "l2norm_output", "l2norm_output_channel")
INPUT_OBSERVERS = {
    None: ("minmax_tensor", "l2loss_tensor", "l2norm_tensor",
           "percentile_tensor", "minmax_channel", "l2loss_channel",
           "l2norm_channel"),
    # the FSPTQ family's activation scale is one scalar
    "FSPTQ": ("minmax_tensor", "l2loss_tensor", "l2norm_tensor",
              "percentile_tensor", "minmax_channel")}


def _observers(family, case):
    """(input, weight) observer of each layer in ``case``: each layer a step
    further along both lists; a dense layer takes no per-pixel weight; the
    block output (``out_q``) the next input observer."""
    ins = INPUT_OBSERVERS[family]
    out = {}
    for j, layer in enumerate(LAYERS):
        w = WEIGHT_OBSERVERS[(case + j) % len(WEIGHT_OBSERVERS)]
        if layer == "head" and "pixel" in w:
            w = "l2loss_channel"
        out[layer] = (ins[(case + j) % len(ins)], w)
    out["out_q"] = (ins[(case + len(LAYERS)) % len(ins)], "minmax_tensor")
    return out


def _scheme(family, observers):
    return {
        "quantization_type": family,
        "weight": {"enable": True, "type": "minmax_channel",
                   "args": {"n_bits": 4, "signed": True}},
        "input": {"enable": True, "type": "minmax_tensor",
                  "args": {"n_bits": 8, "signed": False}},
        "override_options": [
            {"layers": [layer], "options": {
                "input": {"type": i, "args": {
                    "signed": i.startswith("l2norm")}},
                "weight": {"type": w}}}
            for layer, (i, w) in observers.items()]}


class JToy(fnn.Module):
    scheme: Any = None

    @fnn.compact
    def __call__(self, x, qmode: str = "eval"):
        r = fnn.relu(JQConv(8, (3, 3), padding="SAME", scheme=self.scheme,
                            name="conv")(x, qmode))
        y = JQConv(8, (3, 3), padding="SAME", feature_group_count=8,
                   scheme=self.scheme, name="dw")(r, qmode)
        y = JQBlockOutput(scheme=self.scheme, name="out_q")(y, r, qmode)
        return JQDense(5, scheme=self.scheme, name="head")(
            y.mean(axis=(1, 2)), qmode)


class Toy(nn.Module):
    def __init__(self, scheme):
        super().__init__()
        self.conv = QConv(4, 8, 3, 1, "SAME")
        self.dw = QConv(8, 8, 3, 1, "SAME", groups=8)
        self.out_q = QBlockOutput()
        self.head = QDense(8, 5)
        attach_scheme(self, scheme)

    def forward(self, x, qmode: str = "eval"):
        r = torch.relu(self.conv(x, qmode=qmode))
        y = self.out_q(self.dw(r, qmode=qmode), r, qmode=qmode)
        return self.head(y.mean(dim=(1, 2)), qmode=qmode)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches():
    rng = np.random.default_rng(7)
    return [rng.standard_normal((4, 9, 10, 4)).astype(np.float32) + 0.2
            for _ in range(2)]


def _pair(block):
    """The JAX toy's initial variables (biases made nonzero) and the port's
    toy on them."""
    jm = JToy(scheme=jax_scheme(block))
    v = flax.core.unfreeze(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(_batches()[0])))
    rng = np.random.default_rng(8)
    for layer in LAYERS:
        b = v["params"][layer]["bias"]
        v["params"][layer]["bias"] = jnp.asarray(
            0.3 * rng.standard_normal(b.shape).astype(np.float32))
    return jm, v, load_jax_variables(Toy(scheme_from_dict(block)), _np(v))


def _rtol(observer):
    return 1e-5 if observer.startswith("minmax") else 1e-4


CASES = [(family, case) for family in (None, "FSPTQ")
         for case in range(len(WEIGHT_OBSERVERS))]


@pytest.mark.parametrize("family,case", CASES)
def test_layer_observers_match_jax(family, case):
    observers = _observers(family, case)
    block = _scheme(family, observers)
    jm, v, port = _pair(block)
    batches = _batches()
    jv = _np(jax_calibrate(jm, v, [jnp.asarray(b) for b in batches],
                           observe_passes=2))
    calibrate(port, [torch.from_numpy(b) for b in batches], observe_passes=2)
    out_obs = observers.pop("out_q")[0]
    if "channel" in out_obs:            # no per-channel block grid
        assert port.out_q.cfg is None and "out_q" not in jv["params"]
    else:
        np.testing.assert_allclose(
            port.out_q.out_scale.detach().numpy(),
            jv["params"]["out_q"]["out_scale"], rtol=_rtol(out_obs),
            err_msg=f"out_q {out_obs}")
        np.testing.assert_allclose(
            port.out_q.out_offset.numpy(), jv["qstate"]["out_q"]["out_offset"],
            rtol=_rtol(out_obs), atol=1e-7)
    for layer, (i_obs, w_obs) in observers.items():
        mod, p, q = getattr(port, layer), jv["params"][layer], \
            jv["qstate"][layer]
        assert int(mod.in_stream_count) == 2
        np.testing.assert_allclose(mod.in_scale.detach().numpy(),
                                   p["in_scale"], rtol=_rtol(i_obs),
                                   err_msg=f"{layer} {i_obs}")
        np.testing.assert_allclose(mod.wt_scale.detach().numpy(),
                                   p["wt_scale"], rtol=_rtol(w_obs),
                                   err_msg=f"{layer} {w_obs}")
        if family is None:
            np.testing.assert_allclose(mod.in_offset.numpy(), q["in_offset"],
                                       rtol=_rtol(i_obs), atol=1e-7)
            np.testing.assert_allclose(mod.wt_offset.numpy(), q["wt_offset"],
                                       rtol=_rtol(w_obs), atol=1e-7)
        else:
            np.testing.assert_array_equal(mod.in_offset.numpy(),
                                          q["in_offset"])
    # fake quant on JAX's calibrated variables
    load_jax_variables(port, jv)
    x = _batches()[1]
    want = np.asarray(jm.apply(jv, jnp.asarray(x), qmode="eval"))
    with torch.no_grad():
        got = port(torch.from_numpy(x), qmode="eval").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("what", ["per_pixel_weights",
                                  "per_channel_activations"])
def test_integer_plans_refuse(what):
    """Per-pixel weight scales and per-channel activation scales run fake
    quant only: both packages refuse an integer plan for them."""
    block = _scheme(None, {"conv": (
        "minmax_channel" if what == "per_channel_activations"
        else "minmax_tensor",
        "minmax_pixel" if what == "per_pixel_weights"
        else "minmax_channel")})
    jm, v, port = _pair(block)
    x = _batches()[0]
    jv = jax_calibrate(jm, v, [jnp.asarray(x)])
    calibrate(port, [torch.from_numpy(x)])
    match = ("per-pixel weights have no integer execution plan"
             if what == "per_pixel_weights"
             else "integer path needs per-tensor activation quantization")
    with pytest.raises(ValueError, match=match):
        jdp.prepare_deploy(jm, jv, sample_input=jnp.asarray(x))
    with pytest.raises(ValueError, match="conv: " + match):
        prepare_deploy(port)
    with torch.no_grad():
        assert torch.isfinite(port(torch.from_numpy(x), qmode="eval")).all()


def test_per_pixel_weights_need_a_conv():
    with pytest.raises(ValueError, match="head: per-pixel weight "
                                         "quantization needs a conv kernel"):
        Toy(scheme_from_dict(_scheme(None, {"head": ("minmax_tensor",
                                                     "minmax_pixel")})))


CONFIG_2 = "examples/configs/PTQ_mobilenetv2_imagenet_w8a8_percentile.yaml"


def _toy_config_2(tmp_path):
    """Config #2 on cifar_mobilenet_v2 at width 0.25, 32×32: 16 calibration
    images and 16 eval images at batch 8, 2 observe passes, the integer
    eval on (``intc``, which the train form runs as ``int``), no BN
    refresh."""
    cfg = read_yaml(CONFIG_2)
    cfg["arch"] = {"type": "cifar_mobilenet_v2",
                   "args": {"num_classes": 10, "width_mult": 0.25}}
    for name in ("calibration", "eval"):
        cfg["dataloaders"][name] = {"type": "CIFAR10", "args": {
            "data_dir": str(tmp_path / "no_cifar"), "batch_size": 8,
            "training": name == "calibration", "n_samples": 16}}
    cfg.update(observe_passes=2, eval_int=True, int_qmode="intc",
               bn_recal=False)
    return cfg


def test_config_2_scheme_through_run_ptq(tmp_path):
    cfg = _toy_config_2(tmp_path)
    ref = jax_run_ptq(copy.deepcopy(cfg))
    # the JAX pipeline's initial variables, as its run_ptq makes them
    from dlmc_quant_tpu.data import get_dataloader as jax_get_dataloader
    from dlmc_quant_tpu.models import get_model as jax_get_model
    x0, _ = next(iter(jax_get_dataloader(
        "CIFAR10", **cfg["dataloaders"]["calibration"]["args"])))
    jm = jax_get_model("cifar_mobilenet_v2", num_classes=10, width_mult=0.25)
    jm = jm.clone(scheme=jax_scheme(cfg["quantization"]))
    v0 = jax.jit(jm.init)(jax.random.PRNGKey(cfg["random_seed"]),
                          jnp.asarray(x0))
    start = get_model("cifar_mobilenet_v2", device="cpu", num_classes=10,
                      width_mult=0.25,
                      scheme=scheme_from_dict(cfg["quantization"]))
    load_jax_variables(start, _np(v0))
    save_checkpoint(tmp_path / "start", start.state_dict())
    res = run_ptq(ConfigParser({**cfg, "resume": str(tmp_path / "start")},
                               "cpu", save_to_disk=False))
    for key in ("loss", "accuracy", "top5_acc"):
        np.testing.assert_allclose(res["fp32"][key], ref["fp32"][key],
                                   rtol=1e-5)
    for what in ("quant", "int"):
        np.testing.assert_allclose(res[what]["loss"], ref[what]["loss"],
                                   rtol=5e-3)
    jv = _np(ref["variables"])
    n = 0
    for path, mod in res["model"].named_modules():
        if isinstance(mod, (QConv, QDense)):
            node = jv["params"]
            for part in path.split("."):
                node = node[part]
            for name in ("in_scale", "wt_scale"):
                np.testing.assert_allclose(
                    getattr(mod, name).detach().numpy(), node[name],
                    rtol=1e-4, err_msg=f"{path}.{name}")
            n += 1
    assert n == 53
    assert int(res["model"].block1_0.expand.in_stream_count) == 2
    assert float(res["model"].block1_0.expand.in_stream_pct_sum) > 0

"""Weight-only integer execution against the JAX package: the flagship's
setting, RepVGG-A0's deploy form (full widths, 32×32, 10 classes, batch
4) under the FSPTQ W8A8 scheme, calibrated, then the first layer's
activation quantizer turned off (``disable_act_quant_on``, what
``FSPTQTrainer(disable_first_act_quant=True)`` does) in both packages,
on JAX's calibrated variables.

* ``prepare_deploy``: the stem's plan is its int8 weights (equal to JAX's)
  and per-channel scales (equal), with no activation grid; every other
  layer keeps its integer plan.
* The stem in ``'int'``: the int8 weights dequantized to bf16, a conv of
  bf16 operands with an f32 accumulator and f32 out
  (``dlmc_quant_tpu/quant/layers.py:666-672``), held to relative L2 1e-5
  of JAX's: the products are exact in f32, so only the order of the f32
  sums differs.
* The logits of ``'int'`` and of the chained ``'intc'`` (the stem's float
  output quantized by the next layer) within relative L2 2e-2 of JAX's
  ``'int'``, the bound of the integer paths (tests/test_chain.py).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.quant import deploy as jdeploy
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_tpu.training.fsptq import \
    disable_act_quant_on as jax_disable_act_quant_on
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.quant.config import scheme_from_dict as port_scheme
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.training.fsptq import disable_act_quant_on
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

BATCH, SIZE, CLASSES = 4, 32, 10
STEM = "stage0.reparam"
SCHEME = {"quantization_type": "FSPTQ",
          "weight": {"enable": True, "type": "minmax_channel",
                     "args": {"n_bits": 8, "signed": True}},
          "input": {"enable": True, "type": "minmax_tensor",
                    "args": {"n_bits": 8, "signed": False}}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_weight_only_stem_matches_jax():
    x = np.random.default_rng(0).random((BATCH, SIZE, SIZE, 3),
                                        dtype=np.float32)
    jm = jax_get_model("RepVGG_A0", num_classes=CLASSES, deploy=True,
                       scheme=jax_scheme(SCHEME))
    v0 = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    # seeded non-zero biases, as a fused model has (ROADMAP hazard C8)
    rng = np.random.default_rng(4)
    for name, node in v0["params"].items():
        if "reparam" in node:
            node["reparam"]["bias"] = (0.1 + 0.2 * rng.standard_normal(
                node["reparam"]["bias"].shape)).astype(np.float32)
    v1 = jax_calibrate(jm, jax.tree_util.tree_map(jnp.asarray, v0),
                       [jnp.asarray(x)])
    jm = jax_disable_act_quant_on(jm, STEM)
    v2 = jdeploy.prepare_deploy(jm, v1, sample_input=jnp.asarray(x))
    want, state = jm.apply(v2, jnp.asarray(x), qmode="int",
                           capture_intermediates=True,
                           mutable=["intermediates"])
    want_stem = state["intermediates"]["stage0"]["reparam"]["__call__"][0]
    jplan = _np(v2["qint"])["stage0"]["reparam"]
    assert "in_scale" not in jplan

    port = get_model("RepVGG_A0", device="cpu", num_classes=CLASSES,
                     deploy=True, scheme=port_scheme(SCHEME))
    load_jax_variables(port, _np(v1))
    disable_act_quant_on(port, STEM)
    prepare_deploy(port)
    stem = port.get_submodule(STEM)
    assert stem.weight_only and stem.plan_scalars == {}
    assert torch.equal(stem.w_int, torch.from_numpy(
        np.transpose(jplan["w_int"], (3, 2, 0, 1)).copy()))
    assert torch.equal(stem.w_scale, torch.from_numpy(jplan["w_scale"]))
    for name in port.block_names[1:]:
        conv = getattr(port, name).reparam
        assert not conv.weight_only and conv.plan_scalars["pad_val"] == int(
            _np(v2["qint"])[name]["reparam"]["pad_val"])

    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_stem = stem(xt, qmode="int")
        assert y_stem.dtype == torch.float32
        assert _rel(y_stem, want_stem) <= 1e-5
        for qmode in ("int", "intc"):
            y = port(xt, qmode=qmode)
            assert y.shape == (BATCH, CLASSES) and bool(torch.isfinite(y).all())
            assert _rel(y, want) < 2e-2, qmode

"""The port's MAC counter, compute graph and ``merge_bn`` against the JAX
package's (``dlmc_quant_tpu/utils/count_ops.py``,
``dlmc_quant_tpu/models/fuse.py: merge_bn``), and the FSPTQ entry's
choice between a fuser and ``merge_bn``.

* ``count_ops`` and ``get_compute_graph`` (top and bottom styles) equal
  JAX's exactly, as dicts over the same module paths: cifar_resnet20 at
  32×32 (``conv1 == 32·32·16·9·3``, a total between 30e6 and 50e6, as
  tests/test_aux_utils.py), RepVGG-A0's train form at widths 0.25 (the
  ``rbr_dense → rbr_dense_bn`` edge through the permute that feeds the
  port's ``nn.BatchNorm2d``), a grouped and an SE RepVGG, and
  cifar_mobilenet_v2.  The count on the ``meta`` device equals the CPU's
  and scales with the batch.
* ``merge_bn`` on cifar_resnet20 with trained statistics (JAX's
  train-mode forward): the output within rtol 1e-4, atol 1e-5, the folded
  weights within 1e-6 relative of JAX's ``merge_bn`` and its BatchNorms a
  bias-add; the input model untouched; no pair and ``allow_missing=False``
  raises.  (chip_smoke.py's repvgg_zoo phase folds it on the card.)
* The FSPTQ entry's ``to_deploy`` fuses a train-form model with a fuser
  and calls ``merge_bn`` on a deploy-form one, as ``examples/FSPTQuant.py``
  does.
"""

import copy
import importlib.util
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.models.fuse import merge_bn as jax_merge_bn
from dlmc_quant_tpu.models.repvgg import RepVGG as JRepVGG
from dlmc_quant_tpu.models.repvgg import _G4_MAP as J_G4
from dlmc_quant_tpu.utils.count_ops import count_ops as jax_count_ops
from dlmc_quant_tpu.utils.count_ops import \
    get_compute_graph as jax_compute_graph
from dlmc_quant_torch.examples import FSPTQuant
from dlmc_quant_torch.models import fuse
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import merge_bn
from dlmc_quant_torch.models.repvgg import _G4_MAP, RepVGG
from dlmc_quant_torch.utils.count_ops import count_ops, get_compute_graph
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SIZE = 32


def _np(tree):
    import flax
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


# name → (JAX model, port model), both at 10 classes
def _pair(name):
    if name == "repvgg_w025":
        kw = dict(num_blocks=(2, 4, 14, 1), width_multiplier=(0.25,) * 4,
                  num_classes=10)
        return JRepVGG(**kw), RepVGG(**kw)
    if name == "repvgg_g4":
        import flax
        kw = dict(num_blocks=(1, 2, 2, 1), width_multiplier=(0.625,) * 4,
                  num_classes=10)
        return (JRepVGG(override_groups_map=flax.core.FrozenDict(J_G4), **kw),
                RepVGG(override_groups_map=_G4_MAP, **kw))
    if name == "repvgg_se":
        kw = dict(num_blocks=(1, 1, 1, 1), width_multiplier=(0.5,) * 4,
                  num_classes=10, use_se=True)
        return JRepVGG(**kw), RepVGG(**kw)
    return (jax_get_model(name, num_classes=10),
            get_model(name, device="cpu", num_classes=10))


MODELS = ["cifar_resnet20", "repvgg_w025", "repvgg_g4", "repvgg_se",
          "cifar_mobilenet_v2"]


@pytest.mark.parametrize("name", MODELS)
def test_counts_and_graphs_equal_jax(name):
    jm, pm = _pair(name)
    xj, xp = jnp.ones((1, SIZE, SIZE, 3)), torch.ones(1, SIZE, SIZE, 3)
    assert count_ops(pm, xp) == jax_count_ops(jm, xj)
    for style in ("top", "bottom"):
        assert get_compute_graph(pm, xp, style=style) == \
            jax_compute_graph(jm, xj, style=style), style
    if name.startswith("repvgg"):
        g = get_compute_graph(pm, xp)
        assert g["stage0.rbr_dense"] == ["stage0.rbr_dense_bn"]
        assert g["stage1_0.rbr_1x1"] == ["stage1_0.rbr_1x1_bn"]


def test_resnet20_counts():
    m = get_model("cifar_resnet20", device="cpu", num_classes=10)
    counts = count_ops(m, torch.ones(1, SIZE, SIZE, 3))
    assert 30e6 < counts["total"] < 50e6, counts["total"]
    assert counts["conv1"] == 32 * 32 * 16 * 9 * 3
    g = get_compute_graph(m, torch.ones(1, SIZE, SIZE, 3), style="top")
    assert "bn1" in g["conv1"]
    assert "conv1" in get_compute_graph(
        m, torch.ones(1, SIZE, SIZE, 3), style="bottom")["bn1"]
    # the model's modes come back as they were
    m.train()
    count_ops(m, torch.ones(1, SIZE, SIZE, 3))
    assert all(mod.training for mod in m.modules())


def test_counts_on_meta_device():
    cpu = count_ops(get_model("cifar_resnet20", device="cpu"),
                    torch.ones(1, SIZE, SIZE, 3))
    with torch.device("meta"):
        m = get_model("cifar_resnet20", device="meta")
        x = torch.empty(128, SIZE, SIZE, 3)
    counts = count_ops(m, x)
    assert counts == {k: 128 * v for k, v in cpu.items()}
    assert counts["total"] > 1e9


@pytest.fixture(scope="module")
def trained_resnet20():
    """cifar_resnet20 with the statistics of a train-mode forward (JAX's),
    and JAX's merge_bn of it."""
    m = jax_get_model("cifar_resnet20", num_classes=10)
    x = np.random.default_rng(0).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    v = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    _, upd = m.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    v = {**v, "batch_stats": upd["batch_stats"]}
    want = np.asarray(m.apply(v, jnp.asarray(x)))
    folded = _np(jax_merge_bn(m, v, jnp.asarray(x)))
    return {"x": x, "v": _np(v), "want": want, "folded": folded}


def _port_resnet20(v):
    return load_jax_variables(
        get_model("cifar_resnet20", device="cpu", num_classes=10), v)


def test_merge_bn_matches_jax(trained_resnet20):
    t = trained_resnet20
    port = _port_resnet20(t["v"])
    before = copy.deepcopy(port.state_dict())
    merged = merge_bn(port, torch.from_numpy(t["x"][:1]))
    assert merged is not port
    for k, val in port.state_dict().items():     # the input is untouched
        assert torch.equal(val, before[k]), k
    x = torch.from_numpy(t["x"])
    with torch.no_grad():
        np.testing.assert_allclose(merged(x).numpy(), t["want"], rtol=1e-4,
                                   atol=1e-5)
    ref = _port_resnet20(t["folded"])
    n_bn = 0
    for (name, got), (_, want) in zip(merged.named_modules(),
                                      ref.named_modules()):
        if isinstance(got, torch.nn.BatchNorm2d):
            n_bn += 1
            assert torch.equal(got.weight, torch.ones_like(got.weight))
            assert torch.equal(got.running_mean,
                               torch.zeros_like(got.running_mean))
            np.testing.assert_allclose(got.running_var.numpy(), 1 - 1e-5)
        if hasattr(got, "weight") and got.weight is not None:
            for attr in ("weight", "bias"):
                a, b = getattr(got, attr), getattr(want, attr)
                if a is None:
                    continue
                np.testing.assert_allclose(
                    a.detach().numpy(), b.detach().numpy(), rtol=1e-6,
                    atol=1e-6 * float(b.abs().max()), err_msg=name)
    assert n_bn == 19
    # the kernels changed: γ/σ absorbed
    assert not torch.allclose(merged.conv1.weight, port.conv1.weight)


def test_merge_bn_nothing_to_fold():
    deploy = RepVGG(num_blocks=(1, 1, 1, 1), width_multiplier=(0.25,) * 4,
                    num_classes=10, deploy=True)
    x = torch.ones(1, SIZE, SIZE, 3)
    out = merge_bn(deploy, x)          # allow_missing: nothing folds
    for (k, a), (_, b) in zip(out.state_dict().items(),
                              deploy.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="no conv"):
        merge_bn(deploy, x, allow_missing=False)


def _jax_entry():
    """``examples/FSPTQuant.py`` as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        "jax_fsptq_entry", REPO / "examples" / "FSPTQuant.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fsptq_entry_reaches_merge_bn(monkeypatch):
    entry = _jax_entry()
    # the port's fusers are the JAX entry's for the families it has
    for family, fuser in FSPTQuant.FUSERS.items():
        assert entry.FUSERS[family].__name__ == fuser.__name__, family
    calls = []
    real = fuse.merge_bn

    def spy(model, example, **kw):
        calls.append(type(model).__name__)
        return real(model, example, **kw)

    monkeypatch.setattr(FSPTQuant, "merge_bn", spy)
    log = logging.getLogger("fsptq")
    x = torch.from_numpy(np.random.default_rng(1).random(
        (1, SIZE, SIZE, 3), dtype=np.float32))
    kw = dict(num_blocks=(1, 1, 1, 1), width_multiplier=(0.25,) * 4,
              num_classes=10)
    deploy = RepVGG(deploy=True, **kw)
    out = FSPTQuant.to_deploy(deploy, log, x)
    assert calls == ["RepVGG"] and out is not deploy
    with torch.no_grad():
        assert torch.equal(out(x, qmode="fp"), deploy(x, qmode="fp"))
    # a train-form model with a fuser is fused, without merge_bn
    fused = FSPTQuant.to_deploy(RepVGG(**kw).eval(), log, x)
    assert fused.deploy and calls == ["RepVGG"]
    # JAX's entry on the deploy form: merge_bn, which folds nothing
    jm = JRepVGG(deploy=True, **kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x.numpy()))
    assert getattr(jm, "deploy", False) and entry.FUSERS.get("RepVGG")
    v2 = entry.merge_bn(jm, v, jnp.asarray(x.numpy()))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(a, b)), _np(v), _np(v2)))


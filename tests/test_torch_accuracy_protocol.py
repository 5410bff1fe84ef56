"""The port's accuracy protocol (``python -m
dlmc_quant_torch.tools.accuracy_protocol``) against the JAX package's
``tools/accuracy_protocol.py``:

* ``w_scheme(8)``, ``w_scheme(4)``, ``w_scheme(4, "adaround",
  "l2loss_channel")`` and ``qat_scheme`` (LSQ, RootQ): every quantized
  layer of cifar_resnet20 (train form) and RepVGG-A0 (train and deploy
  form) resolves to the JAX tool's config, the 8-bit overrides and
  ``recon_type: None`` included; both packages find the same first
  quantized layer and take its activation quant off (ROADMAP C11);
* the hard 100-class synthetic CIFAR, training and held-out splits and
  the first augmented batch, equal to the JAX package's arrays (the
  batch within one ulp of its native C++ assembly, ROADMAP C10);
* the two QAT optimizer groups against the JAX tool's optax
  ``multi_transform`` in float64: each group's update at steps 0, 20 and
  the last, with zero gradients (weight decay alone: the main group
  moves, ``wt_alpha`` does not) and with seeded gradients, within rtol
  1e-6, and each group's rate at every step within 1e-9 (the JAX
  schedules compute in float32);
* the three sections at toy size on the CPU (64 training images at
  batch 16, 32 held-out, 1 epoch, 16 calibration images, 4
  reconstruction iterations): every table value finite, the table
  appended to a temporary ``--out``;
* the tool imports neither JAX nor the JAX package (a clean interpreter),
  needs a card unless ``--device cpu`` is given, and refuses to write
  ``RESULTS.md``.
"""

import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from dlmc_quant_torch.data.loaders import CIFAR10
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import repvgg_fuse
from dlmc_quant_torch.quant.layers import QLayer, attach_scheme
from dlmc_quant_torch.tools import accuracy_protocol as AP
from dlmc_quant_torch.training.fsptq import (disable_act_quant_on,
                                             first_quant_path)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HARD = {"synthetic_profile": "hard", "_n_classes": 100}
SCHEMES = {"w8": ("w_scheme", (8,)), "w4": ("w_scheme", (4,)),
           "w4_adaround": ("w_scheme", (4, "adaround", "l2loss_channel")),
           "lsq": ("qat_scheme", (None,)), "rootq": ("qat_scheme", ("RootQ",))}
MODELS = ("cifar_resnet20", "RepVGG_A0", "RepVGG_A0_deploy")


@pytest.fixture(scope="module")
def jax_tool():
    """``tools/accuracy_protocol.py`` as a module.  Its import points
    JAX's compilation cache at a fixed directory; that one update is
    dropped, so that the cache setting never leaves this process's."""
    cache = jax.config.jax_compilation_cache_dir
    update = jax.config.update

    def keep_cache(name, value):
        if name != "jax_compilation_cache_dir":
            update(name, value)

    spec = importlib.util.spec_from_file_location(
        "jax_accuracy_protocol", REPO / "tools" / "accuracy_protocol.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jax.config, "update", keep_cache):
        spec.loader.exec_module(mod)
    assert jax.config.jax_compilation_cache_dir == cache
    return mod


def _port_model(name):
    deploy = name.endswith("_deploy")
    model = get_model(name.removesuffix("_deploy"), device="cpu",
                      num_classes=100,
                      generator=torch.Generator().manual_seed(0))
    return repvgg_fuse(model) if deploy else model


def _jax_layer_paths(name):
    """Paths of the JAX model's quantized layers (their kernels), from
    the shapes of its variables."""
    from dlmc_quant_tpu.models import get_model as jax_get_model
    from dlmc_quant_tpu.models.fuse import repvgg_fuse as jax_fuse
    import flax
    jm = jax_get_model(name.removesuffix("_deploy"), num_classes=100)
    x = jax.numpy.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(
        lambda key: jax_fuse(jm, jm.init(key, x), x)[1]
        if name.endswith("_deploy") else jm.init(key, x),
        jax.random.PRNGKey(0))["params"]
    return {".".join(k[:-1]) for k in flax.traverse_util.flatten_dict(
        shapes) if k[-1] == "kernel"}


@pytest.mark.parametrize("name", MODELS)
def test_schemes_resolve_as_in_the_jax_tool(jax_tool, name):
    model = _port_model(name)
    paths = [p for p, m in model.named_modules() if isinstance(m, QLayer)]
    assert set(paths) == _jax_layer_paths(name)
    eight = {"cifar_resnet20": {"conv1", "linear"},
             "RepVGG_A0": {"linear"} | {p for p in paths
                                        if p.startswith("stage0.")},
             }
    eight["RepVGG_A0_deploy"] = eight["RepVGG_A0"]
    for key, (fn, args) in SCHEMES.items():
        port, ref = getattr(AP, fn)(*args), getattr(jax_tool, fn)(*args)
        assert port.quantization_type == ref.quantization_type, key
        for path in paths:
            got, want = port.resolve(path), ref.resolve(path)
            assert got.to_dict() == want.to_dict(), (key, path)
            bits = got.weight.n_bits
            if key.startswith("w4"):
                assert bits == (8 if path in eight[name] else 4), path
                assert got.weight.recon_type == (
                    "adaround" if key == "w4_adaround"
                    and path not in eight[name] else None), path
            elif key in ("lsq", "rootq"):
                eight_q = path in ("conv1", "linear")
                assert (bits, got.input.n_bits) == ((8, 8) if eight_q
                                                    else (4, 4)), path
            else:
                assert bits == 8 and got.weight.type == "minmax_channel"


@pytest.mark.parametrize("name", ["cifar_resnet20", "RepVGG_A0_deploy"])
def test_first_layer_loses_its_act_quant_in_both(jax_tool, name):
    """C11: the layer ``disable_first_act_quant`` acts on, and its
    resolved config after, in both packages."""
    from dlmc_quant_tpu.models import get_model as jax_get_model
    from dlmc_quant_tpu.training import fsptq as jax_fsptq
    x = np.random.default_rng(0).random((1, 32, 32, 3), dtype=np.float32)
    jm = jax_get_model(name.removesuffix("_deploy"), num_classes=100,
                       scheme=jax_tool.w_scheme(8),
                       deploy=name.endswith("_deploy"))
    v = jm.init(jax.random.PRNGKey(0), jax.numpy.asarray(x))
    want = jax_fsptq.first_quant_path(jm, v, jax.numpy.asarray(x))
    port = attach_scheme(_port_model(name), AP.w_scheme(8))
    got = first_quant_path(port, torch.from_numpy(x))
    assert got == want == ("conv1" if name == "cifar_resnet20"
                           else "stage0.reparam")
    jcfg = jax_fsptq.disable_act_quant_on(jm, want).scheme.resolve(want)
    disable_act_quant_on(port, got)
    assert not port.get_submodule(got).cfg.input.enable
    assert port.get_submodule(got).cfg.to_dict() == jcfg.to_dict()


@pytest.mark.parametrize("training", [True, False])
def test_hard_cifar_equals_jax(training, monkeypatch):
    """The arrays bit for bit; the first batch of an epoch against the
    JAX package's numpy batch assembly bit for bit, and within one ulp of
    its native C++ pass (ROADMAP hazard C10), which the JAX tool ran."""
    from dlmc_quant_tpu.data import native
    from dlmc_quant_tpu.data.loaders import CIFAR10 as JCIFAR10
    port = CIFAR10(batch_size=256, training=training, **HARD)
    with_native = JCIFAR10("data", batch_size=256, training=training, **HARD)
    monkeypatch.setattr(native, "available", lambda: False)
    ref = JCIFAR10("data", batch_size=256, training=training, **HARD)
    assert len(port.dataset) == (10000 if training else 2000)
    np.testing.assert_array_equal(port.dataset.images, ref.dataset.images)
    np.testing.assert_array_equal(port.dataset.labels, ref.dataset.labels)
    assert len(port) == len(ref) == len(with_native)
    for loader in (port, ref, with_native):
        loader.set_epoch(7)
    (xp, yp), (xr, yr), (xn, yn) = (next(iter(loader)) for loader in
                                    (port, ref, with_native))
    np.testing.assert_array_equal(xp, xr)
    np.testing.assert_array_equal(yp, yr)
    np.testing.assert_array_equal(yp, yn)
    np.testing.assert_array_max_ulp(xp, xn, maxulp=1)


class _Layer(torch.nn.Module):
    def __init__(self, w, a):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.wt_alpha = torch.nn.Parameter(torch.from_numpy(a.copy()))


@pytest.mark.parametrize("grads", ["zero", "seeded"])
def test_qat_groups_match_optax(jax_tool, grads):
    """The JAX tool's optimizer (tools/accuracy_protocol.py:112-131) and
    the port's on the same float64 parameters and gradients."""
    import optax
    from dlmc_quant_tpu.training.schedulers import CosineDecayLR
    spe, epochs = 8, 5
    steps = spe * epochs
    rng = np.random.default_rng(0)
    w, a = rng.standard_normal((2, 3)), rng.standard_normal(())
    g_w = rng.standard_normal((steps, 2, 3)) * (grads == "seeded")
    g_a = rng.standard_normal((steps,)) * (grads == "seeded")
    # the float32 rates' error (1e-9) times the momentum trace
    atol = 1e-8 if grads == "seeded" else 1e-11
    layer = torch.nn.Sequential()
    layer.add_module("conv", _Layer(w, np.asarray(a)))
    opt, sched = AP.qat_optimizer(layer, spe, epochs)
    ref_sched = CosineDecayLR(0.01, total_steps=steps, warmup_steps=spe // 2)
    ref_alpha = CosineDecayLR(0.01, total_steps=steps)
    with jax.enable_x64(True):
        params = {"conv": {"kernel": jax.numpy.asarray(w),
                           "wt_alpha": jax.numpy.asarray(a)}}
        tx = optax.multi_transform(
            {"main": optax.chain(optax.add_decayed_weights(1e-4),
                                 optax.sgd(ref_sched, momentum=0.9)),
             "alpha": optax.sgd(ref_alpha, momentum=0.9)},
            {"conv": {"kernel": "main", "wt_alpha": "alpha"}})
        state = tx.init(params)
        for t in range(steps):
            # JAX's schedules compute in float32
            assert opt.lr(0) == pytest.approx(ref_sched(t), abs=1e-9)
            assert opt.lr(1) == pytest.approx(ref_alpha(t), abs=1e-9)
            grad = {"conv": {"kernel": jax.numpy.asarray(g_w[t]),
                             "wt_alpha": jax.numpy.asarray(g_a[t])}}
            upd, state = tx.update(grad, state, params)
            before = [p.detach().clone() for p in layer.parameters()]
            layer.conv.kernel.grad = torch.from_numpy(g_w[t].copy())
            layer.conv.wt_alpha.grad = torch.tensor(g_a[t])
            opt.step()
            if t in (0, 20, steps - 1):
                for p, b, u in zip(layer.parameters(), before,
                                   (upd["conv"]["kernel"],
                                    upd["conv"]["wt_alpha"])):
                    np.testing.assert_allclose((p.detach() - b).numpy(),
                                               np.asarray(u), rtol=1e-6,
                                               atol=atol, err_msg=str(t))
            params = optax.apply_updates(params, upd)
    assert not (layer.conv.kernel.detach().numpy() == w).any()
    if grads == "zero":
        assert float(layer.conv.wt_alpha.detach()) == float(a)
    [(main, _), (alpha, _)] = opt.groups
    assert main.param_groups[0]["weight_decay"] == 1e-4
    assert alpha.param_groups[0]["weight_decay"] == 0.0
    assert [p for g in alpha.param_groups for p in g["params"]] == [
        layer.conv.wt_alpha]


def test_sections_at_toy_size(tmp_path, monkeypatch):
    out = tmp_path / "RESULTS_torch.md"
    monkeypatch.setattr(AP, "CAL_IMAGES", 16)
    args = AP.parse_args(["--device", "cpu", "--out", str(out), "--epochs",
                          "1", "--qat-epochs", "1", "--recon-iters", "4",
                          "--batch", "16"])
    train_l = CIFAR10(batch_size=16, training=True, n_samples=64, **HARD)
    eval_l = CIFAR10(batch_size=16, training=False, n_samples=32, **HARD)
    results = AP.run(args, train_l, eval_l)
    values = AP.table_values(results)
    assert len(values) == 4 + 3 + 6 + 2 + 4 + 1 + 2
    assert all(math.isfinite(v) for v in values), values
    assert [r["blocks"] for r in results["resnet"]["rows"]] == [11] * 3
    assert results["repvgg"]["blocks"] == 23
    assert results["repvgg"]["conv_calls"] == 21
    # the plain versions ran on the CPU: no kernel launched
    assert [r.get("launches", 0) for r in results["repvgg"]["rows"]] == \
        [0, 0, 0]
    # the card-against-CPU figures, here a CPU against its copy: equal
    x = torch.from_numpy(next(iter(eval_l))[0][:4])
    for model in (results["qat"]["models"]["RootQ"],
                  results["repvgg"]["qmodel"]):
        assert AP.card_vs_cpu(model, x) == (0.0, 0.0)
    AP.write(results, args, "cpu")
    text = out.read_text()
    assert text.startswith("# RESULTS_torch")
    for heading in ("## cifar_resnet20 — fp32 vs FSPTQ PTQ",
                    "## cifar_resnet20 — QAT W4A4",
                    "## RepVGG_A0 — branch-fuse"):
        assert text.count(heading) == 1, heading
    assert text.count("Backend: cpu.") == 3
    assert text.count("| RootQ W4A4 QAT |") == 1
    assert "| W4A8 FSPTQ (l2loss clip + AdaRound) |" in text


def test_tool_needs_a_card_and_leaves_results_md_alone(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AP.main(["--out", "elsewhere.md"])
    before = (REPO / "RESULTS.md").read_bytes()
    with pytest.raises(SystemExit, match="RESULTS.md"):
        AP.main(["--device", "cpu", "--out", str(REPO / "RESULTS.md")])
    assert (REPO / "RESULTS.md").read_bytes() == before
    assert AP.parse_args([]).out == "RESULTS_torch.md"


def test_import_leaves_out_jax():
    code = ("import sys, dlmc_quant_torch.tools.accuracy_protocol\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'optax', 'dlmc_quant_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})

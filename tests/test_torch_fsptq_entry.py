"""The port's FSPTQ entry point and what it runs on: config, losses,
metrics, evaluation, checkpoints, and the import guard.

* ``python -m dlmc_quant_torch.examples.FSPTQuant --device cpu`` runs the
  whole path (RepVGG-A0 at 32×32, 1000 classes, synthetic ImageNet, a few
  iterations a block) in a subprocess held to one thread, logs the
  teacher and student metrics and writes a checkpoint that loads back into
  the model; without ``--device cpu`` and without a card it raises.
* Losses and metrics equal the JAX package's within 1e-6 (relative) on
  seeded logits; ``evaluate`` on the same model and loader within 1e-5.
* The entry fuses the ResNets (``resnet_deploy``), as the JAX entry does:
  a cifar_resnet20 config runs through it, and its path up to the
  reconstruction matches the JAX entry's on the same weights.
"""

import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.models import get_model as jax_get_model
from dlmc_quant_tpu.models.fuse import resnet_deploy as jax_resnet_deploy
from dlmc_quant_tpu.models.repvgg import RepVGG as JRepVGG
from dlmc_quant_tpu.quant.config import scheme_from_dict as jax_scheme
from dlmc_quant_tpu.quant.layers import calibrate as jax_calibrate
from dlmc_quant_tpu.training import losses as jlosses
from dlmc_quant_tpu.training import metrics as jmetrics
from dlmc_quant_tpu.training.ptq import evaluate as jax_evaluate
from dlmc_quant_torch.data import get_dataloader
from dlmc_quant_torch.examples import FSPTQuant
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.models.fuse import resnet_deploy
from dlmc_quant_torch.models.repvgg import RepVGG
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.layers import attach_scheme, calibrate
from dlmc_quant_torch.training.losses import get_loss
from dlmc_quant_torch.training.metrics import get_metric
from dlmc_quant_torch.training.ptq import evaluate
from dlmc_quant_torch.utils.checkpoint import load_checkpoint
from dlmc_quant_torch.utils.config import ConfigParser, read_yaml, write_yaml
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables
from dlmc_quant_torch.utils.logging import get_logger

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# the entry's subprocess gets one thread: the suite runs several workers on
# as many cores, and OpenMP threads at the default count, each waiting at
# every parallel region for the slowest, ran out the 300 s limit there
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
FLAGSHIP = REPO / "examples" / "configs" / "FSPTQ_repvgg_a0_w8a8.yaml"


def _config(tmp_path) -> Path:
    """The flagship YAML cut to 32×32, 32 calibration images and 3
    iterations a block."""
    cfg = read_yaml(FLAGSHIP)
    cfg["save_dir"] = str(tmp_path / "saved")
    cfg["train_sample_num"] = 32
    for name, n in (("train", 32), ("eval", 16)):
        cfg["dataloaders"][name]["args"].update(
            data_dir=str(tmp_path / "no_imagenet"), n_samples=n,
            batch_size=16, size=32)
    cfg["trainer"].update(epochs=3, recon_batch=8)
    path = tmp_path / "cfg.yaml"
    write_yaml(cfg, path)
    return path


def test_entry_runs_on_cpu(tmp_path):
    cfg = _config(tmp_path)
    run = subprocess.run(
        [sys.executable, "-m", "dlmc_quant_torch.examples.FSPTQuant",
         "-c", str(cfg), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=ONE_THREAD)
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout
    assert "disabled activation quant on first layer stage0.reparam" in out
    assert "reconstructing 23 blocks" in out
    for line in ("FP teacher: {", "RepAPQ quantized: {"):
        assert line in out and "'top5_acc'" in out.split(line)[1], out
    (ckpt,) = (tmp_path / "saved" / "models").glob("*/*/fsptq_model")
    state, meta = load_checkpoint(ckpt)
    assert len(meta["block_losses"]) == 23
    model = RepVGG(deploy=True, scheme=scheme_from_dict(
        read_yaml(cfg)["quantization"]))
    model.load_state_dict(state)                 # strict: every key
    assert int(model.stage3_0.reparam.in_stream_count) == 2


def test_entry_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FSPTQuant.main(["-c", str(_config(tmp_path))])


def test_config_parser(tmp_path):
    cfg = _config(tmp_path)
    parsed = ConfigParser.from_args(["-c", str(cfg)], save_to_disk=False)
    assert parsed.device == "cuda" and parsed.seed == 123
    assert parsed.save_dir is None
    assert parsed.init_obj("arch", lambda t, **kw: (t, kw)) == (
        "RepVGG_A0", {"num_classes": 1000})
    with pytest.raises(SystemExit):
        ConfigParser.from_args(["-c", str(cfg), "--device", "tpu"])
    saved = ConfigParser(read_yaml(cfg), "cpu", run_id="r")
    assert read_yaml(saved.save_dir / "config.yaml")["random_seed"] == 123


@pytest.mark.parametrize("name,port,ref", [
    ("cross_entropy", get_loss, jlosses), ("l2_loss", get_loss, jlosses),
    ("accuracy", get_metric, jmetrics), ("top5_acc", get_metric, jmetrics)])
def test_losses_and_metrics_match_jax(name, port, ref):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((64, 1000)).astype(np.float32)
    if name == "l2_loss":
        other = rng.standard_normal((64, 1000)).astype(np.float32)
    else:
        other = rng.integers(0, 1000, 64)
        other[:16] = logits[:16].argmax(-1)                  # top-1 hits
        other[16:32] = np.argsort(logits[16:32], -1)[:, -3]  # top-5 hits
    got = float(port(name)(torch.from_numpy(logits), torch.from_numpy(other)))
    want = float(getattr(ref, name)(jnp.asarray(logits), jnp.asarray(other)))
    assert got == pytest.approx(want, rel=1e-6)


def test_evaluate_matches_jax(tmp_path):
    """One small RepVGG (1000 classes, the loader's), JAX weights, the
    port's synthetic ImageNet loader fed to both evaluations."""
    arch = dict(num_blocks=(1, 1, 1, 1), width_multiplier=(0.25,) * 4,
                num_classes=1000)
    loader = get_dataloader("ImageNet", data_dir=str(tmp_path / "none"),
                            training=False, n_samples=24, batch_size=8,
                            size=32)
    jm = JRepVGG(deploy=True, **arch)
    jv = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    want = jax_evaluate(jm, jv, loader, jlosses.cross_entropy,
                        {"accuracy": jmetrics.accuracy,
                         "top5_acc": jmetrics.top5_acc}, qmode="fp")
    port = load_jax_variables(RepVGG(deploy=True, **arch).eval(),
                              jax.tree_util.tree_map(np.asarray, jv))
    got = evaluate(port, loader, get_loss("cross_entropy"),
                   {"accuracy": get_metric("accuracy"),
                    "top5_acc": get_metric("top5_acc")}, qmode="fp")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


def test_new_modules_leave_out_jax():
    mods = ["dlmc_quant_torch", "dlmc_quant_torch.examples.FSPTQuant",
            "dlmc_quant_torch.training.fsptq", "dlmc_quant_torch.training.ptq",
            "dlmc_quant_torch.training.losses",
            "dlmc_quant_torch.training.metrics",
            "dlmc_quant_torch.training.schedulers",
            "dlmc_quant_torch.data.loaders", "dlmc_quant_torch.utils.config",
            "dlmc_quant_torch.utils.logging",
            "dlmc_quant_torch.utils.checkpoint"]
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'optax', 'dlmc_quant_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _resnet20_config(tmp_path) -> dict:
    """The flagship's YAML on cifar_resnet20 (10 classes, synthetic
    CIFAR-10 at 32×32): 16 calibration images, 8 eval images, batch 8, 2
    iterations a block."""
    cfg = read_yaml(FLAGSHIP)
    cfg["arch"] = {"type": "cifar_resnet20", "args": {"num_classes": 10}}
    cfg["save_dir"] = str(tmp_path / "saved")
    cfg["train_sample_num"] = 16
    for name, n in (("train", 16), ("eval", 8)):
        cfg["dataloaders"][name] = {"type": "CIFAR10", "args": {
            "data_dir": str(tmp_path / "no_cifar"), "batch_size": 8,
            "training": name == "train", "n_samples": n}}
    cfg["trainer"].update(epochs=2, recon_batch=8)
    return cfg


def test_entry_fuses_cifar_resnet20(tmp_path):
    """The entry maps CifarResNet (and CifarResNetLarge) to resnet_deploy,
    as the JAX entry does (examples/FSPTQuant.py:37-40): a cifar_resnet20
    config runs through to its chained int8 evaluation."""
    assert FSPTQuant.FUSERS["CifarResNet"] is resnet_deploy
    assert FSPTQuant.FUSERS["CifarResNetLarge"] is resnet_deploy
    path = tmp_path / "cfg.yaml"
    write_yaml(_resnet20_config(tmp_path), path)
    assert FSPTQuant.main(["-c", str(path), "--device", "cpu"]) == 0
    (ckpt,) = (tmp_path / "saved" / "models").glob("*/*/fsptq_model")
    _, meta = load_checkpoint(ckpt)
    assert len(meta["block_losses"]) == 11   # the stem, 9 blocks, the head


def test_resnet20_entry_path_matches_jax(tmp_path):
    """The entry's path up to reconstruction on JAX's train-form weights
    (BN statistics perturbed): fuse (FUSERS), the scheme on a copy,
    calibrate with one observe pass per batch, against the JAX entry's path
    (its FUSERS, ``init`` of the quantized twin, the fused params copied
    in, ``calibrate``).  The fused teacher's fp logits within relative L2
    1e-4; every calibrated scale within rtol 1e-5; the student's fake-quant
    logits within relative L2 2e-2, as tests/test_torch_resnet.py holds
    whole quantized ResNets (a rounding that a float difference flips
    compounds through the layers after it: 1.2e-3 measured on the CPU)."""
    cfg = _resnet20_config(tmp_path)
    batches = [x for x, _ in get_dataloader(
        "CIFAR10", **cfg["dataloaders"]["train"]["args"])]
    x0 = jnp.asarray(batches[0])
    jm = jax_get_model("cifar_resnet20", num_classes=10)
    v = flax.core.unfreeze(jax.jit(jm.init)(jax.random.PRNGKey(1), x0))
    rng = np.random.default_rng(2)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.random(a.shape, dtype=np.float32),
        v["batch_stats"])
    jdm, dv = jax_resnet_deploy(jm, v, x0)
    jq = dataclasses.replace(jdm, scheme=jax_scheme(cfg["quantization"]))
    qv = flax.core.unfreeze(jax.jit(jq.init)(jax.random.PRNGKey(0), x0))
    flat = flax.traverse_util.flatten_dict(qv["params"])
    flat.update(flax.traverse_util.flatten_dict(dv["params"]))
    qv["params"] = flax.traverse_util.unflatten_dict(flat)
    qv = jax_calibrate(jq, qv, [jnp.asarray(b) for b in batches],
                       observe_passes=len(batches))

    model = load_jax_variables(
        get_model("cifar_resnet20", device="cpu", num_classes=10),
        jax.tree_util.tree_map(np.asarray, v))
    fp = FSPTQuant.to_deploy(model, get_logger("fsptq"))
    q = attach_scheme(copy.deepcopy(fp), scheme_from_dict(
        cfg["quantization"]))
    calibrate(q, [torch.from_numpy(b) for b in batches],
              observe_passes=len(batches))
    x = batches[1]
    with torch.no_grad():
        got_fp = fp(torch.from_numpy(x), qmode="fp").numpy()
        got = q(torch.from_numpy(x), qmode="eval").numpy()
    want_fp = np.asarray(jdm.apply(dv, jnp.asarray(x), qmode="fp"))
    want = np.asarray(jq.apply(qv, jnp.asarray(x), qmode="eval"))
    assert np.linalg.norm(got_fp - want_fp) < 1e-4 * np.linalg.norm(want_fp)
    assert np.linalg.norm(got - want) < 2e-2 * np.linalg.norm(want)
    n = 0
    for path, mod in q.named_modules():
        if hasattr(mod, "wt_scale"):
            node = qv["params"]
            for part in path.split("."):
                node = node[part]
            for name in ("in_scale", "wt_scale"):
                np.testing.assert_allclose(
                    getattr(mod, name).detach().numpy(),
                    np.asarray(node[name]), rtol=1e-5, err_msg=path)
            n += 1
    assert n == 20       # 19 convs (option-A shortcuts have none), the head

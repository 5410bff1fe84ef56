"""The port's FSPTQ entry point and what it runs on: config, losses,
metrics, evaluation, checkpoints, and the import guard.

* ``python -m dlmc_quant_torch.examples.FSPTQuant --device cpu`` runs the
  whole path (RepVGG-A0 at 32×32, 1000 classes, synthetic ImageNet, a few
  iterations a block) in a subprocess, logs the teacher and student
  metrics and writes a checkpoint that loads back into the model; without
  ``--device cpu`` and without a card it raises.
* Losses and metrics equal the JAX package's within 1e-6 (relative) on
  seeded logits; ``evaluate`` on the same model and loader within 1e-5.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlmc_quant_tpu.models.repvgg import RepVGG as JRepVGG
from dlmc_quant_tpu.training import losses as jlosses
from dlmc_quant_tpu.training import metrics as jmetrics
from dlmc_quant_tpu.training.ptq import evaluate as jax_evaluate
from dlmc_quant_torch.data import get_dataloader
from dlmc_quant_torch.examples import FSPTQuant
from dlmc_quant_torch.models.repvgg import RepVGG
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.training.losses import get_loss
from dlmc_quant_torch.training.metrics import get_metric
from dlmc_quant_torch.training.ptq import evaluate
from dlmc_quant_torch.utils.checkpoint import load_checkpoint
from dlmc_quant_torch.utils.config import ConfigParser, read_yaml, write_yaml
from dlmc_quant_torch.utils.jax_bridge import load_jax_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
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
        cwd=REPO, capture_output=True, text=True, timeout=300)
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

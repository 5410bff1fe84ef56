"""The port's training entries end to end on the CPU, each in a subprocess
with ``--device cpu``: ``python -m dlmc_quant_torch.examples.
quantization_aware_training`` on both QAT configs (LSQ and RootQ W4A4)
and ``python -m dlmc_quant_torch.examples.classification`` on the fp32
baseline, each at full width (cifar_resnet20) but cut to toy size in a
copied YAML: 48 images of the synthetic CIFAR-10 fallback at batch 16
(``validation_split`` as configured: 4 held out, 2 steps an epoch), 2
epochs, a checkpoint every epoch, one run.  A ``tensorboard`` stub that
fails to import stands first on the child's ``PYTHONPATH``, so the
trainer's writer takes its no-op path (importing the real one pulls in
TensorFlow, ~17 s).

Each run must log finite metrics and write ``checkpoint-epoch1``,
``checkpoint-epoch2`` and the best checkpoint, each holding the model, the
optimizer's state (its update count) and the step.  Resumed with ``-r`` from
``checkpoint-epoch1`` the run trains epoch 2 only and ends on the same
numbers as the uninterrupted run (the CPU is deterministic): the momentum
buffers came back with the weights.

The PTQ pipeline's ``resume`` (a config key, as in the JAX package) loads
a checkpoint's weights before calibrating: a trainer's checkpoint (its
``model`` entry) or a weights-only one, here of the fp model, whose
quantizer state calibration then sets.
"""

import ast
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.training.ptq import run_ptq
from dlmc_quant_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dlmc_quant_torch.utils.config import ConfigParser, read_yaml, write_yaml

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "examples" / "configs"
ENTRIES = {
    "QAT_lsq_resnet20_cifar10_w4a4": "quantization_aware_training",
    "RootQ_resnet20_cifar10_w4a4": "quantization_aware_training",
    "baseline_resnet20_cifar10": "classification",
}
STEPS_PER_EPOCH = 2


def _toy_config(name: str, tmp_path: Path) -> Path:
    cfg = read_yaml(CONFIGS / f"{name}.yaml")
    cfg["train_loader"]["args"].update(batch_size=16, n_samples=48)
    cfg["n_runs"] = 1
    cfg["trainer"].update(epochs=2, save_period=1)
    cfg["save_dir"] = str(tmp_path / "saved")
    path = tmp_path / f"{name}.yaml"
    write_yaml(cfg, path)
    return path


def _run(entry: str, stub: Path, *args) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, [str(stub), os.environ.get("PYTHONPATH")])))
    run = subprocess.run(
        [sys.executable, "-m", f"dlmc_quant_torch.examples.{entry}",
         *args, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    return run.stdout


def _no_tensorboard(tmp_path: Path) -> Path:
    """A directory whose ``tensorboard`` package fails to import."""
    pkg = tmp_path / "stub" / "tensorboard"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text(
        'raise ImportError("tensorboard stubbed out")\n')
    return pkg.parent


def _final(log: str) -> dict:
    (line,) = re.findall(r"run 0 final: (\{.*\})", log)
    return ast.literal_eval(line)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_trains_checkpoints_and_resumes(name, tmp_path):
    entry, stub = ENTRIES[name], _no_tensorboard(tmp_path)
    log = _run(entry, stub, "-c", str(_toy_config(name, tmp_path)))
    result = _final(log)
    assert {"loss", "accuracy", "val_loss", "val_accuracy"} <= result.keys()
    assert all(math.isfinite(v) for v in result.values())
    (run_dir,) = (tmp_path / "saved" / "models").glob("*/*")
    for ckpt in ("checkpoint-epoch1", "checkpoint-epoch2",
                 "model_best-val_accuracy"):
        assert (run_dir / ckpt / "state_dict.pt").is_file(), ckpt
    tree, meta = load_checkpoint(run_dir / "checkpoint-epoch1")
    assert meta["epoch"] == 1
    assert tree["step"] == tree["optimizer"]["count"] == STEPS_PER_EPOCH
    assert any(opt["state"] for opt in tree["optimizer"]["groups"])
    if "quantization" in read_yaml(run_dir / "config.yaml"):
        assert any(k.endswith(("in_scale", "wt_scale", "wt_alpha"))
                   for k in tree["model"])
    epoch2 = json.loads((run_dir / "checkpoint-epoch2" / "metadata.json")
                        .read_text())

    resumed = _run(entry, stub, "-r", str(run_dir / "checkpoint-epoch1"))
    assert "at epoch 2" in resumed and "epoch 1 [" not in resumed
    again = _final(resumed)
    assert again == result
    assert again["loss"] == epoch2["loss"]


@pytest.mark.parametrize("trainer_tree", [True, False],
                         ids=["trainer", "weights_only"])
def test_ptq_resume_loads_the_checkpoint(trainer_tree, tmp_path):
    torch.set_num_threads(1)
    cfg = read_yaml(CONFIGS / "PTQ_resnet18_cifar10_w8a8.yaml")
    cfg["arch"] = {"type": "cifar_resnet20", "args": {"num_classes": 10}}
    cfg["dataloaders"] = {"calibration": {"type": "CIFAR10", "args": {
        "data_dir": str(tmp_path / "no_cifar"), "batch_size": 8,
        "n_samples": 8, "training": False}}}
    cfg.update(observe_passes=0, bn_recal=False)
    seeded = get_model("cifar_resnet20", device="cpu",
                       generator=torch.Generator().manual_seed(7))
    state = seeded.state_dict()
    tree = {"model": state, "optimizer": {}, "step": 3} if trainer_tree \
        else state
    cfg["resume"] = str(save_checkpoint(tmp_path / "ckpt", tree))
    model = run_ptq(ConfigParser(cfg, "cpu", save_to_disk=False))["model"]
    assert torch.equal(model.conv1.weight, state["conv1.weight"])
    assert torch.equal(model.layer3_2.bn2.running_var,
                       state["layer3_2.bn2.running_var"])

"""The port's PTQ entry point (BASELINE config #1) and what it runs on.

* ``python -m dlmc_quant_torch.examples.post_training_quantization
  --device cpu`` runs the whole config (``cifar_resnet18`` at full width,
  32×32, synthetic CIFAR-10, 4 observe passes, BN refresh, fake-quant and
  chained-int eval) cut to 32 calibration and 16 eval images, in a
  subprocess held to one thread; it logs the fp32, fake-quant and integer
  metrics and writes a checkpoint that loads back into the model.  Without
  ``--device cpu`` and without a card it raises.
* ``run_ptq`` on a tiny ResNet: W8A8 tracks fp32 without the BN refresh,
  the refresh lowers the loss (tests/test_ptq_pipeline.py's contracts), and
  the integer eval tracks the fake-quant eval.
* The synthetic CIFAR loader gives the JAX package's batches, in both
  profiles: the same labels, images within one ulp (hazard C10).
* No module of the port, and not ``chip_smoke.py``, imports JAX or the JAX
  package.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dlmc_quant_tpu.data import get_dataloader as jax_get_dataloader
from dlmc_quant_torch.data import get_dataloader
from dlmc_quant_torch.examples import post_training_quantization as ptq_entry
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.training.ptq import run_ptq
from dlmc_quant_torch.utils.checkpoint import load_checkpoint
from dlmc_quant_torch.utils.config import ConfigParser, read_yaml, write_yaml

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIG_1 = REPO / "examples" / "configs" / "PTQ_resnet18_cifar10_w8a8.yaml"
# a subprocess of the tests gets one thread: the suite runs several workers
# on as many cores, and a child at the default thread count competes with
# all of them
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _config(tmp_path) -> Path:
    """Config #1 with 32 calibration and 16 eval images, and the integer
    eval on, chained."""
    cfg = read_yaml(CONFIG_1)
    cfg["save_dir"] = str(tmp_path / "saved")
    for name, n in (("calibration", 32), ("eval", 16)):
        cfg["dataloaders"][name]["args"].update(
            data_dir=str(tmp_path / "no_cifar"), n_samples=n, batch_size=8)
    cfg.update(eval_int=True, int_qmode="intc")
    path = tmp_path / "cfg.yaml"
    write_yaml(cfg, path)
    return path


def test_entry_runs_on_cpu(tmp_path):
    cfg = _config(tmp_path)
    run = subprocess.run(
        [sys.executable, "-m",
         "dlmc_quant_torch.examples.post_training_quantization",
         "-c", str(cfg), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=ONE_THREAD)
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout
    assert "BN statistics re-estimated under quantization" in out
    assert "calibration done in" in out and "observe=4" in out
    for line in ("FP32 baseline: {", "quantized: {",
                 "quantized (real intc execution): {"):
        assert line in out and "'top5_acc'" in out.split(line)[1], out
    (ckpt,) = (tmp_path / "saved" / "models").glob("*/*/quantized_model")
    state, meta = load_checkpoint(ckpt)
    assert {"fp32", "quant", "int", "config"} <= set(meta)
    assert meta["int"]["loss"] > 0
    model = get_model("cifar_resnet18", device="cpu", scheme=scheme_from_dict(
        read_yaml(cfg)["quantization"]))
    model.load_state_dict(state)                 # strict: every key
    assert int(model.layer4_1.conv2.in_stream_count) == 8   # 4 + 4 passes


def test_entry_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptq_entry.main(["-c", str(_config(tmp_path))])


TINY = {
    "name": "tiny_ptq", "random_seed": 0,
    "arch": {"type": "cifar_resnet20", "args": {"num_classes": 10}},
    "dataloaders": {
        "calibration": {"type": "CIFAR10",
                        "args": {"batch_size": 32, "training": True,
                                 "n_samples": 64}},
        "eval": {"type": "CIFAR10",
                 "args": {"batch_size": 64, "training": False,
                          "n_samples": 128}}},
    "quantization": {
        "quantization_type": None,
        "weight": {"enable": True, "type": "minmax_channel",
                   "args": {"n_bits": 8, "signed": True}},
        "input": {"enable": True, "type": "minmax_tensor",
                  "args": {"n_bits": 8, "signed": False}}},
    "loss": "cross_entropy", "metrics": ["accuracy"], "observe_passes": 2,
}


@pytest.mark.parametrize("bn_recal", [False, True])
def test_run_ptq_contracts(bn_recal, tmp_path):
    cfg = {**copy.deepcopy(TINY), "bn_recal": bn_recal, "eval_int": True,
           "save_dir": str(tmp_path)}
    for spec in cfg["dataloaders"].values():
        spec["args"]["data_dir"] = str(tmp_path / "no_cifar")
    res = run_ptq(ConfigParser(cfg, "cpu", run_id="r"))
    fp, quant, real = res["fp32"], res["quant"], res["int"]
    if bn_recal:
        # init statistics (mean 0, var 1) mis-normalize: the refresh lowers
        # the loss
        assert quant["loss"] < fp["loss"]
    else:
        assert abs(quant["loss"] - fp["loss"]) / fp["loss"] < 0.05
    assert abs(real["loss"] - quant["loss"]) / quant["loss"] < 0.05
    assert not res["model"].training
    assert (tmp_path / "models" / "tiny_ptq" / "r" / "quantized_model"
            / "state_dict.pt").exists()


@pytest.mark.parametrize("profile", ["easy", "hard"])
@pytest.mark.parametrize("training", [True, False])
def test_cifar_loader_matches_jax(profile, training, tmp_path):
    kw = dict(data_dir=str(tmp_path / "none"), batch_size=16,
              training=training, n_samples=48, random_sample=True, seed=3,
              synthetic_profile=profile)
    port = list(get_dataloader("CIFAR10", **kw))
    ref = list(jax_get_dataloader("CIFAR10", **kw))
    assert len(port) == len(ref) == 3
    for (x, y), (xr, yr) in zip(port, ref):
        assert x.dtype == np.float32 and x.shape == (16, 32, 32, 3)
        # JAX's native batch assembly multiplies by 1/std, one ulp from
        # numpy's division (ROADMAP hazard C10); the draws are the same
        np.testing.assert_array_max_ulp(x, xr, maxulp=1)
        np.testing.assert_array_equal(y, yr)


def test_cifar_folder_is_not_read(tmp_path):
    """A pickle folder without its batch files holds nothing to read: the
    synthetic fallback runs, the JAX package's batch for batch, and
    without ``synthetic_fallback`` the loader raises (the pickles
    themselves: tests/test_torch_data_loaders.py)."""
    (tmp_path / "cifar-10-batches-py").mkdir()
    kw = dict(data_dir=str(tmp_path), batch_size=8, n_samples=16)
    (x, y), = list(get_dataloader("CIFAR10", **kw))[:1]
    (xr, yr), = list(jax_get_dataloader("CIFAR10", **kw))[:1]
    np.testing.assert_array_max_ulp(x, xr, maxulp=1)
    np.testing.assert_array_equal(y, yr)
    with pytest.raises(FileNotFoundError):
        get_dataloader("CIFAR10", synthetic_fallback=False, **kw)


def test_port_leaves_out_jax():
    """Every module of the port, and chip_smoke.py, import without JAX."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "dlmc_quant_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = (f"import importlib, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            f"for m in {mods + ['chip_smoke']!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'optax', 'dlmc_quant_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env=ONE_THREAD)

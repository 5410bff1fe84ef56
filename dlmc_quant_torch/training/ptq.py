"""Post-training quantization: calibrate → (re-estimate BN) → evaluate → save.

Counterpart of ``dlmc_quant_tpu/training/ptq.py``: :func:`bn_recalibrate`,
:func:`evaluate` and the pipeline :func:`run_ptq` that the entry
``python -m dlmc_quant_torch.examples.post_training_quantization`` runs.
"""

from __future__ import annotations

import copy
import time
from typing import Dict

import torch
import torch.nn as nn

from dlmc_quant_torch.data import get_dataloader
from dlmc_quant_torch.device import resolve_device
from dlmc_quant_torch.models import get_model
from dlmc_quant_torch.quant.config import scheme_from_dict
from dlmc_quant_torch.quant.deploy import prepare_deploy
from dlmc_quant_torch.quant.layers import calibrate, full_f32
from dlmc_quant_torch.training.losses import get_loss
from dlmc_quant_torch.training.metrics import get_metric
from dlmc_quant_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dlmc_quant_torch.utils.logging import get_logger


def bn_recalibrate(model, batches, qmode: str = "eval",
                   min_updates: int = 50):
    """Re-estimate BatchNorm running statistics under quantization noise.

    Quantized weights shift every pre-BN distribution, and frozen running
    statistics then mis-normalize (dlmc_quant_tpu/training/ptq.py:29-60).
    Runs training-mode forwards (batch statistics, running update) with the
    quantizers in ``qmode``, cycling ``batches`` until at least
    ``min_updates`` updates have run (0.9⁵⁰ < 1 % of the old statistics
    left).  A model without BatchNorm is returned as it is.  Returns
    ``model``, back in eval mode.
    """
    batches = list(batches)
    if not batches or not any(isinstance(m, nn.BatchNorm2d)
                              for m in model.modules()):
        return model
    passes = -(-min_updates // len(batches))
    model.train()
    try:
        with torch.no_grad(), full_f32():
            for _ in range(passes):
                for b in batches:
                    model(b, qmode=qmode)
    finally:
        model.eval()
    return model


def evaluate(model, loader, loss_fn, metric_fns,
             qmode: str = "eval") -> Dict[str, float]:
    """Sample-weighted mean of the loss and every metric over ``loader``
    (numpy batches), on the model's device, in full f32."""
    device = next(model.parameters()).device
    totals, n = {}, 0
    with torch.inference_mode(), full_f32():
        for x, y in loader:
            x = torch.from_numpy(x).to(device)
            y = torch.from_numpy(y).to(device=device, dtype=torch.int64)
            logits = model(x, qmode=qmode)
            res = {"loss": loss_fn(logits, y)}
            for name, fn in metric_fns.items():
                res[name] = fn(logits, y)
            bs = len(y)
            for k, v in res.items():
                totals[k] = totals.get(k, 0.0) + float(v) * bs
            n += bs
    return {k: v / max(n, 1) for k, v in totals.items()}


def run_ptq(config, logger=None) -> Dict:
    """The whole PTQ pipeline on ``config.device`` (default the card).

    ``config`` is a :class:`~dlmc_quant_torch.utils.config.ConfigParser`
    with the reference's YAML schema.  Build the model with the scheme →
    fp32 eval → ``calibrate`` (``observe_passes`` streaming passes) → with
    BatchNorm, :func:`bn_recalibrate` and ``calibrate`` again → fake-quant
    eval → with ``eval_int: true``, eval through the real integer path
    (``int_qmode``: ``'int'``, or chained ``'intc'``, which a train-form
    model runs as ``'int'``) on a deployed copy → save.  Returns the
    metrics (``fp32``, ``quant``, ``int``) and the calibrated ``model``.
    """
    logger = logger or get_logger("ptq")
    device = resolve_device(config.device)
    get = config.get
    loaders = {name: get_dataloader(spec["type"], **(spec.get("args") or {}))
               for name, spec in config["dataloaders"].items()}
    calib_loader = loaders.get("calibration") or loaders.get("train")
    eval_loader = loaders.get("eval") or loaders.get("valid")

    gen = torch.Generator().manual_seed(config.seed)
    model = config.init_obj("arch", get_model, device=device, generator=gen,
                            scheme=scheme_from_dict(get("quantization")))
    if get("resume"):
        # a weights-only checkpoint, or a trainer's (its "model" entry); an
        # fp checkpoint has no quantizer state, which calibration sets
        tree, _ = load_checkpoint(get("resume"))
        _, unexpected = model.load_state_dict(
            tree["model"] if "optimizer" in tree else tree, strict=False)
        if unexpected:
            raise ValueError(f"{get('resume')}: entries with no place in "
                             f"the model: {unexpected}")
        logger.info("restored checkpoint from %s", get("resume"))
    loss_fn = get_loss(get("loss", "cross_entropy"))
    metric_fns = {m: get_metric(m) for m in get("metrics", ["accuracy"])}

    fp_metrics = None
    if get("eval_fp32", True) and eval_loader is not None:
        fp_metrics = evaluate(model, eval_loader, loss_fn, metric_fns, "fp")
        logger.info("FP32 baseline: %s", fp_metrics)

    t0 = time.perf_counter()
    observe = int(get("observe_passes", 0))
    batches = []
    for x, _ in calib_loader:
        batches.append(torch.from_numpy(x).to(device))
        if len(batches) >= max(observe, 1):
            break
    calibrate(model, batches, observe_passes=observe)
    has_bn = any(isinstance(m, nn.BatchNorm2d) for m in model.modules())
    if get("bn_recal", True) and has_bn:
        # refresh the BN statistics, then re-observe the activation scales
        # against them
        bn_recalibrate(model, batches)
        calibrate(model, batches, observe_passes=observe)
        logger.info("BN statistics re-estimated under quantization")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    logger.info("calibration done in %.2fs (%d batch(es), observe=%d)",
                time.perf_counter() - t0, len(batches), observe)

    q_metrics = None
    if eval_loader is not None:
        q_metrics = evaluate(model, eval_loader, loss_fn, metric_fns, "eval")
        logger.info("quantized: %s", q_metrics)

    int_metrics = None
    if get("eval_int", False) and eval_loader is not None:
        int_qmode = get("int_qmode", "int")
        deployed = prepare_deploy(copy.deepcopy(model))
        int_metrics = evaluate(deployed, eval_loader, loss_fn, metric_fns,
                               int_qmode)
        logger.info("quantized (real %s execution): %s", int_qmode,
                    int_metrics)

    if config.save_dir is not None:
        save_checkpoint(config.save_dir / "quantized_model",
                        model.state_dict(),
                        metadata={"fp32": fp_metrics, "quant": q_metrics,
                                  "int": int_metrics,
                                  "config": dict(config.config)})
        logger.info("saved quantized model to %s", config.save_dir)
    return {"fp32": fp_metrics, "quant": q_metrics, "int": int_metrics,
            "model": model}

"""Evaluation of a (quantized) model over a loader.

Counterpart of ``evaluate`` in ``dlmc_quant_tpu/training/ptq.py``.  The PTQ
pipeline (``run_ptq``) and BN re-estimation are not ported yet (ROADMAP
Queue A item 10).
"""

from __future__ import annotations

from typing import Dict

import torch

from dlmc_quant_torch.quant.layers import full_f32


def bn_recalibrate(model, batches, **_kw):
    """Re-estimate BatchNorm statistics under quantization noise: not
    ported.  Raises rather than skip, so a BN model is never reconstructed
    against stale statistics."""
    raise NotImplementedError(
        "BatchNorm re-estimation (bn_recalibrate) is not ported yet "
        "(ROADMAP Queue A item 10); reconstruct a BN-free (fused) model")


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

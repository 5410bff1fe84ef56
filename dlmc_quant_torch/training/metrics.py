"""Evaluation metrics.

Counterpart of ``dlmc_quant_tpu/training/metrics.py``.
"""

from __future__ import annotations


def accuracy(logits, labels):
    return (logits.argmax(dim=-1) == labels).float().mean()


def top5_acc(logits, labels):
    top5 = logits.topk(5, dim=-1).indices
    return (top5 == labels[:, None]).any(dim=-1).float().mean()


METRICS = {"accuracy": accuracy, "top5_acc": top5_acc}


def get_metric(name: str):
    try:
        return METRICS[name]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}; known: "
                         f"{sorted(METRICS)}") from None

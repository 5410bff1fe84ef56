"""Checkpoints: a state tree (``torch.save``) and JSON metadata in one
directory, and the trainer's periodic and best checkpoints.

Counterpart of ``dlmc_quant_tpu/utils/checkpoint.py`` (ref:
base/base_trainer.py:136-228).  Quantized models round-trip because every
quantizer value (scales, zero-points, alphas, running and streaming state)
is a parameter or buffer of its layer.  A weights-only checkpoint holds a
module's ``state_dict``; a trainer's holds ``{"model": state_dict,
"optimizer": ..., "step": n}`` (``training/trainer.py``).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

_STATE = "state_dict.pt"
_META = "metadata.json"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path, tree: Dict[str, Any],
                    metadata: Optional[Dict] = None) -> Path:
    """Write ``tree`` (a state dict, or a dict of them; tensors go to the
    CPU) and ``metadata`` to the directory ``path``, replacing what was
    there."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save(_to_cpu(tree), path / _STATE)
    if metadata is not None:
        (path / _META).write_text(json.dumps(metadata, default=str))
    return path


def load_checkpoint(path) -> Tuple[Dict[str, Any], Dict]:
    """(state tree on the CPU, metadata) of a checkpoint directory."""
    path = Path(path).absolute()
    state = torch.load(path / _STATE, map_location="cpu", weights_only=True)
    meta_path = path / _META
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return state, meta


class CheckpointManager:
    """Periodic checkpoints ``checkpoint-epoch<n>`` and the best one,
    ``model_best-<monitor metric>`` (rewritten at each improvement)."""

    def __init__(self, save_dir, monitor_metric: str = "val_accuracy"):
        self.save_dir = Path(save_dir)
        self.monitor_metric = monitor_metric

    def save_epoch(self, epoch: int, tree, metadata=None) -> Path:
        return save_checkpoint(self.save_dir / f"checkpoint-epoch{epoch}",
                               tree, metadata)

    def save_best(self, tree, metadata=None) -> Path:
        return save_checkpoint(
            self.save_dir / f"model_best-{self.monitor_metric}", tree,
            metadata)

"""Checkpoints: a module's ``state_dict`` (``torch.save``) and JSON metadata
in one directory.

Counterpart of ``save_checkpoint``/``load_checkpoint`` in
``dlmc_quant_tpu/utils/checkpoint.py``.  Quantized models round-trip
because every quantizer value (scales, zero-points, alphas, streaming
state) is a parameter or buffer of its layer.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_STATE = "state_dict.pt"
_META = "metadata.json"


def save_checkpoint(path, state_dict: Dict[str, torch.Tensor],
                    metadata: Optional[Dict] = None) -> Path:
    """Write ``state_dict`` (+ ``metadata``) to the directory ``path``,
    replacing what was there."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               path / _STATE)
    if metadata is not None:
        (path / _META).write_text(json.dumps(metadata, default=str))
    return path


def load_checkpoint(path) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(state dict on the CPU, metadata) of a checkpoint directory."""
    path = Path(path).absolute()
    state = torch.load(path / _STATE, map_location="cpu", weights_only=True)
    meta_path = path / _META
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return state, meta

"""Load a reference-style PyTorch ``state_dict`` into the port's modules.

Counterpart of ``dlmc_quant_tpu/utils/torch_import.py``: the reference
loads torchvision/timm/RepVGG ``.pth`` checkpoints, whose module names
need not be the port's.  The names are matched by structure: the
checkpoint's convs, linears and BatchNorms (told apart by the weight's
rank and the running statistics) each form a stream in the checkpoint's
order, the model's likewise, and the streams are zipped.  The port's
weights are already OIHW and (out, in), so nothing is transposed.

The model's streams are its ``named_modules()`` order, which is the order
of the forward's calls in every zoo family of the port (each module is
created where it is called; tests/test_torch_ckpt_import.py checks it
with the hooks of ``utils/count_ops.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from dlmc_quant_torch.utils.bidict import BiDict
from dlmc_quant_torch.utils.count_ops import BATCHNORMS, CONVS, DENSES


def _load_state_dict(path) -> Dict[str, torch.Tensor]:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.replace("module.", ""): v.detach().cpu() for k, v in obj.items()}


def _torch_streams(sd):
    """Split a state_dict into ordered conv/linear/bn streams."""
    convs: List[Tuple[str, torch.Tensor, Optional[torch.Tensor]]] = []
    linears: List[Tuple[str, torch.Tensor, Optional[torch.Tensor]]] = []
    bns: List[Tuple[str, Dict[str, torch.Tensor]]] = []
    for key in sd:
        if not key.endswith(".weight"):
            continue
        base = key[:-len(".weight")]
        w = sd[key]
        b = sd.get(base + ".bias")
        if w.dim() == 4:
            convs.append((base, w, b))
        elif w.dim() == 2:
            linears.append((base, w, b))
        elif w.dim() == 1 and base + ".running_mean" in sd:
            bns.append((base, {"weight": w, "bias": b,
                               "running_mean": sd[base + ".running_mean"],
                               "running_var": sd[base + ".running_var"]}))
    return convs, linears, bns


def _port_streams(model: nn.Module):
    """The model's (path, module) conv, linear and BatchNorm streams, in
    ``named_modules()`` order."""
    modules = [(p, m) for p, m in model.named_modules()
               if isinstance(m, CONVS + DENSES)
               or (isinstance(m, BATCHNORMS) and m.running_mean is not None)]
    return ([pm for pm in modules if isinstance(pm[1], CONVS)],
            [pm for pm in modules if isinstance(pm[1], DENSES)],
            [pm for pm in modules if isinstance(pm[1], BATCHNORMS)])


def build_name_mapping(model: nn.Module, sd) -> BiDict:
    """Call-order port-path ↔ checkpoint-module-name mapping as a
    :class:`~dlmc_quant_torch.utils.bidict.BiDict`: ``m['layer1_0.conv1']``
    gives the checkpoint's name, ``m[:'layer1.0.conv1']`` the port's
    path."""
    m = BiDict()
    for ours, theirs in zip(_port_streams(model),
                            _torch_streams(sd)):
        for (path, _), entry in zip(ours, theirs):
            m[path] = entry[0]
    return m


@torch.no_grad()
def import_torch_checkpoint(path, model: nn.Module,
                            strict: bool = True) -> nn.Module:
    """Load the ``.pth`` at ``path`` into ``model`` in place by stream
    matching; returns ``model``.  With ``strict`` the conv, linear and
    BatchNorm streams must be as long as the model's; a weight whose shape
    differs from its module's raises either way."""
    t_streams = _torch_streams(_load_state_dict(path))
    p_streams = _port_streams(model)
    for name, ours, theirs in zip(("conv", "linear", "batchnorm"),
                                  p_streams, t_streams):
        if len(ours) != len(theirs) and strict:
            raise ValueError(f"{name} stream mismatch: the port has "
                             f"{len(ours)}, torch has {len(theirs)}")

    def put(target: torch.Tensor, value: torch.Tensor, where: str) -> None:
        if tuple(target.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch {where} "
                             f"{tuple(target.shape)} vs torch "
                             f"{tuple(value.shape)}")
        target.copy_(value)

    for ours, theirs in zip(p_streams[:2], t_streams[:2]):
        for (p, mod), (tname, w, b) in zip(ours, theirs):
            put(mod.weight, w, f"{p} / {tname}")
            if b is not None and mod.bias is not None:
                put(mod.bias, b, f"{p}.bias / {tname}.bias")
    for (p, mod), (tname, d) in zip(p_streams[2], t_streams[2]):
        for name, value in d.items():
            put(getattr(mod, name), value, f"{p}.{name} / {tname}.{name}")
    return model

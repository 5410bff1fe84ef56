"""Carry the JAX package's variables into a port module.

``variables`` is the JAX package's variable tree with every leaf turned
into a numpy array by the caller (this module imports no JAX): a nested
dict with ``params``, and optionally ``qstate`` and ``batch_stats``, in
flax names.  Module paths are the same in both packages, so each port
module reads the subtree at its own ``named_modules()`` path:

* ``QConv``: ``kernel`` HWIO → OIHW, ``bias``, ``in_scale`` (a scalar, or
  (C,) per input channel), ``wt_scale`` (a scalar, (O,) per output channel
  or (H, W) per pixel: the same shapes in both packages), ``alpha`` (HWIO
  → OIHW), RootQ's ``wt_upper``, ``wt_lower`` and
  ``wt_alpha``, and ``qstate`` ``in_offset`` (FSPTQ's integer zero-point or
  the plain family's float offset), ``wt_offset`` and RootQ's running
  values ``in_run_scale``, ``wt_run_upper`` and ``wt_run_lower``;
* ``QDense``: ``kernel`` and ``alpha`` (in, out) → (out, in), the rest as
  for ``QConv``;
* ``QBlockOutput``: ``out_scale``, and ``qstate`` ``out_offset``;
* ``BatchNorm2d`` (and the ResNets' flax-style ``BatchNorm``):
  ``scale``/``bias`` → ``weight``/``bias``, ``batch_stats`` ``mean``/``var``
  → ``running_mean``/``running_var``.

Every ``params`` leaf must find its module; other ``qstate`` leaves
(``in_stream``, the streaming statistics with their percentile sum, which
the port's ``calibrate`` fills, and ``org_weight``) are not read.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from dlmc_quant_torch.quant.layers import QBlockOutput, QConv, QDense


def _subtree(tree: Mapping, path: str):
    if not path:
        return tree
    node = tree
    for part in path.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return None
        node = node[part]
    return node


def _key(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, _key(prefix, k)))
        else:
            out[_key(prefix, k)] = v
    return out


def _to_port_layout(name: str, value: np.ndarray, module) -> np.ndarray:
    if name in ("kernel", "alpha"):
        if isinstance(module, QConv):
            return np.transpose(value, (3, 2, 0, 1))     # HWIO → OIHW
        if isinstance(module, QDense):
            return np.transpose(value)                   # IO → OI
    return value


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy the JAX variables into ``model`` in place; returns ``model``."""
    params = variables["params"]
    qstate = variables.get("qstate", {})
    stats = variables.get("batch_stats", {})
    unused = set(_flatten(params))

    def put(tensor: torch.Tensor, value, key: str) -> None:
        value = np.asarray(value)
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{key}: shape {value.shape} does not match "
                             f"the port's {tuple(tensor.shape)}")
        tensor.copy_(torch.from_numpy(np.array(value)))

    for path, module in model.named_modules():
        if isinstance(module, (QConv, QDense)):
            node = _subtree(params, path) or {}
            for name in ("kernel", "bias", "in_scale", "wt_scale", "alpha",
                         "wt_upper", "wt_lower", "wt_alpha"):
                if name not in node:
                    continue
                target = module.weight if name == "kernel" \
                    else getattr(module, name)
                put(target, _to_port_layout(name, node[name], module),
                    _key(path, name))
                unused.discard(_key(path, name))
            qnode = _subtree(qstate, path) or {}
            for name in ("in_offset", "wt_offset", "in_run_scale",
                         "wt_run_upper", "wt_run_lower"):
                if name in qnode and hasattr(module, name):
                    put(getattr(module, name), qnode[name], _key(path, name))
        elif isinstance(module, QBlockOutput):
            node = _subtree(params, path) or {}
            if "out_scale" in node:
                put(module.out_scale, node["out_scale"],
                    _key(path, "out_scale"))
                unused.discard(_key(path, "out_scale"))
            qnode = _subtree(qstate, path) or {}
            if "out_offset" in qnode and hasattr(module, "out_offset"):
                put(module.out_offset, qnode["out_offset"],
                    _key(path, "out_offset"))
        elif isinstance(module, nn.BatchNorm2d):
            node, snode = _subtree(params, path), _subtree(stats, path)
            if node is None or snode is None:
                raise ValueError(f"{path}: no BatchNorm variables")
            put(module.weight, node["scale"], _key(path, "scale"))
            put(module.bias, node["bias"], _key(path, "bias"))
            put(module.running_mean, snode["mean"], _key(path, "mean"))
            put(module.running_var, snode["var"], _key(path, "var"))
            unused -= {_key(path, "scale"), _key(path, "bias")}
    if unused:
        raise ValueError(f"params with no port counterpart: {sorted(unused)}")
    return model

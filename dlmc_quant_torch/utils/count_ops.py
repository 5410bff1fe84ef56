"""MAC counts and the producer/consumer graph of a model's modules.

Counterpart of ``dlmc_quant_tpu/utils/count_ops.py``.  Both functions run
one forward of ``sample_input`` under ``torch.no_grad()`` in eval mode,
with forward hooks on the tracked modules: pass a batch of 1, or a model
and an input on the ``meta`` device, so that no real work is spent.

* :func:`count_ops` — MACs per dotted module path (``named_modules()``
  names, the JAX package's module paths) plus ``"total"``:
  ``b·Ho·Wo·c_out·kh·kw·c_in/groups`` for a conv, ``M·K·N``-style
  (output elements × inputs) for a dense layer.
* :func:`get_compute_graph` — edges between tracked modules where one's
  output is the other's input.  The JAX package tags its tracers by
  identity; the port tags the tensor a tracked module returns by the
  tensor its storage belongs to (``._base`` for a view), so that a view
  of an output — the permute through which RepVGG and MobileOne feed
  their ``nn.BatchNorm2d`` NHWC maps, or the one a conv returns its NHWC
  output as — still finds its producer.  Every tagged tensor is held until
  the forward ends, so no other tensor can take its place.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from dlmc_quant_torch.quant.layers import QConv, QDense

CONVS = (QConv, nn.Conv2d)
DENSES = (QDense, nn.Linear)
BATCHNORMS = (nn.modules.batchnorm._BatchNorm,)
TRACKED = CONVS + DENSES + BATCHNORMS


def _tensors(tree):
    """The tensors in a module's positional arguments or output."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _tensors(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _tensors(item)


def _root(t: torch.Tensor) -> torch.Tensor:
    """The tensor whose storage ``t`` views (``t`` itself if it owns it)."""
    return t if t._base is None else t._base


def _path(name: str) -> str:
    return name or "<root>"


@contextlib.contextmanager
def traced(model: nn.Module, types, pre=None, post=None):
    """Hooks ``pre(path, module, args)`` and ``post(path, module, args,
    out)`` on every module of ``types``, removed on exit; the model in eval
    mode, without gradients, its modules' modes restored on exit."""
    handles, modes = [], {m: m.training for m in model.modules()}
    for name, module in model.named_modules():
        if not isinstance(module, types):
            continue
        path = _path(name)
        if pre is not None:
            handles.append(module.register_forward_pre_hook(
                lambda m, args, path=path: pre(path, m, args)))
        if post is not None:
            handles.append(module.register_forward_hook(
                lambda m, args, out, path=path: post(path, m, args, out)))
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        for h in handles:
            h.remove()
        for m, mode in modes.items():
            m.training = mode


def count_ops(model: nn.Module, sample_input, **forward_kw) -> Dict[str, int]:
    """Per-layer MAC counts keyed by dotted module path, plus ``'total'``."""
    counts: Dict[str, int] = {}

    def post(path, module, args, out):
        if not isinstance(out, torch.Tensor):
            return
        # weight (O, I/groups, kh, kw) or (O, I): the inputs of one output
        counts[path] = out.numel() * module.weight[0].numel()

    with traced(model, CONVS + DENSES, post=post):
        model(sample_input, **forward_kw)
    counts["total"] = sum(counts.values())
    return counts


def get_compute_graph(model: nn.Module, sample_input,
                      track_types: Optional[tuple] = None,
                      style: str = "top", **forward_kw
                      ) -> Dict[str, List[str]]:
    """Producer/consumer edges between tracked modules (``QConv``,
    ``QDense``, ``nn.Conv2d``, ``nn.Linear`` and the BatchNorms unless
    ``track_types`` says otherwise).

    ``style='top'`` maps each module to its consumers, ``'bottom'`` to its
    producers (sorted), as the JAX package's.
    """
    if style not in ("top", "bottom"):
        raise ValueError(f"style must be 'top' or 'bottom', got {style!r}")
    produced_by: Dict[int, tuple] = {}   # id(root) → (path, root held)
    producers: Dict[str, List[str]] = {}

    def pre(path, module, args):
        producers[path] = sorted({produced_by[id(_root(t))][0]
                                  for t in _tensors(args)
                                  if id(_root(t)) in produced_by})

    def post(path, module, args, out):
        for t in _tensors(out):
            root = _root(t)
            produced_by[id(root)] = (path, root)

    with traced(model, track_types or TRACKED, pre, post):
        model(sample_input, **forward_kw)
    produced_by.clear()
    if style == "bottom":
        return producers
    consumers: Dict[str, List[str]] = {p: [] for p in producers}
    for node, srcs in producers.items():
        for s in srcs:
            consumers.setdefault(s, []).append(node)
    return consumers

"""Optimizer construction on ``torch.optim``, with per-parameter-group
settings.

Counterpart of ``dlmc_quant_tpu/training/optimizers.py`` (optax there).
Parameters are picked by regex on their ``/``-joined path
(``named_parameters()`` with ``/`` for ``.``, e.g. ``layer1_0/conv1/
wt_alpha``); the first matching group wins, the rest use the base
settings.  The QAT entry gives RootQ's ``wt_alpha`` its own rate this way.

What follows optax, and how:

* the learning rate is a float, a schedule ``step -> lr`` read at the
  update count before the update (0 first), or a
  :class:`~dlmc_quant_torch.training.schedulers.ReduceLROnPlateau`, whose
  current rate is read (the trainer moves it after each epoch);
* weight decay is added to the gradient before momentum or Adam's moments
  (optax's ``add_decayed_weights``, torch's ``weight_decay`` for SGD and
  Adam); AdamW decays the weights apart from the update;
* every parameter updates at every step, as in optax: one that got no
  gradient steps on a zero gradient (its decay and momentum still move it);
* ``grad_clip`` clips by the global norm over all groups, optax's
  ``g / norm · max_norm`` when the norm reaches ``max_norm``
  (not ``clip_grad_norm_``, which divides by ``norm + 1e-6``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch

from dlmc_quant_torch.training.schedulers import ReduceLROnPlateau

LearningRate = Union[float, Callable[[int], float], ReduceLROnPlateau]


def _torch_optimizer(opt_type: str, params, momentum: float = 0.9,
                     weight_decay: float = 0.0, nesterov: bool = False,
                     betas=(0.9, 0.999), eps: float = 1e-8):
    t = opt_type.lower()
    if t == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               nesterov=nesterov, weight_decay=weight_decay)
    if t == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=tuple(betas), eps=eps,
                                weight_decay=weight_decay)
    if t == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=tuple(betas),
                                 eps=eps, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {opt_type!r}")


def _rate(lr: LearningRate, step: int) -> float:
    if isinstance(lr, ReduceLROnPlateau):
        return float(lr.lr)
    return float(lr(step)) if callable(lr) else float(lr)


class Optimizer:
    """Parameter groups, each a ``torch.optim`` optimizer with its own
    learning rate, stepped together; ``count`` is optax's update count."""

    def __init__(self, groups: Sequence[Tuple[torch.optim.Optimizer,
                                              LearningRate]],
                 grad_clip: Optional[float] = None):
        self.groups = list(groups)
        self.grad_clip = grad_clip
        self.count = 0

    @property
    def params(self):
        return [p for opt, _ in self.groups for g in opt.param_groups
                for p in g["params"]]

    def lr(self, group: int = 0) -> float:
        """The rate group ``group`` takes at the next update."""
        return _rate(self.groups[group][1], self.count)

    def zero_grad(self) -> None:
        for opt, _ in self.groups:
            opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip:
            # optax: g unchanged while norm < max_norm, else g / norm · max;
            # decided on the device, without a wait for the host
            grads = [p.grad for p in params]
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            keep = norm < self.grad_clip
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(norm, self.grad_clip)))
        for opt, lr in self.groups:
            rate = _rate(lr, self.count)
            for g in opt.param_groups:
                g["lr"] = rate
            opt.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "groups": [opt.state_dict() for opt, _ in self.groups]}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for (opt, _), s in zip(self.groups, state["groups"]):
            opt.load_state_dict(s)


def build_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                    opt_type: str, lr: LearningRate,
                    param_groups: Optional[Sequence[Tuple[str, Dict]]] = None,
                    grad_clip: Optional[float] = None,
                    **kwargs) -> Optimizer:
    """An :class:`Optimizer` over ``named_params`` (``model.
    named_parameters()``).

    ``param_groups`` is a list of ``(path_regex, overrides)``; overrides
    may set ``lr`` (a float), ``type``, ``weight_decay``, ``momentum``, …
    for the parameters whose path matches.  ``grad_clip`` adds global-norm
    clipping over all parameters.
    """
    if isinstance(lr, ReduceLROnPlateau) and param_groups:
        raise ValueError("ReduceLROnPlateau cannot be combined with "
                         "param_groups")
    compiled = [(re.compile(pattern), overrides)
                for pattern, overrides in (param_groups or ())]
    members = [[] for _ in range(len(compiled) + 1)]     # last: default
    for name, p in named_params:
        path = name.replace(".", "/")
        index = next((i for i, (rx, _) in enumerate(compiled)
                      if rx.search(path)), len(compiled))
        members[index].append(p)
    groups = []
    for (_, overrides), params in zip(compiled, members):
        if not params:
            continue
        merged = dict(kwargs)
        merged.update({k: v for k, v in overrides.items() if k != "type"})
        g_lr = merged.pop("lr", lr)
        groups.append((_torch_optimizer(overrides.get("type", opt_type),
                                        params, **merged), g_lr))
    if members[-1]:
        groups.insert(0, (_torch_optimizer(opt_type, members[-1], **kwargs),
                          lr))
    return Optimizer(groups, grad_clip)

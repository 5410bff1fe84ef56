"""Learning-rate schedules with linear warmup, as plain functions of the
step.

Counterpart of ``dlmc_quant_tpu/training/schedulers.py`` (ref:
scheduler/lr_scheduler.py:8-477).  Like optax, a schedule is read at the
optimizer's update count, 0 for the first update: the port's optimizer
(``training/optimizers.py``) sets each group's ``lr`` from it before its
``step()``.  ``torch.optim.lr_scheduler`` counts from 1 and would be one
step off.  :class:`ReduceLROnPlateau` is metric-driven and keeps its state
on the host, in a dict for checkpoints.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

Schedule = Callable[[int], float]


def _with_warmup(base: Schedule, lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup 0→lr over ``warmup_steps``, then ``base`` at
    ``step - warmup_steps``."""
    if warmup_steps <= 0:
        return base

    def sched(step):
        if step < warmup_steps:
            return lr * (step + 1.0) / warmup_steps
        return base(step - warmup_steps)
    return sched


def MultiStepLR(lr: float, milestones: Sequence[int], steps_per_epc: int,
                gamma: float = 0.1, warmup_steps: int = 0) -> Schedule:
    """Decay by ``gamma`` at each milestone epoch × ``steps_per_epc``."""
    ms = [m * steps_per_epc for m in milestones]

    def base(step):
        return lr * gamma ** sum(step >= m for m in ms)
    return _with_warmup(base, lr, warmup_steps)


def _span_steps(steps, epochs, steps_per_epc, what: str) -> int:
    """A span given in steps, or in epochs × ``steps_per_epc`` (which the
    entry points pass)."""
    if steps is not None:
        return int(steps)
    if epochs is not None and steps_per_epc is not None:
        return int(epochs * steps_per_epc)
    raise ValueError(f"{what}: give either a *_steps value or an "
                     "epoch count (with steps_per_epc)")


def CosineDecayLR(lr: float, total_steps: int = None,
                  warmup_steps: int = 0, min_lr: float = 0.0,
                  total_epochs: int = None,
                  steps_per_epc: int = None) -> Schedule:
    """Half-cosine decay lr→min_lr over ``total_steps`` (or
    ``total_epochs``)."""
    total_steps = _span_steps(total_steps, total_epochs, steps_per_epc,
                              "CosineDecayLR")
    span = max(total_steps - warmup_steps, 1)

    def base(step):
        t = min(max(step / span, 0.0), 1.0)
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * t))
    return _with_warmup(base, lr, warmup_steps)


def CosineAnnealingLR(lr: float, cycle_steps: int = None,
                      warmup_steps: int = 0, min_lr: float = 0.0,
                      t_mult: float = 1.0, cycle_epochs: int = None,
                      steps_per_epc: int = None) -> Schedule:
    """Restarting cosine cycles, each ``t_mult`` times the one before."""
    cycle_steps = _span_steps(cycle_steps, cycle_epochs, steps_per_epc,
                              "CosineAnnealingLR")

    def base(step):
        if t_mult == 1.0:
            t = (step % cycle_steps) / cycle_steps
        else:
            # geometric cycle growth, in closed form
            n = math.floor(math.log1p(step * (t_mult - 1.0) / cycle_steps)
                           / math.log(t_mult))
            start = cycle_steps * (t_mult ** n - 1.0) / (t_mult - 1.0)
            t = (step - start) / (cycle_steps * t_mult ** n)
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * t))
    return _with_warmup(base, lr, warmup_steps)


def CosineCyclicLR(lr: float, cycle_steps: int = None,
                   warmup_steps: int = 0, min_lr: float = 0.0,
                   cycle_epochs: int = None,
                   steps_per_epc: int = None) -> Schedule:
    """Symmetric cosine oscillation between lr and min_lr."""
    cycle_steps = _span_steps(cycle_steps, cycle_epochs, steps_per_epc,
                              "CosineCyclicLR")

    def base(step):
        t = (step % cycle_steps) / cycle_steps
        return min_lr + (lr - min_lr) * 0.5 * (
            1.0 + math.cos(2.0 * math.pi * t))
    return _with_warmup(base, lr, warmup_steps)


def ExponentialLR(lr: float, gamma: float, steps_per_epc: int,
                  warmup_steps: int = 0) -> Schedule:
    """Decay by ``gamma`` an epoch, as ``gamma^(1/steps_per_epc)`` a step."""
    per_step = gamma ** (1.0 / steps_per_epc)

    def base(step):
        return lr * per_step ** step
    return _with_warmup(base, lr, warmup_steps)


class ReduceLROnPlateau:
    """Metric-driven decay: ``record(value)`` each step (or epoch),
    ``epoch_end()`` once an epoch; ``lr`` is the current rate.  The state is
    a plain dict for checkpoints."""

    def __init__(self, lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, min_lr: float = 0.0,
                 threshold: float = 1e-4, warmup_steps: int = 0,
                 steps_per_epc: int = None):  # accepted, as in the JAX
        # package; the epoch boundary is explicit (epoch_end)
        self.base_lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self.state = {"lr": lr, "best": None, "bad_epochs": 0,
                      "step": 0, "sum": 0.0, "count": 0}

    @property
    def lr(self) -> float:
        s = self.state
        if s["step"] < self.warmup_steps:
            return self.base_lr * (s["step"] + 1) / self.warmup_steps
        return s["lr"]

    def record(self, value: float):
        self.state["sum"] += float(value)
        self.state["count"] += 1
        self.state["step"] += 1

    def epoch_end(self):
        s = self.state
        if not s["count"]:
            return
        avg = s["sum"] / s["count"]
        s["sum"], s["count"] = 0.0, 0
        better = (s["best"] is None
                  or (self.mode == "min" and avg < s["best"] - self.threshold)
                  or (self.mode == "max" and avg > s["best"] + self.threshold))
        if better:
            s["best"], s["bad_epochs"] = avg, 0
        else:
            s["bad_epochs"] += 1
            if s["bad_epochs"] > self.patience:
                s["lr"] = max(s["lr"] * self.factor, self.min_lr)
                s["bad_epochs"] = 0

    def state_dict(self) -> Dict:
        return dict(self.state)

    def load_state_dict(self, d: Dict):
        self.state.update(d)


SCHEDULERS = {
    "MultiStepLR": MultiStepLR,
    "CosineDecayLR": CosineDecayLR,
    "CosineAnnealingLR": CosineAnnealingLR,
    "CosineCyclicLR": CosineCyclicLR,
    "ExponentialLR": ExponentialLR,
    "ReduceLROnPlateau": ReduceLROnPlateau,
}


def get_scheduler(name: str, **kwargs):
    try:
        factory = SCHEDULERS[name]
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; known: "
                         f"{sorted(SCHEDULERS)}") from None
    return factory(**kwargs)

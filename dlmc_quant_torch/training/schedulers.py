"""Learning-rate schedules as plain functions of the step.

Counterpart of the cosine schedule of ``dlmc_quant_tpu/training/
schedulers.py``.  Like optax, a schedule is read at the optimizer's update
count, 0 for the first update: set each group's ``lr`` from it before
``optimizer.step()``.  ``torch.optim.lr_scheduler`` counts from 1 and
would be one step off.  The other schedules are not ported yet (ROADMAP
Queue A item 11).
"""

from __future__ import annotations

import math
from typing import Callable

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


def CosineAnnealingLR(lr: float, cycle_steps: int, warmup_steps: int = 0,
                      min_lr: float = 0.0, t_mult: float = 1.0) -> Schedule:
    """Restarting cosine cycles, each ``t_mult`` times the one before.
    (Spans in epochs are not ported yet: ROADMAP Queue A item 11.)"""

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

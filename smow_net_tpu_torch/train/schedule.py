"""Per-iteration LR schedules (port of smow_net_tpu/train/schedule.py;
reference utils/lr_scheduler.py:64-88, stepped per iteration at
train.py:179).

Every schedule is a plain function step -> lr (a Python float), the form
the port's optimizer reads once per update.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

__all__ = ["cosine_schedule", "multistep_schedule", "warmup_wrap", "get_schedule"]


def cosine_schedule(base_lr: float, total_steps: int, eta_min: float = 1e-6) -> Callable:
    """torch CosineAnnealingLR: eta_min + (base-eta_min)(1+cos(pi t/T))/2."""

    def fn(step):
        t = min(step, total_steps)
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * t / total_steps))

    return fn


def multistep_schedule(base_lr: float, milestones: Sequence[int], gamma: float) -> Callable:
    ms = sorted(milestones)

    def fn(step):
        return base_lr * gamma ** sum(step >= m for m in ms)

    return fn


def warmup_wrap(after: Callable, base_lr: float, multiplier: float, warmup_steps: int) -> Callable:
    """Reference GradualWarmupScheduler semantics (utils/lr_scheduler.py:5-61,
    as fixed in the JAX package): linear from base/multiplier to base over
    warmup_steps, then `after(step - warmup)`."""

    def fn(step):
        if step <= warmup_steps:
            return base_lr / multiplier * ((multiplier - 1.0) * step / warmup_steps + 1.0)
        return after(step - warmup_steps)

    return fn


def get_schedule(
    name: str,
    base_lr: float,
    epochs: int,
    iters_per_epoch: int,
    warmup_epochs: int = -1,
    warmup_multiplier: float = 100.0,
    eta_min: float = 1e-6,
    lr_decay_epochs: Optional[Sequence[int]] = None,
    lr_decay_steps: int = 20,
    lr_decay_rate: float = 0.1,
) -> Callable:
    """Mirror of reference get_scheduler (utils/lr_scheduler.py:64-88)."""
    warmup = max(warmup_epochs, 0)
    if "cosine" in name:
        sched = cosine_schedule(base_lr, (epochs - warmup) * iters_per_epoch, eta_min)
    elif "step" in name:
        if lr_decay_epochs:
            decay = list(lr_decay_epochs)
        else:
            decay = [lr_decay_steps * i for i in range(1, epochs // lr_decay_steps)]
        sched = multistep_schedule(
            base_lr, [(m - warmup) * iters_per_epoch for m in decay], lr_decay_rate
        )
    else:
        raise NotImplementedError(f"scheduler {name} not supported")
    if warmup_epochs > 0:
        sched = warmup_wrap(sched, base_lr, warmup_multiplier, warmup_epochs * iters_per_epoch)
    return sched

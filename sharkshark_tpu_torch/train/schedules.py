"""Learning-rate schedules as functions of the step (counterpart of the
JAX package's train/schedules.py).

A schedule maps the update count, from 0, to the learning rate of that
update, as optax evaluates its schedules.  The train steps set each
parameter group's `lr` to `sched(step)` before `optimizer.step()`; no
`torch.optim.lr_scheduler` is involved, whose `LambdaLR` would shift
every rate by one step.  Registry and semantics of the reference's
optim/__init__.py:38-67 (FixedLR, MultiStepLR, CosineAnnealingLR_Restart
from BasicSR).
"""

from __future__ import annotations

import bisect
import math
from typing import Callable

__all__ = ["fixed_lr", "multistep_lr", "cosine_annealing_restart", "define_lr_schedule"]

Schedule = Callable[[int], float]


def fixed_lr(base_lr: float) -> Schedule:
    def sched(step: int) -> float:
        return float(base_lr)

    return sched


def multistep_lr(base_lr: float, milestones: list[int], gamma: float = 0.5) -> Schedule:
    ms = sorted(milestones)

    def sched(step: int) -> float:
        return base_lr * gamma ** bisect.bisect_right(ms, step)

    return sched


def cosine_annealing_restart(
    base_lr: float,
    periods: list[int],
    restart_weights: list[float] | None = None,
    eta_min: float = 0.0,
) -> Schedule:
    """Cosine annealing with warm restarts: period i runs for periods[i]
    steps from base_lr * restart_weights[i] down towards eta_min; past the
    last period the rate is eta_min."""
    restart_weights = restart_weights or [1.0] * len(periods)
    assert len(periods) == len(restart_weights)
    starts = [sum(periods[:i]) for i in range(len(periods))]

    def sched(step: int) -> float:
        for start, period, weight in zip(starts, periods, restart_weights):
            if start <= step < start + period:
                t = (step - start) / period
                return eta_min + (base_lr * weight - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t))
        return float(eta_min)

    return sched


def define_lr_schedule(sched_opt: dict | None, base_lr: float) -> Schedule:
    """The schedule a config block names (reference optim/__init__.py:
    38-67); a missing block is a fixed rate."""
    if sched_opt is None:
        return fixed_lr(base_lr)
    name = sched_opt["type"]
    if name == "FixedLR":
        return fixed_lr(base_lr)
    if name == "MultiStepLR":
        return multistep_lr(base_lr, sched_opt["milestones"], sched_opt.get("gamma", 0.5))
    if name == "CosineAnnealingLR_Restart":
        return cosine_annealing_restart(
            base_lr,
            sched_opt["periods"],
            sched_opt.get("restart_weights"),
            sched_opt.get("eta_min", 0.0),
        )
    raise ValueError(f"unknown lr schedule: {name}")

"""LR schedules as pure functions ``step -> lr`` (port of
``stif_tpu/train/schedules.py``).

``MultiStepLR_Restart`` and ``CosineAnnealingLR_Restart`` of the reference
(``codes/models/lr_scheduler.py:8-62``) in closed form: the torch versions
are stateful recursions, and a schedule that is a function of the step
resumes exactly with no scheduler state. Plus the linear warmup of
``BaseModel.update_learning_rate`` (``codes/models/base_model.py:51-63``).
Computed in float64 on the host; the JAX package computes the same forms
in float32.
"""

from __future__ import annotations

import bisect
import math
from typing import Sequence


def multistep_restart(base_lr: float, milestones: Sequence[int],
                      gamma: float = 0.1, restarts: Sequence[int] = (0,),
                      restart_weights: Sequence[float] = (1.0,)):
    """lr(step) = base * weight_of_last_restart * gamma^(#milestones since)."""
    milestones = sorted(milestones)
    # the i-th restart in sorted order takes the i-th weight, as in the JAX
    # package
    rs, ws = sorted(restarts), list(restart_weights)

    def schedule(step: int) -> float:
        # last restart <= step (a restart at 0 implied when none matched)
        ridx = bisect.bisect_right(rs, step) - 1
        last, w = (rs[ridx], ws[ridx]) if ridx >= 0 else (0, 1.0)
        n_ms = sum(1 for m in milestones if last < m <= step)
        return base_lr * w * gamma ** n_ms

    return schedule


def cosine_annealing_restart(base_lr: float, T_period: Sequence[int],
                             restarts: Sequence[int] = (),
                             restart_weights: Sequence[float] = (),
                             eta_min: float = 0.0):
    """Closed form of the reference's chained cosine recursion:
    lr(step) = eta_min + (base*w_i - eta_min) * (1 + cos(pi*(step-r_i)/T_i))/2
    for the period i whose restart r_i is the last one <= step."""
    rs = [0] + sorted(restarts)
    ws = [1.0] + list(restart_weights)
    Ts = [float(t) for t in T_period]
    if len(Ts) != len(rs):
        raise ValueError("need one T_period per (implicit) restart")

    def schedule(step: int) -> float:
        i = max(bisect.bisect_right(rs, step) - 1, 0)
        cos = math.cos(math.pi * (step - rs[i]) / Ts[i])
        return eta_min + (base_lr * ws[i] - eta_min) * (1 + cos) / 2

    return schedule


def warmup_wrap(schedule, warmup_iter: int, base_lr: float):
    """Linear warmup: lr = base * step / warmup below ``warmup_iter`` (the
    reference adds lr/warmup per step from 0)."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def wrapped(step: int) -> float:
        if step < warmup_iter:
            return base_lr * step / warmup_iter
        return schedule(step)

    return wrapped

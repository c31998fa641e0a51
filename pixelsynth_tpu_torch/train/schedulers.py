"""Learning-rate schedules (port of pixelsynth_tpu/train/schedulers.py),
each a plain function of the step count with the value of the optax
schedule the JAX package builds:

  * cycle: optax.linear_onecycle_schedule (1cycle, the reference's
    CycleScheduler): lr / 25 rises linearly to lr by 30% of n_iter, falls
    back to lr / 25 by 85%, then to lr / 625 at n_iter;
  * step: optax.exponential_decay(lr, 1, gamma), the lmconv StepLR;
  * cosine, linear, power: optax's cosine_decay / linear / polynomial;
  * constant;
  * niter: the stage-2 decay, the peak until a step, then linearly to 0
    (optax.join_schedules of a constant and a linear schedule).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np

Schedule = Callable[[int], float]


def _piecewise_linear(init: float, boundaries_and_scales: Dict[int, float]) -> Schedule:
    """optax.piecewise_interpolate_schedule("linear", ...): the value is
    multiplied by each boundary's scale and interpolated linearly in
    between; before 0 it is 0, from the last boundary on its value."""
    bounds = [0] + sorted(boundaries_and_scales)
    values = [init]
    for b in bounds[1:]:
        values.append(values[-1] * boundaries_and_scales[b])

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return values[-1]
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return (values[i + 1] - values[i]) * pct + values[i]
        return 0.0

    return schedule


def cycle_schedule(lr: float, n_iter: int, *, warmup_frac: float = 0.3,
                   final_div: float = 25.0) -> Schedule:
    """1cycle: optax.linear_onecycle_schedule(n_iter, lr, pct_start=
    warmup_frac, pct_final=0.85, div_factor=final_div_factor=final_div)."""
    if n_iter <= 0:
        raise ValueError("cycle_schedule needs a positive n_iter")
    return _piecewise_linear(lr / final_div, {
        int(warmup_frac * n_iter): final_div,
        int(0.85 * n_iter): 1.0 / final_div,
        n_iter: 1.0 / final_div,
    })


def step_schedule(lr: float, gamma: float = 0.999995) -> Schedule:
    """Per-step exponential decay (the lmconv StepLR, train_lmconv.py:458).
    gamma is rounded to float32 as optax holds it: 0.999995 becomes
    0.99999499..., which moves the rate by 6.8e-9 of itself a step."""
    g32 = float(np.float32(gamma))
    return lambda count: lr if count <= 0 else lr * g32 ** count


def cosine_schedule(lr: float, n_iter: int, lr_min: float = 0.0) -> Schedule:
    alpha = lr_min / max(lr, 1e-12)

    def schedule(count: int) -> float:
        c = min(float(count), float(n_iter))
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / n_iter)) + alpha)

    return schedule


def _polynomial(init: float, end: float, power: float, n: int) -> Schedule:
    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), n) / n
        return (init - end) * frac ** power + end

    return schedule


def linear_schedule(lr: float, n_iter: int, lr_min: float = 0.0) -> Schedule:
    return _polynomial(lr, lr_min, 1, n_iter)


def power_schedule(lr: float, n_iter: int, power: float = 0.9) -> Schedule:
    return _polynomial(lr, 0.0, power, n_iter)


def niter_schedule(peak: float, decay_start: int, decay_steps: int) -> Schedule:
    """`peak` until update `decay_start`, then falling linearly to 0 over
    `decay_steps` (train/dpr.py, discriminators.py update_learning_rate)."""
    decay = linear_schedule(peak, decay_steps)
    return lambda count: peak if count < decay_start else decay(count - decay_start)


def get_schedule(name: str, lr: float, n_iter: int) -> Schedule:
    return {
        "cycle": lambda: cycle_schedule(lr, n_iter),
        "step": lambda: step_schedule(lr),
        "cosine": lambda: cosine_schedule(lr, n_iter),
        "linear": lambda: linear_schedule(lr, n_iter),
        "power": lambda: power_schedule(lr, n_iter),
        "constant": lambda: (lambda count: lr),
    }[name]()

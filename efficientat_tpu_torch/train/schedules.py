"""Learning-rate schedules (port of efficientat_tpu/train/schedules.py).

Reference: ``exp_warmup_linear_down`` (helpers/utils.py:56-84) — exponential
ramp-up (exp(-5(1-e/w)^2), epoch clipped to [0.5, w]) times a linear
ramp-down from ``start`` over ``rampdown_length`` epochs to ``last_value``.
The reference steps its LambdaLR once per EPOCH (ex_audioset.py:201); here
a ``LambdaLR`` is stepped once per optimizer step and evaluates the factor
of the step's whole epoch, so the rate is piecewise-constant within an
epoch, as the JAX package's ``per_epoch_schedule``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

def exp_rampup(rampup_length: int) -> Callable[[float], float]:
    def f(epoch):
        if epoch < rampup_length:
            epoch = min(max(epoch, 0.5), rampup_length)
            phase = 1.0 - epoch / rampup_length
            return float(math.exp(-5.0 * phase * phase))
        return 1.0
    return f


def linear_rampdown(rampdown_length: int, start: int = 0,
                    last_value: float = 0.0) -> Callable[[float], float]:
    def f(epoch):
        if epoch <= start:
            return 1.0
        if epoch - start < rampdown_length:
            return last_value + (1.0 - last_value) * (rampdown_length - epoch + start) / rampdown_length
        return last_value
    return f


def exp_warmup_linear_down(warmup: int, rampdown_length: int, start_rampdown: int,
                           last_value: float) -> Callable[[float], float]:
    up = exp_rampup(warmup)
    down = linear_rampdown(rampdown_length, start_rampdown, last_value)
    return lambda epoch: up(epoch) * down(epoch)


def per_epoch_scheduler(optimizer: torch.optim.Optimizer,
                        epoch_fn: Callable[[float], float],
                        steps_per_epoch: int) -> torch.optim.lr_scheduler.LambdaLR:
    """A ``LambdaLR`` over the optimizer's base rate, stepped once per
    optimizer step: step ``s`` uses ``base_lr * epoch_fn(s // steps_per_epoch)``."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: epoch_fn(step // steps_per_epoch))

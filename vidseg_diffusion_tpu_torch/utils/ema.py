"""EMA parameter tracking and LR schedules (PyTorch).

Counterpart of vidseg_diffusion_tpu/utils/ema.py, itself of sgm's LitEma
(ema.py:5-86) and lr_scheduler.py. The EMA keeps a copy of each parameter
and is updated in place (where JAX builds a new tree) to hold no second
copy. The schedules are plain functions of the step; with base lr 1.0 they
serve as torch.optim.lr_scheduler.LambdaLR's lr_lambda, as the reference
uses them.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn as nn


@dataclasses.dataclass
class EmaState:
    params: Dict[str, torch.Tensor]  # name -> shadow copy
    num_updates: int = 0


@torch.no_grad()
def ema_init(model: nn.Module) -> EmaState:
    return EmaState({n: p.detach().clone() for n, p in model.named_parameters()})


@torch.no_grad()
def ema_update(state: EmaState, model: nn.Module, decay: float = 0.9999) -> EmaState:
    """LitEma update with effective decay min(decay, (1 + n) / (10 + n))
    (ema.py:5-50): e <- e - (1 - d) (e - p), in place."""
    state.num_updates += 1
    n = state.num_updates
    d = min(decay, (1.0 + n) / (10.0 + n))
    for name, p in model.named_parameters():
        e = state.params[name]
        e.sub_((e - p.detach()) * (1.0 - d))
    return state


def lambda_warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float, lr_start: float,
                         max_decay_steps: int) -> Callable[[int], float]:
    """LambdaWarmUpCosineScheduler (lr_scheduler.py:4-48)."""

    def schedule(step: int) -> float:
        if step < warm_up_steps:
            return lr_start + (lr_max - lr_start) * step / max(warm_up_steps, 1)
        t = (step - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1)
        t = min(max(t, 0.0), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return schedule


def _multi_cycle(warm_up_steps, f_min, f_max, f_start, cycle_lengths: Sequence[int], decay):
    """The multi-cycle schedulers (lr_scheduler.py:51-135): the cycle is the
    first i with step <= cumulative length (a boundary step belongs to the
    cycle it ends), a linear warm-up from f_start to f_max, then
    decay(t, n, f_min, f_max, length) over the rest of the cycle."""
    cum = [0]
    for length in cycle_lengths:
        cum.append(cum[-1] + length)

    def schedule(step: int) -> float:
        cyc = min(bisect.bisect_left(cum[1:], step), len(cycle_lengths) - 1)
        n = step - cum[cyc]
        if n < warm_up_steps[cyc]:
            return (f_max[cyc] - f_start[cyc]) / warm_up_steps[cyc] * n + f_start[cyc]
        length = cycle_lengths[cyc]
        t = min(max((n - warm_up_steps[cyc]) / (length - warm_up_steps[cyc]), 0.0), 1.0)
        return decay(t, n, f_min[cyc], f_max[cyc], length)

    return schedule


def lambda_warmup_cosine2(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """LambdaWarmUpCosineScheduler2 (lr_scheduler.py:51-111): per cycle, a
    linear warm-up, then a half cosine f_max -> f_min."""
    return _multi_cycle(
        warm_up_steps, f_min, f_max, f_start, cycle_lengths,
        lambda t, n, mn, mx, length: mn + 0.5 * (mx - mn) * (1 + math.cos(t * math.pi)),
    )


def lambda_linear(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """LambdaLinearScheduler (lr_scheduler.py:113-135): linear decay in
    (cycle_length - n) / cycle_length, over the full cycle length and
    unclamped, as the reference has it."""
    return _multi_cycle(
        warm_up_steps, f_min, f_max, f_start, cycle_lengths,
        lambda t, n, mn, mx, length: mn + (mx - mn) * (length - n) / length,
    )

"""Learning-rate schedules and the optimizer.

The counterpart of the JAX package's ``train/schedule.py``: the
piecewise-constant step schedule with boundaries at ``int(e * spe)``,
cosine decay, or constant, with a linear warmup joined in front (the
main schedule then runs on ``step - warmup_steps``, as optax's
`join_schedules` does), plus the `lr_scale` wrapper. Each schedule
repeats optax's float32 arithmetic in numpy float32, so the port applies
the reference's learning rates to the bit.

The optimizer is `torch.optim.SGD` with momentum (dampening 0, weight
decay 0: the L2 term lives in the loss, ops/losses.py), the same update
as optax's `sgd` trace: buf = g + m*buf; step = buf, or g + m*buf with
Nesterov; p -= lr * step. optax reads the LR from the optimizer's own
update count, starting at 0, so with warmup the first update has LR 0;
the train step sets the LR before each update from that count
(train/state.py `TrainState.opt_count`).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

from distributed_vgg_f_tpu_torch.config import ExperimentConfig

_F32 = np.float32


def _piecewise_constant(peak: float, boundaries_and_scales: dict
                        ) -> Callable[[int], np.float32]:
    def schedule(count):
        v = _F32(peak)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v = _F32(_F32(scale) * v)
        return v
    return schedule


def _linear_warmup(peak: float, steps: int) -> Callable[[int], np.float32]:
    def schedule(count):
        frac = _F32(1) - _F32(min(max(count, 0), steps)) / _F32(steps)
        return _F32(_F32(-peak) * frac) + _F32(peak)
    return schedule


def _cosine(peak: float, decay_steps: int) -> Callable[[int], np.float32]:
    def schedule(count):
        count = _F32(min(count, decay_steps))
        decay = _F32(0.5) * (_F32(1) + np.cos(
            _F32(math.pi) * count / _F32(decay_steps)))
        return _F32(peak) * decay
    return schedule


def build_schedule(cfg: ExperimentConfig) -> Callable[[int], float]:
    """step -> learning rate (a Python float holding a float32 value)."""
    peak_lr = cfg.scaled_lr
    spe = cfg.steps_per_epoch
    warmup_steps = int(cfg.optim.warmup_epochs * spe)
    if cfg.optim.schedule == "constant":
        # optax's constant schedule returns the Python float itself
        main = lambda count: peak_lr  # noqa: E731
    elif cfg.optim.schedule == "step":
        main = _piecewise_constant(peak_lr, {
            int(e * spe): cfg.optim.decay_factor
            for e in cfg.optim.decay_epochs})
    elif cfg.optim.schedule == "cosine":
        main = _cosine(peak_lr, max(1, cfg.total_steps - warmup_steps))
    else:
        raise ValueError(f"unknown schedule {cfg.optim.schedule!r}")
    if warmup_steps > 0:
        warmup = _linear_warmup(peak_lr, warmup_steps)

        def schedule(step: int) -> float:
            step = int(step)
            if step < warmup_steps:
                return float(warmup(step))
            return float(_F32(main(step - warmup_steps)))
        return schedule
    return lambda step: float(main(int(step)))


def build_optimizer(cfg: ExperimentConfig,
                    params: Iterable[torch.nn.Parameter], *,
                    lr_scale: float = 1.0):
    """(SGD with momentum over `params`, the schedule). `params` may be
    the model's parameters or, under ZeRO-1/2, the one (S,) flat
    parameter shard of train/state.py `TrainState.create_sharded`: the
    same SGD, elementwise, so the momentum is the shard. `lr_scale`
    multiplies the whole schedule (the linear-scaling rule for a changed
    global batch). The LR in the optimizer's param group is a placeholder
    until the train step sets it before each update."""
    schedule = build_schedule(cfg)
    if lr_scale != 1.0:
        base, factor = schedule, float(lr_scale)
        schedule = lambda step: float(  # noqa: E731
            _F32(base(step)) * _F32(factor))
    opt = torch.optim.SGD(params, lr=0.0, momentum=cfg.optim.momentum,
                          dampening=0.0, weight_decay=0.0,
                          nesterov=cfg.optim.nesterov)
    return opt, schedule

"""BatchNorm with Flax's semantics, and its cross-replica (sync) form.

The counterpart of the JAX zoo's ``flax.linen.BatchNorm(momentum=0.9,
epsilon=1e-5, dtype=compute_dtype, param_dtype=float32,
axis_name=...)`` (flax 0.12 `linen.normalization`: `_compute_stats`,
`_normalize`). In training:

- the statistics are fp32 (or the input's dtype, if wider), from the
  input cast up: the mean and E[x²]
  over every axis but the channel one (1 here: NCHW), and the biased
  variance var = max(0, E[x²] - E[x]²) ("fast variance");
- with a process group of more than one rank, the (2, C) pair is
  averaged over it in one all-reduce (parallel/collectives.py `pmean`,
  whose backward is the transpose of the mean) — JAX's `lax.pmean` of
  the stacked pair under the mesh's data axis;
- y = (x - mean) * (rsqrt(var + eps) * scale) + bias in fp32, cast once
  to the input's dtype;
- the running statistics move as ra = 0.9 * ra + 0.1 * batch, with the
  biased variance.

In eval the running statistics stand in for the batch's. Neither
`torch.nn.BatchNorm2d` nor `nn.SyncBatchNorm` has these semantics: they
keep the unbiased variance, weight the running average the other way
round and compute the statistics another way.

The layer follows the explicit `train` argument, as the Flax module's
`use_running_average` does, never `module.training`. The running
statistics are buffers (``mean``, ``var``: Flax's `batch_stats` leaves),
so they stay out of the optimizer, the L2 term and the ZeRO flat layout.

The training forward and backward are one autograd Function that saves
only the input (in its own dtype) and per-channel vectors; the fp32
intermediates are recomputed in the backward instead of being kept, as
a fused BatchNorm kernel does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from distributed_vgg_f_tpu_torch.parallel.collectives import pmean_

#: Flax's defaults in the zoo (models/resnet.py: momentum 0.9, eps 1e-5)
MOMENTUM = 0.9
EPSILON = 1e-5


def _channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel (C,) vector shaped to broadcast over (N, C, ...)."""
    return v.view((1, -1) + (1,) * (ndim - 2))


def _dims(x: torch.Tensor):
    return (0,) + tuple(range(2, x.dim()))


def _up(x: torch.Tensor) -> torch.Tensor:
    """`x` in at least fp32 (Flax's `promote_types(dtype, float32)`)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class _BatchNormTrain(torch.autograd.Function):
    """(x, scale, bias) -> (y, batch mean, batch var); the statistics come
    out detached, for the running averages."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        dims, nd = _dims(x), x.dim()
        xf = _up(x)
        pair = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
        if group is not None:
            pair = pmean_(pair, group)
        mean, mean2 = pair[0], pair[1]
        spread = mean2 - mean * mean
        var = torch.clamp(spread, min=0.0)
        r = torch.rsqrt(var + eps)
        mul = r * scale
        y = (xf - _channel(mean, nd)) * _channel(mul, nd) \
            + _channel(bias, nd)
        ctx.save_for_backward(x, scale, mean, var, spread, r)
        ctx.eps, ctx.group = eps, group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, var, spread, r = ctx.saved_tensors
        dims, nd = _dims(x), x.dim()
        n = x.numel() // x.shape[1]
        xf, dyf = _up(x), _up(dy)
        mul = r * scale
        dbias = dyf.sum(dims)
        dmul = (dyf * (xf - _channel(mean, nd))).sum(dims)
        dscale = dmul * r
        # rsqrt's derivative as JAX writes it: -0.5 * r / (var + eps)
        dvar = dmul * scale * (-0.5 * r / (var + ctx.eps))
        # max(0, spread): JAX splits a tie's gradient evenly
        dvar = dvar * ((spread > 0).to(dvar.dtype)
                       + 0.5 * (spread == 0).to(dvar.dtype))
        dpair = torch.stack([-dbias * mul - 2.0 * mean * dvar, dvar])
        if ctx.group is not None:   # the transpose of the statistics' pmean
            dpair = pmean_(dpair, ctx.group)
        dx = dyf * _channel(mul, nd) + _channel(dpair[0] / n, nd) \
            + xf * _channel(2.0 * dpair[1] / n, nd)
        return dx.to(x.dtype), dscale, dbias, None, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = EPSILON, group=None):
    """Training-mode BatchNorm of (N, C, ...) `x` over the batch and, with
    `group`, over the group's ranks (None: this rank's batch only).
    Returns (y in x's dtype, the fp32 batch mean, the fp32 biased batch
    var); the statistics are detached."""
    return _BatchNormTrain.apply(x, scale, bias, eps, group)


def batch_norm_eval(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = EPSILON) -> torch.Tensor:
    """Eval-mode BatchNorm with given statistics, in fp32, cast once."""
    nd = x.dim()
    mul = torch.rsqrt(var + eps) * scale
    y = (_up(x) - _channel(mean, nd)) * _channel(mul, nd) \
        + _channel(bias, nd)
    return y.to(x.dtype)


def _data_group(axis_name: Optional[str]):
    """The group sync-BN averages over: the default process group (the
    data-parallel group the step exchanges over) when one is up with
    more than one rank and the layer names an axis; else None (local
    statistics equal global ones at one rank)."""
    if axis_name is None or not dist.is_available() \
            or not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return dist.group.WORLD


class BatchNorm(nn.Module):
    """Flax's `nn.BatchNorm` over channel axis 1: parameters ``weight``
    (Flax's `scale`) and ``bias``, buffers ``mean`` and ``var`` (its
    `batch_stats`). `axis_name` (JAX's `bn_axis_name`, "data" by default)
    turns the cross-replica statistics on in training; None keeps them
    per rank."""

    def __init__(self, features: int, *,
                 axis_name: Optional[str] = "data",
                 momentum: float = MOMENTUM, eps: float = EPSILON):
        super().__init__()
        self.axis_name = axis_name
        self.momentum = float(momentum)
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        if not train:
            return batch_norm_eval(x, self.mean, self.var, self.weight,
                                   self.bias, self.eps)
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps,
                                        _data_group(self.axis_name))
        m = self.momentum
        with torch.no_grad():
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return y


def batch_stats_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's BatchNorm statistics by state_dict name (the live
    buffers; ``stage1_block1.bn1.mean`` ...), in module order; empty for a
    model without BatchNorm."""
    return {f"{name}.{leaf}": getattr(m, leaf)
            for name, m in model.named_modules() if isinstance(m, BatchNorm)
            for leaf in ("mean", "var")}

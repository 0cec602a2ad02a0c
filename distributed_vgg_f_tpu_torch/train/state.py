"""Train state: the step counter, the model (its parameters), the
optimizer (its momentum buffers), the optimizer's own update count and
the optional parameter EMA — the unit the train step updates. The
counterpart of the JAX package's ``train/state.py TrainState``; the model
has no batch statistics (VGG-F has no BN), so there is no `batch_stats`.

Under ZeRO-1/2 (`create_sharded`) the state also holds this rank's (S,)
fp32 parameter shard of the flat layout (parallel/zero.py
`zero_layout`) and the optimizer runs over that one tensor, so the
momentum is the (S,) shard; the model's parameters stay replicated and
the step re-syncs them by the all-gather, as the JAX ZeRO-1/2 step does.

The state is mutable: the step updates parameters and momentum in place
(torch's optimizer does), where the JAX step returns new arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

from distributed_vgg_f_tpu_torch.parallel.buckets import GradBucketLayout
from distributed_vgg_f_tpu_torch.parallel.collectives import (
    all_gather_flat, rank_and_size)


@dataclass
class TrainState:
    step: int                      # steps taken, skipped ones included
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    # updates applied: optax's schedule count, the LR schedule's position;
    # a skipped (non-finite) step leaves it unchanged
    opt_count: int = 0
    # name -> fp32 tensor, or None when train.ema_decay is 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # ZeRO-1/2: this rank's (S,) fp32 parameter shard (the optimizer's one
    # tensor), the flat layout it lives in, and the process group
    param_shard: Optional[torch.Tensor] = None
    layout: Optional[GradBucketLayout] = None
    group: Any = None

    @classmethod
    def create(cls, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer, *,
               ema: bool = False) -> "TrainState":
        """A fresh state; `ema=True` starts the EMA at the current params."""
        return cls(step=0, model=model, optimizer=optimizer,
                   ema_params=_ema_start(model) if ema else None)

    @classmethod
    def create_sharded(cls, model: torch.nn.Module,
                       make_optimizer: Callable[
                           [Sequence[torch.Tensor]], torch.optim.Optimizer],
                       layout: GradBucketLayout, *, ema: bool = False,
                       group=None) -> "TrainState":
        """A fresh ZeRO state: this rank's (S,) shard of the parameters in
        `layout` (whose shard count must be the group's size) and
        `make_optimizer([shard])` over it (e.g. train/schedule.py
        `build_optimizer(cfg, ...)[0]`)."""
        rank, n = rank_and_size(group)
        if layout.num_shards != n:
            raise ValueError(f"a layout for {layout.num_shards} shards in a "
                             f"group of {n}")
        shard = layout.local_param_shard(layout.leaves(model), rank)
        return cls(step=0, model=model, optimizer=make_optimizer([shard]),
                   ema_params=_ema_start(model) if ema else None,
                   param_shard=shard, layout=layout, group=group)

    def momentum_shard(self) -> Optional[torch.Tensor]:
        """ZeRO: this rank's (S,) momentum (None before the first
        update)."""
        if self.param_shard is None:
            raise ValueError("a replicated state has no momentum shard")
        return self.optimizer.state.get(self.param_shard, {}).get(
            "momentum_buffer")

    def momentum_global(self) -> Optional[torch.Tensor]:
        """ZeRO: the (T,) bucket-major momentum, every rank's shard in rank
        order — the vector a JAX ZeRO state holds. An all-gather when the
        group has more than one rank: every rank must call it."""
        shard = self.momentum_shard()
        if shard is None:
            return None
        full = torch.empty(self.layout.total_padded, dtype=shard.dtype,
                           device=shard.device)
        all_gather_flat(full, shard, self.group)
        return full

    def momentum(self) -> Dict[str, Optional[torch.Tensor]]:
        """name -> the momentum buffer (None before the first update).
        Under ZeRO it is read out of the flat momentum through the layout
        (an all-gather when the group has more than one rank)."""
        if self.param_shard is not None:
            full = self.momentum_global()
            if full is None:
                return {k: None for k in self.layout.keys}
            return self.layout.from_global(full)
        return {name: self.optimizer.state.get(p, {}).get("momentum_buffer")
                for name, p in self.model.named_parameters()}

    def load_momentum(self, buffers: Mapping[str, torch.Tensor]) -> None:
        """Set every parameter's momentum buffer (e.g. from
        weights.momentum_from_optax), on the parameter's device; under
        ZeRO, this rank's shard of them."""
        named = dict(self.model.named_parameters())
        if set(buffers) != set(named):
            raise ValueError(f"momentum for {sorted(buffers)}, params "
                             f"{sorted(named)}")
        if self.param_shard is not None:
            dev = self.param_shard.device
            rank = rank_and_size(self.group)[0]
            self.load_momentum_shard(self.layout.local_param_shard(
                [buffers[k].detach().to(dev) for k in self.layout.keys],
                rank))
            return
        for name, p in named.items():
            self.optimizer.state[p]["momentum_buffer"] = \
                buffers[name].detach().to(p.device, p.dtype).clone()

    def load_momentum_shard(self, shard: torch.Tensor) -> None:
        """ZeRO: set this rank's (S,) momentum (e.g. from
        weights.momentum_shard_from_optax)."""
        if self.param_shard is None:
            raise ValueError("a replicated state has no momentum shard")
        if shard.shape != self.param_shard.shape:
            raise ValueError(f"a momentum shard of shape {tuple(shard.shape)}"
                             f"; the parameter shard is "
                             f"{tuple(self.param_shard.shape)}")
        self.optimizer.state[self.param_shard]["momentum_buffer"] = \
            shard.detach().to(self.param_shard.device,
                              torch.float32).clone()


def _ema_start(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.named_parameters()}

"""Train state: the step counter, the model (its parameters), the
optimizer (its momentum buffers), the optimizer's own update count and
the optional parameter EMA — the unit the train step updates. The
counterpart of the JAX package's ``train/state.py TrainState``; the model
has no batch statistics (VGG-F has no BN), so there is no `batch_stats`.

The state is mutable: the step updates parameters and momentum in place
(torch's optimizer does), where the JAX step returns new arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch


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

    @classmethod
    def create(cls, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer, *,
               ema: bool = False) -> "TrainState":
        """A fresh state; `ema=True` starts the EMA at the current params."""
        ema_params = ({k: v.detach().clone()
                       for k, v in model.named_parameters()}
                      if ema else None)
        return cls(step=0, model=model, optimizer=optimizer,
                   ema_params=ema_params)

    def momentum(self) -> Dict[str, Optional[torch.Tensor]]:
        """name -> the optimizer's momentum buffer (None before the first
        update)."""
        return {name: self.optimizer.state.get(p, {}).get("momentum_buffer")
                for name, p in self.model.named_parameters()}

    def load_momentum(self, buffers: Mapping[str, torch.Tensor]) -> None:
        """Set every parameter's momentum buffer (e.g. from
        weights.momentum_from_optax), on the parameter's device."""
        named = dict(self.model.named_parameters())
        if set(buffers) != set(named):
            raise ValueError(f"momentum for {sorted(buffers)}, params "
                             f"{sorted(named)}")
        for name, p in named.items():
            self.optimizer.state[p]["momentum_buffer"] = \
                buffers[name].detach().to(p.device, p.dtype).clone()

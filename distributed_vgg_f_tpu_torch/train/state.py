"""Train state: the step counter, the model (its parameters), the
optimizer (its momentum buffers), the optimizer's own update count, the
BatchNorm statistics, and the optional EMA of the parameters and of the
statistics — the unit the train step updates. The counterpart of the JAX
package's ``train/state.py TrainState``. `batch_stats` is the model's
BatchNorm buffers (ops/batch_norm.py; live: the training forward moves
them in place), empty for a model without BatchNorm (VGG-F, VGG-16,
ViT), as JAX's is `{}` there; `ema_batch_stats` their EMA, kept beside
`ema_params` (`{}` without BatchNorm, None without an EMA). Both stay
replicated under ZeRO-1/2, as in JAX `parallel/zero.py:86–90`.

Under ZeRO-1/2 (`create_sharded`) the state also holds this rank's (S,)
fp32 parameter shard of the flat layout (parallel/zero.py
`zero_layout`) and the optimizer runs over that one tensor, so the
momentum is the (S,) shard; the model's parameters stay replicated and
the step re-syncs them by the all-gather, as the JAX ZeRO-1/2 step does.
Under ZeRO-3 (`create_sharded(..., shard_params=True)`, JAX
`parallel/zero.py:67–90`) the (S,) shard is the one persistent copy of
the parameters and `ema_params` is an (S,) shard of the same layout:
between steps every `nn.Parameter` holds a zero-size tensor
(`release_params`), `gather_params` gives them back for a step or an
eval as views of per-bucket buffers, and `shapes` (a meta-device twin of
the model) keeps the names, shapes and head count that checkpoints and
layout conversions read.

The state is mutable: the step updates parameters and momentum in place
(torch's optimizer does), where the JAX step returns new arrays.

`checkpoint_tree` and `load_checkpoint_tree` map the state to and from
the checkpoint's arrays (checkpoint/manager.py), in the Flax names and
layouts: `step`, `opt/count` (optax's count), `params/<layer>/<leaf>`
(under ZeRO-3 `params`, the (T,) vector, gathered, as JAX's ZeRO-3
state saves it), the momentum as `opt/trace` (the ZeRO (T,) vector,
gathered) or `opt/trace/<layer>/<leaf>`, `ema_params/<layer>/<leaf>`
(or the (T,) `ema_params`), and the
statistics as `batch_stats/<layer>/<leaf>` and
`ema_batch_stats/<layer>/<leaf>` (`mean`, `var`; absent without
BatchNorm, as JAX's empty trees write nothing). Every layout change is a
copy through `weights.flax_view`, so the round trip is bitwise.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from distributed_vgg_f_tpu_torch.ops.batch_norm import batch_stats_of
from distributed_vgg_f_tpu_torch.parallel.buckets import (GradBucketLayout,
                                                          canonical_leaves)
from distributed_vgg_f_tpu_torch.parallel.collectives import (
    all_gather_flat, rank_and_size)
from distributed_vgg_f_tpu_torch.resilience.errors import \
    GeometryReceiptError
from distributed_vgg_f_tpu_torch.weights import flax_view


@dataclass
class TrainState:
    step: int                      # steps taken, skipped ones included
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    # updates applied: optax's schedule count, the LR schedule's position;
    # a skipped (non-finite) step leaves it unchanged
    opt_count: int = 0
    # name -> fp32 tensor (under ZeRO-3 the (S,) shard), or None when
    # train.ema_decay is 0
    ema_params: Optional[Union[Dict[str, torch.Tensor], torch.Tensor]] = None
    # the BatchNorm statistics' EMA by buffer name ({} without BatchNorm),
    # or None when train.ema_decay is 0
    ema_batch_stats: Optional[Dict[str, torch.Tensor]] = None
    # ZeRO-1/2: this rank's (S,) fp32 parameter shard (the optimizer's one
    # tensor), the flat layout it lives in, and the process group
    param_shard: Optional[torch.Tensor] = None
    layout: Optional[GradBucketLayout] = None
    group: Any = None
    # ZeRO-3: the shard is the parameters' one copy (see the module doc)
    shard_params: bool = False
    _twin: Optional[torch.nn.Module] = field(default=None, repr=False)
    # which shard the model's parameters hold while gathered ("params" or
    # "ema"), None while released
    _gathered: Optional[str] = field(default=None, repr=False)

    @classmethod
    def create(cls, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer, *,
               ema: bool = False) -> "TrainState":
        """A fresh state; `ema=True` starts the EMA at the current params
        and statistics."""
        return cls(step=0, model=model, optimizer=optimizer,
                   ema_params=_ema_start(model) if ema else None,
                   ema_batch_stats=_ema_stats_start(model) if ema else None)

    @classmethod
    def create_sharded(cls, model: torch.nn.Module,
                       make_optimizer: Callable[
                           [Sequence[torch.Tensor]], torch.optim.Optimizer],
                       layout: GradBucketLayout, *, ema: bool = False,
                       group=None,
                       shard_params: bool = False) -> "TrainState":
        """A fresh ZeRO state: this rank's (S,) shard of the parameters in
        `layout` (whose shard count must be the group's size) and
        `make_optimizer([shard])` over it (e.g. train/schedule.py
        `build_optimizer(cfg, ...)[0]`). With `shard_params` (ZeRO-3) the
        EMA is an (S,) shard too and the model's parameter storage is
        released."""
        rank, n = rank_and_size(group)
        if layout.num_shards != n:
            raise ValueError(f"a layout for {layout.num_shards} shards in a "
                             f"group of {n}")
        shard = layout.local_param_shard(layout.leaves(model), rank)
        if not shard_params:
            return cls(step=0, model=model,
                       optimizer=make_optimizer([shard]),
                       ema_params=_ema_start(model) if ema else None,
                       ema_batch_stats=(_ema_stats_start(model) if ema
                                        else None),
                       param_shard=shard, layout=layout, group=group)
        state = cls(step=0, model=model, optimizer=make_optimizer([shard]),
                    ema_params=shard.clone() if ema else None,
                    ema_batch_stats=_ema_stats_start(model) if ema else None,
                    param_shard=shard, layout=layout, group=group,
                    shard_params=True, _twin=meta_twin(model))
        state.release_params()
        return state

    @property
    def shapes(self) -> torch.nn.Module:
        """The module whose parameters give the names, shapes and head
        count: the model, or under ZeRO-3 its meta-device twin (the model's
        own parameters are zero-size between steps)."""
        return self._twin if self.shard_params else self.model

    @property
    def device(self) -> torch.device:
        """Where the state's tensors live."""
        return (self.param_shard.device if self.param_shard is not None
                else next(self.model.parameters()).device)

    # ------------------------------------------------------------- ZeRO-3
    def gather_params(self, *, ema: bool = False, wire_dtype=None,
                      events: Optional[list] = None) -> None:
        """ZeRO-3: the model's parameters from the (S,) shard (or, with
        `ema`, the EMA shard), one all-gather per bucket
        (parallel/buckets.py `gather_param_tree`; collective: every rank
        calls it). `wire_dtype` narrows the gather (the train step's
        `mesh.reduce_dtype`); None gathers the exact fp32 weights."""
        if not self.shard_params:
            raise ValueError("only a ZeRO-3 state gathers its parameters")
        if ema and not isinstance(self.ema_params, torch.Tensor):
            raise ValueError("the state keeps no EMA (train.ema_decay is 0)")
        self.layout.gather_param_tree(
            self.ema_params if ema else self.param_shard,
            self.layout.leaves(self.model), self.group,
            wire_dtype=wire_dtype, events=events)
        self._gathered = "ema" if ema else "params"

    def release_params(self) -> None:
        """ZeRO-3: every parameter back to a zero-size tensor (its shape
        lives in the layout); the gathered buffers go with the last view
        of them."""
        for p in self.model.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None
        self._gathered = None

    @contextlib.contextmanager
    def gathered(self, *, ema: bool = False):
        """The model holding the exact fp32 parameters (or the EMA) for the
        block, released after it: a no-op unless ZeRO-3, and when the
        same shard is already gathered (an eval step inside an eval pass
        that gathered once)."""
        want = "ema" if ema else "params"
        if not self.shard_params or self._gathered == want:
            yield
            return
        self.gather_params(ema=ema)
        try:
            yield
        finally:
            self.release_params()

    def params_tree(self, *, ema: bool = False) -> Dict[str, torch.Tensor]:
        """name -> the parameters (or the EMA) in the port's layout. Under
        ZeRO-3 they are read out of the gathered (T,) vector through the
        layout (an all-gather when the group has more than one rank: every
        rank must call it)."""
        if self.shard_params:
            return self.layout.from_global(self._global(
                self.ema_params if ema else self.param_shard))
        if ema:
            return dict(self.ema_params)
        return {k: v.detach() for k, v in self.model.named_parameters()}

    def _global(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's (S,) `shard` in rank order: the (T,) vector."""
        full = torch.empty(self.layout.total_padded, dtype=shard.dtype,
                           device=shard.device)
        all_gather_flat(full, shard, self.group)
        return full

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The model's BatchNorm statistics by buffer name: the live
        buffers, which the training forward moves in place ({} without
        BatchNorm)."""
        return batch_stats_of(self.model)

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
        return None if shard is None else self._global(shard)

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
        named = dict(self.shapes.named_parameters())
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

    # ------------------------------------------------------------ checkpoint
    def checkpoint_tree(self) -> Dict[str, torch.Tensor]:
        """The state's arrays by checkpoint name, in the Flax layouts
        (views of the live tensors where the layout allows; a momentum
        not yet created is zeros, as optax's trace starts). Under ZeRO
        the momentum is gathered, and under ZeRO-3 the params and the EMA
        as the (T,) vectors `params` and `ema_params`: every rank must
        call it."""
        model = self.model
        tree: Dict[str, torch.Tensor] = {
            "step": torch.tensor(self.step, dtype=torch.int32),
            "opt/count": torch.tensor(self.opt_count, dtype=torch.int32)}
        leaves = canonical_leaves(self.shapes)

        def add(prefix: str, values: Mapping[str, torch.Tensor]) -> None:
            for name, key, shape, _ in leaves:
                view = flax_view(key, values[key])
                tree[f"{prefix}/{name}"] = (view if tuple(view.shape) == shape
                                            else view.reshape(shape))

        if self.shard_params:
            tree["params"] = self._global(self.param_shard)
        else:
            named = {k: v.detach() for k, v in model.named_parameters()}
            add("params", named)
        if self.param_shard is not None:
            trace = self.momentum_global()
            tree["opt/trace"] = (trace if trace is not None else torch.zeros(
                self.layout.total_padded, device=self.param_shard.device))
        else:
            add("opt/trace", {k: v if v is not None
                              else torch.zeros_like(named[k])
                              for k, v in self.momentum().items()})
        if self.shard_params and self.ema_params is not None:
            tree["ema_params"] = self._global(self.ema_params)
        elif self.ema_params is not None:
            add("ema_params", self.ema_params)
        for prefix, stats in (("batch_stats", self.batch_stats),
                              ("ema_batch_stats", self.ema_batch_stats)):
            for key, value in (stats or {}).items():
                tree[f"{prefix}/{key.replace('.', '/')}"] = value.detach()
        return tree

    def load_checkpoint_tree(
            self, tree: Mapping[str, Any],
            momentum: Union[Mapping[str, torch.Tensor], torch.Tensor],
            params: Optional[Union[Mapping[str, torch.Tensor],
                                   torch.Tensor]] = None,
            ema_params: Optional[Union[Mapping[str, torch.Tensor],
                                       torch.Tensor]] = None
    ) -> Optional[str]:
        """Load a checkpoint's step, count, params, statistics and EMA
        from `tree` (`checkpoint_tree`'s names) and `momentum`, already in
        this state's layout (checkpoint/retopology.py): the per-parameter
        buffers, or this rank's (S,) shard under ZeRO. `params` and
        `ema_params` are the saved params and EMA in this state's layout
        too (the name -> tensor tree, or this rank's (S,) shard under
        ZeRO-3; `ema_params` None: the checkpoint has no EMA); with
        `params` None both are read from `tree`'s per-parameter arrays.
        Returns the EMA event: "ema_seeded_from_params" when the run keeps
        an EMA the checkpoint lacks (the statistics' EMA starts at the
        restored statistics), "ema_dropped_on_restore" for the converse,
        else None. Params or statistics saved for another model raise
        GeometryReceiptError."""
        model = self.model
        stats = self.batch_stats
        if params is None:
            params = self._from_tree(tree, "params")
            saved_ema = any(k.startswith("ema_params/") for k in tree)
            if saved_ema and self.ema_params is not None:
                ema_params = self._from_tree(tree, "ema_params")
        else:
            saved_ema = ema_params is not None
        saved_stats = stats_from_tree(tree, "batch_stats", stats)
        with torch.no_grad():
            if self.shard_params:
                self.param_shard.copy_(params)
            else:
                named = dict(model.named_parameters())
                for key, value in params.items():
                    named[key].copy_(value)
                if self.param_shard is not None:
                    rank = rank_and_size(self.group)[0]
                    self.param_shard.copy_(self.layout.local_param_shard(
                        self.layout.leaves(model), rank))
            for key, value in saved_stats.items():
                stats[key].copy_(value)
        event = None
        if self.ema_params is not None and saved_ema:
            self.ema_params = (ema_params.clone() if self.shard_params
                               else dict(ema_params))
            self.ema_batch_stats = stats_from_tree(tree, "ema_batch_stats",
                                                   stats)
        elif self.ema_params is not None:
            self.ema_params = (self.param_shard.clone() if self.shard_params
                               else _ema_start(model))
            self.ema_batch_stats = _ema_stats_start(model)
            event = "ema_seeded_from_params"
        elif saved_ema:
            event = "ema_dropped_on_restore"
        if isinstance(momentum, torch.Tensor):
            self.load_momentum_shard(momentum)
        else:
            self.load_momentum(momentum)
        self.step = int(tree["step"])
        self.opt_count = int(tree["opt/count"])
        return event


    def _from_tree(self, tree: Mapping[str, Any], prefix: str
                   ) -> Union[Dict[str, torch.Tensor], torch.Tensor]:
        """`tree`'s per-parameter arrays under `prefix` in this state's
        layout: the tree, or under ZeRO-3 this rank's (S,) shard."""
        value = leaves_from_tree(tree, prefix, self.shapes, self.device)
        if not self.shard_params:
            return value
        return self.layout.local_param_shard(
            self.layout.leaves(value), rank_and_size(self.group)[0])


def leaves_from_tree(tree: Mapping[str, Any], prefix: str,
                     model: torch.nn.Module,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, torch.Tensor]:
    """The checkpoint arrays under `prefix/<Flax name>` -> the port's
    name -> fp32 tensor in the port's layout, on `device` (default the
    model's; pass it for a meta twin) (the inverse of `checkpoint_tree`'s
    views; the layout copies run there). A missing, extra or misshapen
    leaf raises GeometryReceiptError: the checkpoint was written for
    another model."""
    leaves = canonical_leaves(model)
    saved = {k[len(prefix) + 1:] for k in tree if k.startswith(prefix + "/")}
    if saved != {name for name, *_ in leaves}:
        raise GeometryReceiptError(
            f"checkpoint {prefix} {sorted(saved)} are not this model's "
            f"{sorted(name for name, *_ in leaves)}")
    device = device or next(model.parameters()).device
    out = {}
    for name, key, shape, port_shape in leaves:
        arr = torch.as_tensor(np.asarray(tree[f"{prefix}/{name}"]))
        if tuple(arr.shape) != shape:
            raise GeometryReceiptError(
                f"checkpoint {prefix}/{name} has shape {tuple(arr.shape)}; "
                f"this model's is {shape}")
        t = torch.empty(port_shape, dtype=torch.float32, device=device)
        view = flax_view(key, t)
        view.copy_(arr.to(device).reshape(view.shape))
        out[key] = t
    return out


def stats_from_tree(tree: Mapping[str, Any], prefix: str,
                    like: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The checkpoint's statistics under `prefix/<layer>/<leaf>` -> buffer
    name -> fp32 tensor on the device of `like` (the model's
    `batch_stats`). A missing, extra or misshapen leaf raises
    GeometryReceiptError."""
    saved = {k[len(prefix) + 1:].replace("/", "."): k for k in tree
             if k.startswith(prefix + "/")}
    if set(saved) != set(like):
        raise GeometryReceiptError(
            f"checkpoint {prefix} {sorted(saved)} are not this model's "
            f"{sorted(like)}")
    out = {}
    for key, ref in like.items():
        arr = torch.as_tensor(np.asarray(tree[saved[key]]))
        if tuple(arr.shape) != tuple(ref.shape):
            raise GeometryReceiptError(
                f"checkpoint {saved[key]} has shape {tuple(arr.shape)}; "
                f"this model's is {tuple(ref.shape)}")
        out[key] = arr.to(ref.device, torch.float32).clone()
    return out


def meta_twin(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of `model` whose parameters and buffers are meta tensors of
    the same shapes (no storage): its names, shapes and attributes (ViT's
    `num_heads`) for the code that reads a model's geometry."""
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                      requires_grad=p.requires_grad)
            for p in model.parameters()}
    memo.update({id(b): torch.empty_like(b, device="meta")
                 for b in model.buffers()})
    return copy.deepcopy(model, memo)


def _ema_start(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _ema_stats_start(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in batch_stats_of(model).items()}

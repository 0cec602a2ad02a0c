"""Restore a checkpoint into this run's layout — the opt-state half of the
JAX package's ``checkpoint/retopology.py restore_any_topology``
(:49–255).

A checkpoint's momentum layout depends on how it was trained: replicated
SGD saves one buffer per parameter (`opt/trace/<layer>/<leaf>`), ZeRO-1/2
one flat vector (`opt/trace`) padded to a multiple of its shard count,
canonical or bucket-major. The saved layout is read from the shapes
alone; a flat vector's geometry from the `opt_layout` receipt in the
step's `extra` (absent = canonical, as every JAX writer leaves it without
buckets), rebuilt by `layout_from_receipt` and refused with
GeometryReceiptError when it does not reproduce. When the saved layout and
receipt equal the run's, each rank takes its (S,) row as it is (the fast
path); otherwise parallel/zero.py `convert_opt_state` moves the vector
into the run's layout, bit for bit, and each rank keeps its own row.
Params are always saved as the tree and load as they are; so are the
BatchNorm statistics and their EMA, which are replicated in every layout
(JAX `parallel/zero.py:86–90`) and cross any change of shard count
unchanged: only the optimizer state is converted. ZeRO-3's params
branches and elastic resize are not ported (ROADMAP A13).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple, Union

import torch

from distributed_vgg_f_tpu_torch.parallel.buckets import layout_from_receipt
from distributed_vgg_f_tpu_torch.parallel.collectives import rank_and_size
from distributed_vgg_f_tpu_torch.parallel.zero import (convert_opt_state,
                                                       flat_param_count,
                                                       params_layout)
from distributed_vgg_f_tpu_torch.resilience.errors import \
    GeometryReceiptError
from distributed_vgg_f_tpu_torch.train.state import (TrainState,
                                                     leaves_from_tree)


def migrate_momentum(state: TrainState, tree: Mapping[str, Any],
                     extra: Mapping[str, Any], step: int
                     ) -> Union[Mapping[str, torch.Tensor], torch.Tensor]:
    """The saved momentum of `tree` (with `extra`'s receipt) in `state`'s
    layout: the per-parameter buffers for a replicated state, this rank's
    (S,) shard under ZeRO."""
    model = state.model
    if "opt/trace" in tree:
        trace = torch.as_tensor(tree["opt/trace"]).to(
            next(model.parameters()).device)
    else:
        trace = leaves_from_tree(tree, "opt/trace", model)
    layout, padded = params_layout(trace, flat_param_count(model))
    receipt = (extra or {}).get("opt_layout")
    src = None
    if isinstance(trace, torch.Tensor) and layout != "flat":
        raise GeometryReceiptError(
            f"checkpoint step {step}: opt/trace of shape "
            f"{tuple(trace.shape)} is no flat momentum of this model's "
            f"{flat_param_count(model)} parameters")
    if receipt is not None:
        if layout != "flat":
            raise GeometryReceiptError(
                f"opt-layout receipt present at step {step} but the saved "
                "momentum is a tree, not a flat vector")
        try:
            src = layout_from_receipt(model, receipt)
        except (ValueError, KeyError, TypeError) as e:
            raise GeometryReceiptError(
                f"opt-layout receipt at step {step} does not describe this "
                f"run's geometry: {e}") from e
        if src.total_padded != padded:
            raise GeometryReceiptError(
                f"opt-layout receipt at step {step} claims total_padded="
                f"{src.total_padded} but the saved momentum has length "
                f"{padded}")
    target = state.layout
    if target is None:
        return convert_opt_state(trace, model, None, src_bucket_layout=src)
    target_receipt = target.describe() if target.bucket_bytes > 0 else None
    if not (layout == "flat" and padded == target.total_padded
            and receipt == target_receipt):
        trace = convert_opt_state(
            trace, model, target.total_padded, src_bucket_layout=src,
            target_bucket_layout=target if target_receipt else None)
    rank = rank_and_size(state.group)[0]
    return trace.reshape(target.num_shards, target.shard_size)[rank].clone()


def restore_any_topology(manager, state: TrainState,
                         step: Optional[int] = None
                         ) -> Tuple[TrainState, Mapping[str, Any],
                                    Optional[str]]:
    """Restore `manager`'s checkpoint at `step` (default: its newest
    intact step) into `state`, in place, in `state`'s layout.
    Returns `(state, extra, ema_event)`; `ema_event` is
    `TrainState.load_checkpoint_tree`'s."""
    step = step if step is not None else manager.best_step()
    tree, extra = manager.restore(step)
    momentum = migrate_momentum(state, tree, extra, step)
    ema_event = state.load_checkpoint_tree(tree, momentum)
    return state, extra, ema_event

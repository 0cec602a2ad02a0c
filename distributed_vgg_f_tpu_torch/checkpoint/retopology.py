"""Restore a checkpoint into this run's layout — the JAX package's
``checkpoint/retopology.py restore_any_topology`` (:49–255), its
opt-state and params halves.

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

The params and the EMA params take the same road. Replicated, ZeRO-1 and
ZeRO-2 runs save them as the tree (`params/<layer>/<leaf>`); ZeRO-3 saves
them as the flat (T,) vectors `params` and `ema_params`, in the layout
the `param_layout` receipt names (`canonical_flat`, or `bucketed_flat`,
whose bucket geometry is the `opt_layout` receipt's: one layout for both
vectors). `convert_params` moves them into the run's layout — the tree,
or this rank's (S,) shard under ZeRO-3 — so a restore crosses ZeRO-3 <->
ZeRO-2 / dp and N -> M ranks in either direction. The receipts are
checked against the saved arrays' shapes (`state_metadata`, the .npy
headers) before any array is read, and a receipt that disagrees raises
GeometryReceiptError before anything is written into the state. The
BatchNorm statistics and their EMA are replicated in every layout (JAX
`parallel/zero.py:86–90`) and cross any change unchanged. Elastic resize
is not ported (ROADMAP A13b).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple, Union

import torch

from distributed_vgg_f_tpu_torch.parallel.buckets import (GradBucketLayout,
                                                          layout_from_receipt)
from distributed_vgg_f_tpu_torch.parallel.collectives import rank_and_size
from distributed_vgg_f_tpu_torch.parallel.zero import (convert_opt_state,
                                                       convert_params,
                                                       flat_param_count,
                                                       params_layout)
from distributed_vgg_f_tpu_torch.resilience.errors import \
    GeometryReceiptError
from distributed_vgg_f_tpu_torch.train.state import (TrainState,
                                                     leaves_from_tree)

Value = Union[Mapping[str, torch.Tensor], torch.Tensor]


def _opt_receipt_layout(state: TrainState, extra: Mapping[str, Any],
                        step: int) -> Optional[GradBucketLayout]:
    """The saved bucket layout of the `opt_layout` receipt, rebuilt on
    this model (None without one); a receipt that does not reproduce
    raises GeometryReceiptError."""
    receipt = (extra or {}).get("opt_layout")
    if receipt is None:
        return None
    try:
        return layout_from_receipt(state.shapes, receipt)
    except (ValueError, KeyError, TypeError) as e:
        raise GeometryReceiptError(
            f"opt-layout receipt at step {step} does not describe this "
            f"run's geometry: {e}") from e


def check_param_receipt(state: TrainState, shapes: Mapping[str, tuple],
                        extra: Mapping[str, Any], step: int
                        ) -> Optional[GradBucketLayout]:
    """The saved params' layout from the arrays' shapes (`shapes`: array
    name -> shape, e.g. the manager's `state_metadata`) and the
    `param_layout` receipt (JAX `retopology.py:118–160`): a flat `params`
    vector reads through the returned bucket layout (`bucketed_flat`) or
    in canonical order (None: `canonical_flat`, or no receipt); tree
    params return None. A receipt whose `total_padded` is not the saved
    vector's length, a `bucketed_flat` receipt with no `opt_layout`
    receipt to name the buckets, a receipt beside tree params, or a flat
    vector shorter than the model raise GeometryReceiptError."""
    receipt = (extra or {}).get("param_layout")
    if "params" not in shapes:
        if receipt is not None:
            raise GeometryReceiptError(
                f"param-layout receipt present at step {step} but the saved "
                "params are a tree, not a flat vector — receipt and payload "
                "disagree")
        return None
    padded = tuple(shapes["params"])
    total = flat_param_count(state.shapes)
    if len(padded) != 1 or padded[0] < total:
        raise GeometryReceiptError(
            f"checkpoint step {step}: params of shape {padded} are no flat "
            f"vector of this model's {total} parameters")
    if receipt is None:
        return None
    if receipt.get("total_padded") != padded[0]:
        raise GeometryReceiptError(
            f"param-layout receipt at step {step} claims total_padded="
            f"{receipt.get('total_padded')} but the saved flat params "
            f"vector has length {padded[0]}")
    kind = receipt.get("kind")
    if kind == "canonical_flat":
        return None
    if kind != "bucketed_flat":
        raise GeometryReceiptError(
            f"param-layout receipt at step {step} names kind {kind!r}; "
            "known: 'canonical_flat', 'bucketed_flat'")
    src = _opt_receipt_layout(state, extra, step)
    if src is None:
        raise GeometryReceiptError(
            f"param-layout receipt at step {step} says 'bucketed_flat' but "
            "no opt-layout receipt describes the bucket geometry — cannot "
            "invert the permutation")
    if src.total_padded != padded[0]:
        raise GeometryReceiptError(
            f"opt-layout receipt at step {step} claims total_padded="
            f"{src.total_padded} but the saved flat params vector has "
            f"length {padded[0]}")
    return src


def migrate_momentum(state: TrainState, tree: Mapping[str, Any],
                     extra: Mapping[str, Any], step: int
                     ) -> Union[Mapping[str, torch.Tensor], torch.Tensor]:
    """The saved momentum of `tree` (with `extra`'s receipt) in `state`'s
    layout: the per-parameter buffers for a replicated state, this rank's
    (S,) shard under ZeRO."""
    shapes = state.shapes
    if "opt/trace" in tree:
        trace = torch.as_tensor(tree["opt/trace"]).to(state.device)
    else:
        trace = leaves_from_tree(tree, "opt/trace", shapes, state.device)
    layout, padded = params_layout(trace, flat_param_count(shapes))
    receipt = (extra or {}).get("opt_layout")
    if isinstance(trace, torch.Tensor) and layout != "flat":
        raise GeometryReceiptError(
            f"checkpoint step {step}: opt/trace of shape "
            f"{tuple(trace.shape)} is no flat momentum of this model's "
            f"{flat_param_count(shapes)} parameters")
    if receipt is not None and layout != "flat":
        raise GeometryReceiptError(
            f"opt-layout receipt present at step {step} but the saved "
            "momentum is a tree, not a flat vector")
    src = _opt_receipt_layout(state, extra, step)
    if src is not None and src.total_padded != padded:
        raise GeometryReceiptError(
            f"opt-layout receipt at step {step} claims total_padded="
            f"{src.total_padded} but the saved momentum has length "
            f"{padded}")
    target = state.layout
    if target is None:
        return convert_opt_state(trace, shapes, None, src_bucket_layout=src)
    target_receipt = target.describe() if target.bucket_bytes > 0 else None
    if not (layout == "flat" and padded == target.total_padded
            and receipt == target_receipt):
        trace = convert_opt_state(
            trace, shapes, target.total_padded, src_bucket_layout=src,
            target_bucket_layout=target if target_receipt else None)
    return _row(state, trace)


def migrate_params(state: TrainState, tree: Mapping[str, Any],
                   extra: Mapping[str, Any], step: int,
                   prefix: str = "params") -> Optional[Value]:
    """The saved params (`prefix` "params") or EMA params ("ema_params")
    of `tree` in `state`'s layout: the name -> tensor tree, or this rank's
    (S,) shard under ZeRO-3; None when the checkpoint holds none. A flat
    source reads through the `param_layout` receipt
    (`check_param_receipt`)."""
    shapes = state.shapes
    dev = state.device
    flat = prefix in tree
    if not flat and not any(k.startswith(prefix + "/") for k in tree):
        return None
    src = check_param_receipt(
        state, {"params": tuple(tree[prefix].shape)} if flat else {},
        extra, step)
    value: Value = (torch.as_tensor(tree[prefix]).to(dev, torch.float32)
                    if flat else leaves_from_tree(tree, prefix, shapes, dev))
    target = state.layout if state.shard_params else None
    if target is None:
        return convert_params(value, shapes, None, src_bucket_layout=src)
    bucketed = target.bucket_bytes > 0
    same = (flat and value.shape[0] == target.total_padded
            and ((src is not None and bucketed
                  and src.describe() == target.describe())
                 or (src is None and not bucketed)))
    if not same:
        value = convert_params(
            value, shapes, target.total_padded, src_bucket_layout=src,
            target_bucket_layout=target if bucketed else None)
    return _row(state, value)


def _row(state: TrainState, vec: torch.Tensor) -> torch.Tensor:
    """This rank's (S,) row of a (T,) vector in the state's layout."""
    target = state.layout
    rank = rank_and_size(state.group)[0]
    return vec.reshape(target.num_shards, target.shard_size)[rank].clone()


def restore_any_topology(manager, state: TrainState,
                         step: Optional[int] = None
                         ) -> Tuple[TrainState, Mapping[str, Any],
                                    Optional[str]]:
    """Restore `manager`'s checkpoint at `step` (default: its newest
    intact step) into `state`, in place, in `state`'s layout: replicated,
    ZeRO-1/2 or ZeRO-3, at any shard count, from a checkpoint of any of
    them. The params receipt is checked on the arrays' headers before the
    arrays are read. Returns `(state, extra, ema_event)`; `ema_event` is
    `TrainState.load_checkpoint_tree`'s."""
    step = step if step is not None else manager.best_step()
    check_param_receipt(
        state, {k: m.shape for k, m in manager.state_metadata(step).items()},
        manager.extra_at(step), step)
    tree, extra = manager.restore(step)
    momentum = migrate_momentum(state, tree, extra, step)
    params = migrate_params(state, tree, extra, step)
    if params is None:
        raise GeometryReceiptError(f"checkpoint step {step} holds no params")
    ema = migrate_params(state, tree, extra, step, "ema_params")
    ema_event = state.load_checkpoint_tree(tree, momentum, params=params,
                                           ema_params=ema)
    return state, extra, ema_event

"""ZeRO-1/2/3 sharding over the data-parallel group — the counterpart of
the JAX package's parallel/zero.py (:45–189).

    gradients (per replica)
      └─ flatten to one vector in the Flax leaf order, pad to a multiple of N
      └─ reduce-scatter — each replica receives its 1/N contiguous shard
         of the sum of the gradients
      └─ the optimizer updates that shard only — momentum lives on it
         (1/N of the memory per card)
      └─ all-gather of the updated parameter shards — replicas re-sync

Under `mesh.comm_bucket_mb > 0` the flat vector is parallel/buckets.py's
bucket-major one instead; `zero_layout` picks the layout for a step and
its state. The unbucketed layout here is a `GradBucketLayout` with one
bucket that holds every leaf in canonical order: its (N, S) view's row r
is then the r-th contiguous slice of the canonical flat vector, JAX's
`ravel_pytree` plus padding.

A checkpoint's momentum comes in one of three layouts: the per-parameter
tree (replicated SGD), the canonical flat vector padded to a multiple of
N, or the bucket-major flat vector of a `GradBucketLayout`.
`params_layout` tells them apart by shape (JAX `zero.py:98`) and
`convert_opt_state` (JAX `zero.py:189`) converts between any two, at
any shard counts, by copies on the tensors' own device
(checkpoint/retopology.py).

Under ZeRO-3 (`mesh.shard_params`) the parameters and their EMA persist
as the same (S,) shard of the same flat layout, gathered just in time
by the step (parallel/buckets.py `gather_param_tree`); a checkpoint then
holds them as the (T,) vector, and `convert_params` (JAX `zero.py:150`)
converts them as `convert_opt_state` converts the momentum.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

from distributed_vgg_f_tpu_torch.parallel.buckets import (
    GradBucketLayout, Params, _layout, build_bucket_layout, canonical_leaves)


def flat_param_count(params: Union[Params, Sequence[torch.Tensor]]) -> int:
    """Total element count of the parameters."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    elif isinstance(params, Mapping):
        params = list(params.values())
    return int(sum(math.prod(t.shape) for t in params))


def padded_flat_size(total: int, num_shards: int) -> int:
    """Flat vector length after padding to a multiple of the shard count."""
    return total + (-total) % num_shards


def params_layout(params: Union[Params, torch.Tensor],
                  total: int) -> Tuple[str, Optional[int]]:
    """The layout of a params value or a momentum from shapes alone:
    ('flat', padded) for one flat vector at least `total` (the parameter
    count) long, ('tree', None) for per-parameter tensors (JAX
    `zero.py:98 opt_state_layout`, `:126 params_layout`). No single
    parameter holds the whole network, so a 1-D tensor that long can only
    be the flat vector."""
    if isinstance(params, torch.Tensor):
        params = {"": params}
    elif isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    for t in params.values():
        if t.dim() == 1 and t.shape[0] >= total:
            return "flat", int(t.shape[0])
    return "tree", None


def flat_layout(params: Params, num_shards: int, *,
                num_heads: Optional[int] = None) -> GradBucketLayout:
    """The unbucketed ZeRO layout: one bucket, every leaf in canonical
    (Flax) order, padded to a multiple of `num_shards`."""
    leaves = canonical_leaves(params, num_heads)
    return _layout(leaves, num_shards, 0, [list(range(len(leaves)))])


def zero_layout(params: Params, num_shards: int, comm_bucket_mb: float, *,
                num_heads: Optional[int] = None) -> GradBucketLayout:
    """The flat layout a ZeRO-1/2 step and its state share: bucket-major
    over `comm_bucket_mb` buckets, or the single canonical flat vector
    when it is 0."""
    bucket_bytes = (int(round(comm_bucket_mb * 1024 * 1024))
                    if comm_bucket_mb else 0)
    layout = build_bucket_layout(params, num_shards, bucket_bytes,
                                 num_heads=num_heads)
    return layout if layout is not None else flat_layout(
        params, num_shards, num_heads=num_heads)


def flatten_params(params: Params, padded: int, *,
                   bucket_layout: Optional[GradBucketLayout] = None
                   ) -> torch.Tensor:
    """Parameters -> the fp32 flat vector: bucket-major (`to_global`) when
    a bucket layout is given, else the canonical-order ravel, zero-padded
    to `padded`."""
    layout = bucket_layout or flat_layout(params, 1)
    vec = layout.to_global(layout.leaves(params))
    if bucket_layout is not None:
        return vec
    if padded < vec.numel():
        raise ValueError(f"padded length {padded} below the parameter "
                         f"count {vec.numel()}")
    return torch.nn.functional.pad(vec, (0, padded - vec.numel()))


def unflatten(vec: torch.Tensor, like: Params, *,
              bucket_layout: Optional[GradBucketLayout] = None
              ) -> Mapping[str, torch.Tensor]:
    """Inverse of `flatten_params`: the flat vector -> the port's name ->
    tensor, shaped like the parameters of `like`; padding is dropped."""
    if bucket_layout is not None:
        return bucket_layout.from_global(vec)
    layout = flat_layout(like, 1)
    return layout.from_global(vec[:layout.total_padded])


def _convert(value: Union[Mapping[str, torch.Tensor], torch.Tensor],
             params: Params, target_padded: Optional[int], what: str, *,
             src_bucket_layout: Optional[GradBucketLayout],
             target_bucket_layout: Optional[GradBucketLayout]
             ) -> Union[Mapping[str, torch.Tensor], torch.Tensor]:
    """The one conversion behind `convert_params` and `convert_opt_state`:
    a tree or a flat vector in, the tree (`target_padded` None) or a flat
    vector out, every element copied."""
    canonical = flat_layout(params, 1)   # the module names its heads
    total = canonical.total_padded
    layout, padded_src = params_layout(value, total)
    if layout == "flat":
        vec = value if isinstance(value, torch.Tensor) else \
            next(iter(value.values()))
        if src_bucket_layout is not None:
            if padded_src != src_bucket_layout.total_padded:
                raise ValueError(
                    f"src bucket layout total_padded="
                    f"{src_bucket_layout.total_padded} does not match the "
                    f"saved flat {what} length {padded_src}")
            tree = src_bucket_layout.from_global(vec)
        else:
            tree = canonical.from_global(vec[:total])
    else:
        tree = dict(value)
    if target_padded is None:
        return tree
    if target_bucket_layout is not None:
        if target_padded != target_bucket_layout.total_padded:
            raise ValueError(
                f"target_padded={target_padded} disagrees with the target "
                f"bucket layout's total_padded="
                f"{target_bucket_layout.total_padded}")
        return target_bucket_layout.to_global(
            target_bucket_layout.leaves(tree))
    if target_padded < total:
        raise ValueError(f"padded length {target_padded} below the "
                         f"parameter count {total}")
    return torch.nn.functional.pad(
        canonical.to_global(canonical.leaves(tree)),
        (0, target_padded - total))


def convert_params(params: Union[Mapping[str, torch.Tensor], torch.Tensor],
                   params_struct: Params, target_padded: Optional[int], *,
                   src_bucket_layout: Optional[GradBucketLayout] = None,
                   target_bucket_layout: Optional[GradBucketLayout] = None
                   ) -> Union[Mapping[str, torch.Tensor], torch.Tensor]:
    """Convert a params (or EMA params) value between its layouts (JAX
    `zero.py:150`): the replicated tree (the port's name -> tensor in the
    port's layout) <-> the ZeRO-3 canonical flat vector padded to any
    multiple <-> the bucket-major flat vector of a `GradBucketLayout`, at
    any shard count. `params_struct` (a module, its meta twin, or a name
    -> tensor mapping) gives the names and shapes. `target_padded` None
    means the tree; `src_bucket_layout` says how to read a flat source
    (None: the canonical order, the absent receipt). Pure copies, so the
    conversion is bit-exact, on the tensors' own device; a length that
    disagrees with a layout raises ValueError."""
    return _convert(params, params_struct, target_padded, "params",
                    src_bucket_layout=src_bucket_layout,
                    target_bucket_layout=target_bucket_layout)


def convert_opt_state(trace: Union[Mapping[str, torch.Tensor],
                                   torch.Tensor],
                      params: Params, target_padded: Optional[int], *,
                      src_bucket_layout: Optional[GradBucketLayout] = None,
                      target_bucket_layout: Optional[GradBucketLayout] = None
                      ) -> Union[Mapping[str, torch.Tensor], torch.Tensor]:
    """Convert a momentum between its layouts (JAX `zero.py:189`): the
    per-parameter tree (the port's name -> tensor in the port's layout,
    as `TrainState.momentum()` gives it) <-> the canonical flat vector
    padded to any multiple <-> the bucket-major flat vector of a
    `GradBucketLayout`, at any shard count. `params` (the model, its meta
    twin or its name -> tensor) gives the names and shapes.

    `target_padded`: the target flat length (a bucket layout's
    `total_padded` when `target_bucket_layout` is given; they must
    agree), or None for the tree. `src_bucket_layout`: how to read a flat
    source — None means the canonical order (the absent receipt).
    Padding is zeros, which is what the momentum holds there (padding's
    gradients are zero), so growing, shrinking or re-bucketing the pad
    loses nothing. Every element is copied, never computed, so the
    conversion is bit-exact."""
    return _convert(trace, params, target_padded, "vector",
                    src_bucket_layout=src_bucket_layout,
                    target_bucket_layout=target_bucket_layout)

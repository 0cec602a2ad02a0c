"""ZeRO-1/2 optimizer-state sharding over the data-parallel group — the
counterpart of the JAX package's parallel/zero.py (:45–147).

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
    """The layout of a params value from shapes alone: ('flat', padded)
    for one flat vector at least `total` (the parameter count) long,
    ('tree', None) for the parameters themselves. No single parameter
    holds the whole network, so a 1-D tensor that long can only be the
    flat vector."""
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

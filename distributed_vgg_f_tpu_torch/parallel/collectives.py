"""Collectives over torch.distributed — the counterparts of the JAX
package's parallel/collectives.py and of the ring's `lax.ppermute` and
`lax.all_to_all(..., tiled=True)`.

The gradient exchange: `cast_to_wire` / `cast_from_wire` (the one place
where every exchange leg narrows to mesh.reduce_dtype; the ZeRO param
all-gather never calls it), `all_reduce_gradients` (the per-leaf mean),
`cross_replica_mean` (the step's metrics, packed into one all-reduce),
`replica_index`, `pmean` (the differentiable mean sync-BN averages its
statistics with), and the sum legs `all_reduce_sum`, `reduce_scatter_sum`
and `all_gather_flat` that parallel/buckets.py issues. A mean is the sum
divided by the group size, as `lax.pmean` is: NCCL and gloo both sum,
and gloo has no average.

The sequence-parallel path: `ring_pass` / `ring_shift` and `all_to_all`.

Without a process group every function runs as on one rank: the means,
the shift and the all-to-all return their input, the sum legs leave
their buffers as they are. `check_backend` holds a group to the device:
NCCL for CUDA tensors, gloo for the CPU.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist


def rank_and_size(group=None) -> Tuple[int, int]:
    """(this process's rank, the group's size); (0, 1) without a group."""
    if not dist.is_available() or not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but torch."
                             "distributed is not initialized")
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def replica_index(group=None) -> int:
    """This process's index in the data-parallel group (the reference's
    `lax.axis_index`); 0 without a group."""
    return rank_and_size(group)[0]


def check_backend(group, device: torch.device) -> None:
    """Refuse a group that cannot carry `device`'s tensors: a CUDA run
    exchanges over NCCL and never drops to gloo, a CPU run over gloo."""
    if not _group_up():
        return
    backend = str(dist.get_backend(group)).lower()
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"the process group runs {backend!r}; a "
                           f"{device.type} run exchanges over {want!r}")


def cast_to_wire(x: torch.Tensor,
                 wire_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """THE gradient-wire cast (mesh.reduce_dtype): every exchange leg —
    per-leaf and per-bucket all-reduce, flat and per-bucket
    reduce-scatter — narrows here. None or the same dtype: `x` itself."""
    if wire_dtype is None or x.dtype == wire_dtype:
        return x
    return x.to(wire_dtype)


def cast_from_wire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The way back from the wire to the optimizer's dtype."""
    return x if x.dtype == dtype else x.to(dtype)


def all_reduce_sum(x: torch.Tensor, group=None, async_op: bool = False):
    """In-place sum over the group; the work handle with `async_op`
    (None without a group: `x` is already the sum)."""
    if not _group_up():
        rank_and_size(group)
        return None
    return dist.all_reduce(x, group=group, async_op=async_op)


def reduce_scatter_sum(out: torch.Tensor, x: torch.Tensor, group=None,
                       async_op: bool = False):
    """`out` (x.numel() / n,) gets this rank's piece of the sum of `x`:
    rank r the elements [r * len(out), (r + 1) * len(out)) — the tiled
    `lax.psum_scatter`. Without a group `out` takes `x`."""
    if not _group_up():
        rank_and_size(group)
        out.copy_(x)
        return None
    return dist.reduce_scatter_tensor(out, x, group=group,
                                      async_op=async_op)


def all_gather_flat(out: torch.Tensor, x: torch.Tensor, group=None,
                    async_op: bool = False):
    """`out` (n * len(x),) gets every rank's `x` in rank order — the tiled
    `lax.all_gather`. Without a group `out` takes `x`."""
    if not _group_up():
        rank_and_size(group)
        out.copy_(x)
        return None
    return dist.all_gather_into_tensor(out, x, group=group,
                                       async_op=async_op)


def all_reduce_gradients(grads: Sequence[torch.Tensor], group=None,
                         reduce_dtype: Optional[torch.dtype] = None
                         ) -> None:
    """Mean-all-reduce each gradient in place, one collective per leaf.
    `reduce_dtype` (e.g. torch.bfloat16) narrows each leaf for the wire
    only; the mean lands back in the leaf's own dtype."""
    _, n = rank_and_size(group)
    for g in grads:
        wire = cast_to_wire(g, reduce_dtype)
        all_reduce_sum(wire, group)
        if wire is not g:
            g.copy_(wire)
        g.div_(n)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return pmean_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return pmean_(g.detach().clone(), ctx.group), None


def pmean_(x: torch.Tensor, group=None) -> torch.Tensor:
    """In-place mean of `x` over the group (the sum, then / n); `x`
    itself without a group or in a group of one."""
    _, n = rank_and_size(group)
    if n > 1:
        dist.all_reduce(x, group=group)
        x.div_(n)
    return x


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """`lax.pmean(x, axis)`: the mean of `x` over the group, one
    all-reduce. Differentiable: the backward is the transpose of the mean,
    the mean of the incoming gradient over the group (one all-reduce
    more), so each rank's gradient of its local loss carries every rank's
    dependence on the shared statistic, as JAX's under `shard_map` does.
    Without a group, or in a group of one, `x` comes back: no collective.
    A collective that fails raises; nothing falls back to the local
    value."""
    if rank_and_size(group)[1] == 1:
        return x
    return _PMean.apply(x, group)


Metrics = Union[torch.Tensor, Mapping[str, torch.Tensor]]


def cross_replica_mean(x: Metrics, group=None) -> Metrics:
    """Mean over the group of one tensor or of a dict of scalar tensors;
    a dict rides one all-reduce, its values packed into one vector.
    Without a group (or in a group of one) the input comes back."""
    _, n = rank_and_size(group)
    if n == 1:
        return x
    if isinstance(x, torch.Tensor):
        out = x.detach().clone()
        all_reduce_sum(out, group)
        return out / n
    keys = list(x)
    packed = torch.stack([x[k].detach().float().reshape(()) for k in keys])
    all_reduce_sum(packed, group)
    packed = packed / n
    return {k: packed[i] for i, k in enumerate(keys)}


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def ring_pass(tensors: Sequence[torch.Tensor], group=None,
              reverse: bool = False) -> List[torch.Tensor]:
    """Each tensor to the next rank on the ring and the previous rank's in
    its place (the other way round with `reverse`), all in one
    batch_isend_irecv; not differentiable. With one rank nothing is sent
    and the tensors come back as they are."""
    rank, n = rank_and_size(group)
    if n == 1:
        return list(tensors)
    step = -1 if reverse else 1
    dst = _peer(group, (rank + step) % n)
    src = _peer(group, (rank - step) % n)
    ops, outs = [], []
    for t in tensors:
        t = t.contiguous()
        out = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, out, src, group))
        outs.append(out)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(ring_pass(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ring_pass(grads, ctx.group, reverse=True))


def ring_shift(*tensors: torch.Tensor, group=None) -> Tuple[torch.Tensor,
                                                            ...]:
    """Differentiable `ring_pass`: the backward shifts the gradients the
    other way."""
    if rank_and_size(group)[1] == 1:
        return tensors
    return _RingShift.apply(group, *tensors)


class _DependOn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.deps))


def depend_on(x: torch.Tensor, *deps: torch.Tensor) -> torch.Tensor:
    """x, tied in the autograd graph to `deps` (which get zero gradients).
    Autograd runs a node's backward only where its output was used, but
    the backward of a collective is a collective that every rank must
    join: a ring step whose block one rank skips (a causal block wholly in
    its future) would leave the neighbours waiting. Tying the received
    blocks to the output keeps every rank's backward schedule the same."""
    if not any(d.requires_grad for d in deps):
        return x
    return _DependOn.apply(x, *deps)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    _, n = rank_and_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    # chunk i leads as row i: all_to_all_single sends row i to rank i
    rows = torch.stack(x.chunk(n, dim=split_dim))
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims = (split_dim, concat_dim)
        ctx.group = group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g.contiguous(), concat_dim, split_dim,
                           ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group=None) -> torch.Tensor:
    """Tiled all-to-all: dim `split_dim` is cut into one chunk per rank,
    chunk i goes to rank i, and the chunks received are concatenated along
    `concat_dim` in rank order. Differentiable: the backward is the
    all-to-all with the two dims swapped. Without a process group the
    input comes back as it is."""
    if not dist.is_available() or not dist.is_initialized():
        rank_and_size(group)  # raises on a group without a process group
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)

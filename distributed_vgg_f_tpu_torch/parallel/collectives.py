"""The collectives of the sequence-parallel path, over torch.distributed —
the counterparts of `lax.ppermute` to the next device on the ring and of
`lax.all_to_all(..., tiled=True)`. (The JAX module's pmean, buckets and
ZeRO parts wait for ROADMAP A7.)

Without a process group every function runs as on one rank: the shift
and the all-to-all return their input.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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

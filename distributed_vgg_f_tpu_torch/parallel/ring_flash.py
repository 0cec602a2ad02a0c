"""Ring x flash: sequence-parallel attention whose blocks run the ring
block kernels — the counterpart of the JAX package's
parallel/ring_flash.py (`_local_fn` and its custom VJP).

The forward sends the K/V blocks around the ring as ring_attention.py
does, but each step folds the visiting block into the online-softmax
state (acc, m, l) with `flash_block_update` (csrc/flash_block_fwd.cu on
the card), so nothing quadratic is ever held: the residuals are q, k, v,
the output and the row logsumexp. The backward runs the ring again, with
fp32 dK/dV accumulators that travel with their block: each rank adds its
contribution with `flash_block_grads` (csrc/flash_block_dq.cu and
csrc/flash_block_dkv.cu) as the block visits, and one final hop brings
each accumulator home; dQ accumulates locally. Both rings send the same
blocks on every rank at every step; a block wholly in a rank's future is
skipped by that rank alone.

Each process holds only its shard, so the JAX global-array wrapper
becomes the per-shard `ring_flash_attention`; its divisibility contract
(T a multiple of the ring size) is the caller's. A ragged local length
such as T_loc = 197 needs no padding: the kernels mask rows and keys past
T_loc themselves.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from distributed_vgg_f_tpu_torch.ops.flash_attention import (
    flash_block_grads, flash_block_update)
from distributed_vgg_f_tpu_torch.parallel.collectives import (rank_and_size,
                                                              ring_pass)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> contiguous (B*H, T, D)."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _bthd(x: torch.Tensor, b: int, dtype: torch.dtype) -> torch.Tensor:
    """(B*H, T, D) -> (B, T, H, D) in `dtype`."""
    bh, t, d = x.shape
    return x.reshape(b, bh // b, t, d).permute(0, 2, 1, 3).to(dtype)


def _future(q_off: int, k_off: int, t: int, causal: bool) -> bool:
    """Whether every key of the block at k_off lies past every query row of
    the shard at q_off (the fold would be the identity)."""
    return causal and k_off > q_off + t - 1


class RingFlashFunction(torch.autograd.Function):
    """Forward and backward rings over the block kernels; saves q, k, v,
    the output and lse. Differentiable once."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        rank, n = rank_and_size(group)
        b, t, h, d = q.shape
        q3, k3, v3 = _rows(q), _rows(k), _rows(v)
        acc = torch.zeros(q3.shape, dtype=torch.float32, device=q.device)
        m = torch.full((b * h, t, 1), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b * h, t, 1), dtype=torch.float32, device=q.device)
        q_off = rank * t
        k_blk, v_blk = k3, v3
        for step in range(n):
            k_off = ((rank - step) % n) * t
            if not _future(q_off, k_off, t, causal):
                flash_block_update(q3, k_blk, v_blk, acc, m, l, q_off=q_off,
                                   k_off=k_off, causal=causal)
            if step < n - 1:
                k_blk, v_blk = ring_pass([k_blk, v_blk], group)
        out3 = (acc / l).to(q.dtype)
        lse = m + torch.log(l)
        ctx.save_for_backward(q3, k3, v3, out3, lse)
        ctx.group, ctx.causal, ctx.b = group, causal, b
        return _bthd(out3, b, q.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q3, k3, v3, out3, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        rank, n = rank_and_size(group)
        t = q3.shape[1]
        do3 = _rows(g.to(q3.dtype))
        delta = (do3.float() * out3.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
        dk_blk = torch.zeros(k3.shape, dtype=torch.float32, device=q3.device)
        dv_blk = torch.zeros(v3.shape, dtype=torch.float32, device=q3.device)
        q_off = rank * t
        k_blk, v_blk = k3, v3
        for step in range(n):
            k_off = ((rank - step) % n) * t
            if not _future(q_off, k_off, t, causal):
                flash_block_grads(q3, k_blk, v_blk, do3, lse, delta, dq,
                                  dk_blk, dv_blk, q_off=q_off, k_off=k_off,
                                  causal=causal)
            if step < n - 1:
                k_blk, v_blk, dk_blk, dv_blk = ring_pass(
                    [k_blk, v_blk, dk_blk, dv_blk], group)
        # block o was last visited by rank o - 1: one hop brings its
        # accumulators home (nothing is sent at n = 1)
        dk_blk, dv_blk = ring_pass([dk_blk, dv_blk], group)
        b = ctx.b
        return (_bthd(dq, b, q3.dtype), _bthd(dk_blk, b, k3.dtype),
                _bthd(dv_blk, b, v3.dtype), None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, group=None, causal: bool = False) -> torch.Tensor:
    """Exact attention over a sequence sharded across the group, from this
    rank's (B, T_loc, H, D) shards (rank r holds positions r*T_loc ..
    (r+1)*T_loc - 1); returns this rank's (B, T_loc, H, D) output.
    Differentiable; O(T_loc * D) residual memory. CUDA tensors run the
    ring block kernels, CPU tensors their plain versions."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one (B, T_loc, H, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    return RingFlashFunction.apply(q, k, v, group, bool(causal))

"""Ring attention: exact self-attention over a sequence sharded across
processes — the counterpart of the JAX package's
parallel/ring_attention.py (`ring_self_attention`,
`full_attention_reference`).

Each process holds its (B, T_loc, H, D) shard of q, k and v. The K/V
block travels the ring (`collectives.ring_shift`: one batch_isend_irecv
to the next rank and from the previous one a step, in place of
`lax.ppermute`), and each step folds the visiting block into a streaming
softmax (running row max, row sum and unnormalised output, fp32), with
einsum block math. Autograd runs through the einsums and the shifts, so
the backward holds each step's (B, H, T_loc, T_loc) probabilities, as
the JAX version's does; parallel/ring_flash.py is the flash counterpart.
"""

from __future__ import annotations

import math

import torch

from distributed_vgg_f_tpu_torch.parallel.collectives import (
    depend_on, rank_and_size, ring_shift)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, group=None, causal: bool = False) -> torch.Tensor:
    """This rank's (B, T_loc, H, D) output, attending over the whole
    sequence, from its (B, T_loc, H, D) shards of q, k and v (rank r
    holds positions r*T_loc .. (r+1)*T_loc - 1 of the group).

    `causal`: position i attends to j <= i, by global position. K/V
    blocks travel the ring all the same (every rank sends and receives
    at every step), but a block wholly in this rank's future is skipped:
    its fold would be the identity. Rounding as in JAX: q is scaled in
    its own dtype, scores and softmax statistics are fp32, and the
    probabilities are cast to v's dtype before P.V."""
    rank, n = rank_and_size(group)
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    qf = (q * (1.0 / math.sqrt(d))).float()
    acc = torch.zeros((b, t_q, h, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, h, t_q), -math.inf, dtype=torch.float32,
                         device=q.device)
    row_sum = torch.zeros((b, h, t_q), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    received = []
    for step in range(n):
        src = (rank - step) % n
        # fully future: the block's first key is past the last local query
        if not (causal and src * t_k > rank * t_q + t_q - 1):
            scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
            if causal:
                q_pos = rank * t_q + torch.arange(t_q, device=q.device)
                k_pos = src * t_k + torch.arange(t_k, device=q.device)
                allowed = q_pos[:, None] >= k_pos[None, :]
                scores = scores.masked_fill(~allowed, -math.inf)
            # step 0 is the rank's own diagonal block, where every row sees
            # its own position, so new_max is finite from the first step
            new_max = torch.maximum(row_max, scores.amax(dim=-1))
            correction = torch.exp(row_max - new_max)
            probs = torch.exp(scores - new_max[..., None])
            row_sum = row_sum * correction + probs.sum(dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd",
                               probs.to(v_blk.dtype).float(), v_blk.float())
            acc = acc * correction.transpose(1, 2)[..., None] + ctx
            row_max = new_max
        if step < n - 1:
            k_blk, v_blk = ring_shift(k_blk, v_blk, group=group)
            received += [k_blk, v_blk]
    out = acc / row_sum.transpose(1, 2)[..., None]
    # the backward of every shift runs on every rank, skipped blocks too
    return depend_on(out, *received).to(q.dtype)


def full_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             causal: bool = False) -> torch.Tensor:
    """The plain O(T^2)-memory attention the ring is held against, with
    the JAX version's rounding points; (B, T, H, D) in and out."""
    t, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk",
                          (q * (1.0 / math.sqrt(d))).float(), k.float())
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)

"""Exact (flash) self-attention whose (T, T) score matrix never reaches
device memory — the counterpart of the JAX package's
``ops/flash_attention.py`` `flash_self_attention` (its rectangular
kernels: `_fwd_kernel`, `_dq_kernel`, `_dkv_kernel`).

`flash_self_attention(q, k, v, causal=..., kv_len=...)` takes and gives
(B, T, H, D), as the JAX function does, through `FlashAttentionFunction`:
the forward saves q, k, v, o and the row logsumexp lse; the backward
computes delta = rowsum(dO * O) in fp32 and then dQ and dK/dV. Each of
the three steps launches its Hopper kernel (ops/flash_cuda.py) for CUDA
tensors and runs its plain version below for CPU tensors.

The plain versions are explicit formulas over the whole sequence, in
(B, H, T, D) fp32, and are what each kernel is held against:

- `attention_fwd`: s = (q . k) * scale, masked; m = max s, l = sum
  exp(s - m); o = round(exp(s - m)) . v / l; lse = m + log l, (B, H, T).
- `attention_dq`: p = exp(s - lse), dS = p * (dO . v - delta),
  dQ = scale * round(dS) . k.
- `attention_dkv`: dV = round(p)^T . dO, dK = scale * round(dS)^T . q.

Rounding follows the JAX kernels: scores and softmax statistics in fp32,
p cast to v's dtype before P.V (to dO's for dV), dS cast to k's and q's
dtype before the dQ and dK products, outputs in the input dtype. The
masks are those of the JAX `_mask_scores`: causal by global position,
and keys at or past `kv_len` never attended to. A masked pair gets
p = 0, so masked keys get exactly zero dK and dV. The JAX function pads
T = 197 to 256 for its TPU blocks and masks the tail; the kernels and the
plain versions mask keys past T themselves, which is the same function.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from distributed_vgg_f_tpu_torch.ops import flash_cuda


def _bhtd(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> (B, H, T, D) in fp32 (fp64 stays fp64)."""
    return x.permute(0, 2, 1, 3).to(torch.promote_types(x.dtype,
                                                        torch.float32))


def _btHd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, T, D) -> contiguous (B, T, H, D) in `dtype`."""
    return x.permute(0, 2, 1, 3).to(dtype).contiguous()


def _live(t: int, causal: bool, kv_len: int, device) -> torch.Tensor:
    """(T, T) mask of the attended (query, key) pairs."""
    pos = torch.arange(t, device=device)
    live = (pos < kv_len)[None, :].expand(t, t)
    if causal:
        live = live & (pos[:, None] >= pos[None, :])
    return live


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` and back to x's dtype."""
    return x.to(dtype).to(x.dtype)


def _probs(q, k, lse, scale, live):
    """p = exp(s - lse) with s = (q . k) * scale, 0 where masked."""
    s = torch.matmul(_bhtd(q), _bhtd(k).transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    return torch.where(live, p, torch.zeros((), dtype=p.dtype,
                                            device=p.device))


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, kv_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (o in q's dtype (B, T, H, D), lse fp32 (B, H, T))."""
    b, t, h, d = q.shape
    kv_len = t if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(d)
    live = _live(t, causal, kv_len, q.device)
    s = torch.matmul(_bhtd(q), _bhtd(k).transpose(-1, -2)) * scale
    s = torch.where(live, s, torch.full((), -math.inf, dtype=s.dtype,
                                        device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    m_use = torch.where(m == -math.inf, torch.zeros_like(m), m)
    p = torch.exp(s - m_use)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(_rounded(p, v.dtype), _bhtd(v))
    o = torch.where(l > 0, acc / l, torch.zeros_like(acc))
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.full_like(l, -math.inf))[..., 0]
    return _btHd(o, q.dtype), lse.to(torch.promote_types(q.dtype,
                                                         torch.float32))


def attention_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain dQ in q's dtype, (B, T, H, D), from the forward's residuals,
    dO (B, T, H, D) and delta = rowsum(dO * O) (B, H, T) fp32."""
    b, t, h, d = q.shape
    kv_len = t if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(d)
    p = _probs(q, k, lse, scale, _live(t, causal, kv_len, q.device))
    dp = torch.matmul(_bhtd(do), _bhtd(v).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = scale * torch.matmul(_rounded(ds, k.dtype), _bhtd(k))
    return _btHd(dq, q.dtype)


def attention_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                  kv_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (dK in k's dtype, dV in v's dtype), each (B, T, H, D)."""
    b, t, h, d = q.shape
    kv_len = t if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(d)
    p = _probs(q, k, lse, scale, _live(t, causal, kv_len, q.device))
    dv = torch.matmul(_rounded(p, do.dtype).transpose(-1, -2), _bhtd(do))
    dp = torch.matmul(_bhtd(do), _bhtd(v).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk = scale * torch.matmul(_rounded(ds, q.dtype).transpose(-1, -2),
                              _bhtd(q))
    return _btHd(dk, k.dtype), _btHd(dv, v.dtype)


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = sum_d dO * O in fp32, (B, H, T): the softmax backward's row
    constant (elementwise, not a kernel, as in the JAX backward)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its two backward kernels. Saves q, k, v, o
    and lse (the JAX `op_fwd` residuals). Each direction dispatches on
    the tensors' device: the Hopper kernels for CUDA, the plain versions
    for the CPU. Differentiable once."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len):
        if q.is_cuda:
            o, lse = flash_cuda.flash_fwd_cuda(q, k, v, causal=causal,
                                               kv_len=kv_len)
        else:
            o, lse = attention_fwd(q, k, v, causal=causal, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.flash_args = {"causal": causal, "kv_len": kv_len}
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(do, o)
        if q.is_cuda:
            dq = flash_cuda.flash_dq_cuda(q, k, v, do, lse, delta,
                                          **ctx.flash_args)
            dk, dv = flash_cuda.flash_dkv_cuda(q, k, v, do, lse, delta,
                                               **ctx.flash_args)
        else:
            dq = attention_dq(q, k, v, do, lse, delta, **ctx.flash_args)
            dk, dv = attention_dkv(q, k, v, do, lse, delta,
                                   **ctx.flash_args)
        return dq, dk, dv, None, None


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """Exact self-attention, (B, T, H, D) in and out; the (T, T) scores
    never reach device memory on the card. `kv_len` marks the first
    `kv_len` keys as real and the rest as padding: never attended to,
    with exactly zero gradient."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one (B, T, H, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    t = q.shape[1]
    if kv_len is not None and not 1 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    return FlashAttentionFunction.apply(q, k, v, bool(causal),
                                        t if kv_len is None else int(kv_len))

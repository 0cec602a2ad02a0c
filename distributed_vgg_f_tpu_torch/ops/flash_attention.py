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

The ring block functions `flash_block_update` and `flash_block_grads`
(the JAX functions of the same names, whose TPU kernels are
`_ring_fwd_kernel`, `_ring_dq_kernel` and `_ring_dkv_kernel`) fold one
visiting K/V block into state the caller carries from call to call, in
the JAX layout (B*H, T, D): the online-softmax state (acc, m, l) in the
forward; dQ and the travelling dK/dV accumulators in the backward; all
fp32. Causal masking is by global position (q_off + row >= k_off + col),
and keys of the visiting block at or past the block-local `kv_len` are
padding. Their plain versions, `block_update_plain` and
`block_grads_plain`, are whole-block formulas with the same rounding
points; for CUDA tensors the functions launch the Hopper kernels
(ops/flash_cuda.py), which update the state in place.
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


#: the JAX function's `causal_skip` values
CAUSAL_SKIPS = ("auto", "mxu", "dma")


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False,
                         kv_len: Optional[int] = None,
                         causal_skip: str = "auto") -> torch.Tensor:
    """Exact self-attention, (B, T, H, D) in and out; the (T, T) scores
    never reach device memory on the card. `kv_len` marks the first
    `kv_len` keys as real and the rest as padding: never attended to,
    with exactly zero gradient.

    `causal_skip` takes the JAX function's values and checks them as it
    does: unknown values raise, and "dma" raises without causal=True. On
    the TPU it picks between the rectangular grids ("mxu") and the jagged
    grids that visit only the live lower-triangular tile pairs ("dma"),
    "auto" switching at a token count measured on a TPU v5e. Here all
    three run the same Hopper kernels: their causal loop bound already
    skips every tile above the diagonal, so no masked tile is read, which
    is what the jagged grids exist for, with the same numerics. The TPU
    threshold is not carried over. The JAX function's `block_q` and
    `block_k` (TPU block sizes) and `interpret` (the Pallas interpreter)
    are not ported: the kernels' 64-row tiles are fixed, and on the CPU
    the plain versions run."""
    if causal_skip not in CAUSAL_SKIPS:
        raise ValueError(f"causal_skip {causal_skip!r} not one of "
                         f"{CAUSAL_SKIPS}")
    if causal_skip == "dma" and not causal:
        raise ValueError("causal_skip='dma' only applies to causal "
                         "attention: drop it or set causal=True")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one (B, T, H, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    t = q.shape[1]
    if kv_len is not None and not 1 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    return FlashAttentionFunction.apply(q, k, v, bool(causal),
                                        t if kv_len is None else int(kv_len))


# ------------------------------------------------------- ring block steps
def _block_live(tq: int, tk: int, q_off: int, k_off: int, causal: bool,
                kv_len: int, device) -> torch.Tensor:
    """(Tq, Tk) mask of the live (local query, visiting key) pairs."""
    kloc = torch.arange(tk, device=device)
    live = (kloc < kv_len)[None, :].expand(tq, tk)
    if causal:
        qpos = torch.arange(tq, device=device) + q_off
        live = live & (qpos[:, None] >= (kloc + k_off)[None, :])
    return live


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in fp32 (fp64 stays fp64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def block_update_plain(q, k_blk, v_blk, acc, m, l, *, q_off: int,
                       k_off: int, causal: bool, kv_len: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain fold of one K/V block into (acc, m, l); returns new tensors.
    A row with no live key so far keeps m = -inf and rescales with 0 in
    its place, so -inf - -inf never occurs."""
    tq, d = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    live = _block_live(tq, k_blk.shape[1], q_off, k_off, causal, kv_len,
                       q.device)
    s = torch.matmul(_wide(q), _wide(k_blk).transpose(-1, -2)) * scale
    s = torch.where(live, s, torch.full((), -math.inf, dtype=s.dtype,
                                        device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
    corr = torch.exp(m - m_use)
    p = torch.exp(s - m_use)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.matmul(_rounded(p, v_blk.dtype),
                                        _wide(v_blk))
    return acc_new, m_new, l_new


def block_grads_plain(q, k_blk, v_blk, do, lse, delta, dq, dk_blk, dv_blk,
                      *, q_off: int, k_off: int, causal: bool, kv_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward step: (dq, dk_blk, dv_blk) plus this block's
    contributions, as new tensors. Masked pairs get p = 0, so padded
    keys add exactly zero to their dK and dV rows."""
    tq, d = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    live = _block_live(tq, k_blk.shape[1], q_off, k_off, causal, kv_len,
                       q.device)
    s = torch.matmul(_wide(q), _wide(k_blk).transpose(-1, -2)) * scale
    p = torch.where(live, torch.exp(s - lse),
                    torch.zeros((), dtype=s.dtype, device=s.device))
    dp = torch.matmul(_wide(do), _wide(v_blk).transpose(-1, -2))
    ds = p * (dp - delta)
    dq_new = dq + scale * torch.matmul(_rounded(ds, k_blk.dtype),
                                       _wide(k_blk))
    dk_new = dk_blk + scale * torch.matmul(
        _rounded(ds, q.dtype).transpose(-1, -2), _wide(q))
    dv_new = dv_blk + torch.matmul(_rounded(p, do.dtype).transpose(-1, -2),
                                   _wide(do))
    return dq_new, dk_new, dv_new


def _check_block_args(q, k_blk, v_blk, kv_len):
    if q.dim() != 3 or k_blk.dim() != 3 or k_blk.shape != v_blk.shape \
            or k_blk.shape[0] != q.shape[0] or k_blk.shape[2] != q.shape[2]:
        raise ValueError(f"q (B*H, Tq, D) and k_blk, v_blk (B*H, Tk, D) "
                         f"expected, got {tuple(q.shape)} "
                         f"{tuple(k_blk.shape)} {tuple(v_blk.shape)}")
    tk = k_blk.shape[1]
    kv_len = tk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= tk:
        raise ValueError(f"kv_len {kv_len} outside [1, {tk}]")
    return kv_len


def flash_block_update(q, k_blk, v_blk, acc, m, l, *, q_off: int,
                       k_off: int, causal: bool,
                       kv_len: Optional[int] = None):
    """Fold one K/V block into the online-softmax state (the JAX function
    of the same name). q: (B*H, Tq, D); k_blk, v_blk: (B*H, Tk, D); acc:
    (B*H, Tq, D) fp32; m, l: (B*H, Tq, 1) fp32. q_off and k_off are the
    global positions of query row 0 and key 0. Updates acc, m and l in
    place and returns them; finish with out = acc / l, lse = m + log l.
    CUDA tensors run the kernel (csrc/flash_block_fwd.cu), CPU tensors
    `block_update_plain`."""
    kv_len = _check_block_args(q, k_blk, v_blk, kv_len)
    if q.is_cuda:
        flash_cuda.flash_block_fwd_cuda(q, k_blk, v_blk, acc, m, l,
                                        q_off=q_off, k_off=k_off,
                                        causal=causal, kv_len=kv_len)
        return acc, m, l
    new = block_update_plain(q, k_blk, v_blk, acc, m, l, q_off=q_off,
                             k_off=k_off, causal=causal, kv_len=kv_len)
    for x, y in zip((acc, m, l), new):
        x.copy_(y)
    return acc, m, l


def flash_block_grads(q, k_blk, v_blk, do, lse, delta, dq, dk_blk, dv_blk,
                      *, q_off: int, k_off: int, causal: bool,
                      kv_len: Optional[int] = None):
    """One ring step of the backward (the JAX function of the same name):
    adds this block's contribution to dq (the local rows) and to the
    visiting block's dk_blk and dv_blk, which travel the ring with it.
    do: (B*H, Tq, D) in q's dtype; lse, delta: (B*H, Tq, 1) fp32; dq,
    dk_blk, dv_blk fp32. Updates dq, dk_blk and dv_blk in place and
    returns them. CUDA tensors run the kernels (csrc/flash_block_dq.cu,
    csrc/flash_block_dkv.cu), CPU tensors `block_grads_plain`."""
    kv_len = _check_block_args(q, k_blk, v_blk, kv_len)
    kw = {"q_off": q_off, "k_off": k_off, "causal": causal,
          "kv_len": kv_len}
    if q.is_cuda:
        flash_cuda.flash_block_dq_cuda(q, k_blk, v_blk, do, lse, delta, dq,
                                       **kw)
        flash_cuda.flash_block_dkv_cuda(q, k_blk, v_blk, do, lse, delta,
                                        dk_blk, dv_blk, **kw)
        return dq, dk_blk, dv_blk
    new = block_grads_plain(q, k_blk, v_blk, do, lse, delta, dq, dk_blk,
                            dv_blk, **kw)
    for x, y in zip((dq, dk_blk, dv_blk), new):
        x.copy_(y)
    return dq, dk_blk, dv_blk

"""Flash attention forward, dQ and dK/dV as hand-written Hopper kernels
(csrc/flash_fwd.cu, csrc/flash_dq.cu, csrc/flash_dkv.cu, sharing
csrc/flash_common.cuh), and the three ring block kernels
(csrc/flash_block_fwd.cu, csrc/flash_block_dq.cu, csrc/flash_block_dkv.cu)
at the end of this module.

They replace the JAX package's Pallas TPU kernels
``ops/flash_attention.py:_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``
and compute the functions of the plain versions in ops/flash_attention.py
(`attention_fwd`, `attention_dq`, `attention_dkv`).

Bound: device-memory bytes. At ViT's T = 197 and D = 64 each function
does 100-150 FLOP per byte it must move, below the H100's ~295 bf16
tensor-core FLOP a byte. The bf16 forward, dQ and dK/dV are
warp-specialised and persistent: a producer warp loads tiles by TMA into a
ring of shared-memory stages and two consumer warpgroups run every product
as wgmma, reading the transposed operands through the wgmma descriptor
(csrc/flash_fwd.cu, csrc/flash_dq.cu, csrc/flash_dkv.cu on
csrc/hopper.cuh). The three ring block kernels in bf16 have the same
design (csrc/flash_block_fwd.cu, csrc/flash_block_dq.cu,
csrc/flash_block_dkv.cu), with the block's own key length, the causal
diagonal shifted by q_off - k_off, and the carried fp32 state (the
fold's acc, m and l, the backward's accumulators) read into registers
and written back in place; fp32 runs everything on the CUDA cores.
Where the TPU kernels carry
(acc, m, l) or the gradient sums in scratch along a sequential grid axis,
a block here owns a tile of rows of one (b, h) and loops over the other
operand's tiles itself, staging them through shared memory; the (T, T)
scores live only in registers and shared memory. Keys at or past `kv_len`
and rows past T are masked inside the kernels, so T = 197 needs no padding
copy. No kernel uses atomics: each output row is written once by the block
that owns it, so results are the same bits from run to run.

q, k and v are (B, T, H, D) with a contiguous D axis and any strides over
(B, T, H) — the model passes the three slices of its fused QKV output
without a copy; they must share one set of strides. dO must be
contiguous; o, dq, dk and dv come out contiguous (B, T, H, D); lse and
delta are contiguous (B, H, T) fp32.

Head dims: every kernel takes any D from 1 to `MAX_HEAD_DIM` = 256. The
kernels are instantiated for the padded widths 16, 32, 64, 128 and 256
(csrc/flash_common.cuh `padded_dim`) and run a smaller D on the next one
up, with the padding columns zero in shared memory and never written out
(the bf16 forward, dQ and dK/dV pad to 64, 128 or 256, their swizzle atom
being 64 columns). The bf16 tensor maps need 16-byte aligned rows: base
addresses on 16 bytes and the (B, T, H) strides multiples of 8 elements,
increasing from H to B. Where q, k or v breaks that (a head dim that is
not a multiple of 8, a permuted view), the bf16 wrappers make one
contiguous copy of the three, its rows padded to a multiple of 8
elements, and launch on that; dO, which has a tensor map of its own, is
copied alone when it breaks it (`_tma_inputs`). The bf16 ring block
fold, dQ and dK/dV copy, once, each of q, k, v and dO (the fold has no
dO) whose rows a tensor map cannot read in place (`_block_tma_inputs`:
a head dim that is not a multiple of 8, a base off 16 bytes); the fp32
state and accumulators are never copied. Nothing else copies.
The grid puts (b*h, row tile) on one axis, so B*H has no limit of its own.

Each wrapper checks device, dtype (float32 or bfloat16, one for all
operands), shape, head dim and layout, raises on anything else, returns
the kernel's CUDA error as an exception, and never falls back to the plain
version. A kernel that stalls on one of its barriers traps after a few
seconds instead of hanging the card: the next synchronisation raises it
as a RuntimeError. `FWD_LAUNCHES`, `DQ_LAUNCHES`,
`DKV_LAUNCHES` and the block kernels' `BLOCK_FWD_LAUNCHES`,
`BLOCK_DQ_LAUNCHES` and `BLOCK_DKV_LAUNCHES` count launches; nothing else
touches them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from distributed_vgg_f_tpu_torch.kernels import build

#: Kernel launches since the last reset — the receipt that a run went
#: through each kernel. Incremented only where the kernel is launched.
FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
BLOCK_FWD_LAUNCHES = 0
BLOCK_DQ_LAUNCHES = 0
BLOCK_DKV_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels take every head dim from 1 to this
MAX_HEAD_DIM = 256
#: what the kernels return besides CUDA's own errors
_KERNEL_ERRORS = {
    -1: "the CUDA driver has no tensor map encoder or refused the layout",
    -2: "the kernel did not compile to the 168 registers a thread that its "
        "setmaxnreg budget needs"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SHAPE = [_I, _I, _I, _I, _L, _L, _L, _I, _I, ctypes.c_float, _I, _I, _P]
_FWD_ARGS = [_P, _P, _P, _P, _P] + _SHAPE
# the pointers, then dO's (B, T, H) strides, then the shape
_DQ_ARGS = [_P] * 7 + [_L, _L, _L] + _SHAPE
_DKV_ARGS = [_P] * 8 + [_L, _L, _L] + _SHAPE
# BH, Tq, Tk, D, q_off, k_off, causal, kv_len, scale, dtype, device, stream
_BLOCK = [_I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]
_BLOCK_FWD_ARGS = [_P] * 6 + _BLOCK
_BLOCK_DQ_ARGS = [_P] * 7 + _BLOCK
_BLOCK_DKV_ARGS = [_P] * 8 + _BLOCK


def _raise_launch(what: str, rc: int):
    raise RuntimeError(f"{what} kernel launch failed: "
                       + _KERNEL_ERRORS.get(rc, f"CUDA error {rc}"))


def _check_head_dim(d: int) -> None:
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside the flash kernels' rule "
                         f"1 <= D <= {MAX_HEAD_DIM}")


def _tma_ready(x: torch.Tensor) -> bool:
    """Whether a tensor map can read x ((B, T, H, D), or a block's
    (B*H, T, D)) in place: base on 16 bytes and the strides of every axis
    but the last multiples of 8 elements, increasing from the innermost
    to the outermost."""
    outer = x.stride()[:-1]
    return (x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in outer)
            and list(outer) == sorted(outer, reverse=True))


def _tma_copy(x: torch.Tensor) -> torch.Tensor:
    """x copied into a contiguous buffer whose rows are padded to a
    multiple of 8 elements, as a view of x's shape into it (the padding
    is never read)."""
    d = x.shape[-1]
    buf = torch.empty((*x.shape[:-1], -(-d // 8) * 8), dtype=x.dtype,
                      device=x.device)
    view = buf[..., :d]
    view.copy_(x)
    return view


def _tma_inputs(q, k, v, do=None):
    """q, k, v and dO (or None) as the bf16 kernels' tensor maps read them:
    q, k and v share one set of strides, so when any of them is not
    `_tma_ready` all three are copied (`_tma_copy`); dO has its own map
    and is copied alone when it is not."""
    if not all(map(_tma_ready, (q, k, v))):
        q, k, v = _tma_copy(q), _tma_copy(k), _tma_copy(v)
    if do is not None and not _tma_ready(do):
        do = _tma_copy(do)
    return q, k, v, do


def _entry(name: str, argtypes):
    fn = getattr(build.load(name), f"dvggf_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: int) -> int:
    """Raise on q, k, v the kernels do not take; returns kv_len."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"the flash kernels take CUDA tensors, got "
                             f"{name} on {x.device}")
        if x.dtype not in _DTYPES:
            raise TypeError(f"the flash kernels take float32 or bfloat16, "
                            f"got {name} of {x.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k and v must share one (B, T, H, D) shape, "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise ValueError("q, k and v must share one dtype and device")
    b, t, h, d = q.shape
    _check_head_dim(d)
    if min(b, t, h) < 1:
        raise ValueError(f"(B, T, H) = {(b, t, h)} has an empty axis")
    if q.stride(-1) != 1 or k.stride() != q.stride() \
            or v.stride() != q.stride():
        raise ValueError("the flash kernels take q, k and v with a "
                         "contiguous head axis (stride 1) and one set of "
                         f"strides; got {q.stride()} {k.stride()} "
                         f"{v.stride()}")
    kv_len = t if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    return kv_len


def _check_dense(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on "
                         f"{device}, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError(f"the flash kernels take {name} contiguous")


def _check_rows(lse: torch.Tensor, delta: torch.Tensor,
                q: torch.Tensor) -> None:
    b, t, h, _ = q.shape
    _check_dense("lse", lse, (b, h, t), torch.float32, q.device)
    _check_dense("delta", delta, (b, h, t), torch.float32, q.device)


def _shape_args(q: torch.Tensor, causal: bool, kv_len: int) -> list:
    b, t, h, d = q.shape
    sb, st, sh, _ = q.stride()
    return [b, t, h, d, sb, st, sh, int(bool(causal)), kv_len,
            1.0 / math.sqrt(d), _DTYPES[q.dtype], q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream]


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, kv_len: int = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, T, H, D) in q's dtype, lse (B, H, T) fp32) on the current
    stream. Same semantics as ops.flash_attention.attention_fwd. In bf16,
    q, k and v that a tensor map cannot read in place (`_tma_ready`) are
    first copied, once, into row-padded contiguous buffers."""
    global FWD_LAUNCHES
    kv_len = _check_qkv(q, k, v, kv_len)
    if q.dtype == torch.bfloat16:
        q, k, v, _ = _tma_inputs(q, k, v)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _entry("flash_fwd", _FWD_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *_shape_args(q, causal, kv_len))
    if rc != 0:
        _raise_launch("flash forward", rc)
    FWD_LAUNCHES += 1
    return o, lse


def _backward_inputs(q, k, v, do, lse, delta, kv_len):
    """Check the backward kernels' operands; in bf16, copy those a tensor
    map cannot read in place (`_tma_inputs`). Returns (q, k, v, do,
    kv_len)."""
    kv_len = _check_qkv(q, k, v, kv_len)
    _check_dense("dO", do, q.shape, q.dtype, q.device)
    _check_rows(lse, delta, q)
    if q.dtype == torch.bfloat16:
        q, k, v, do = _tma_inputs(q, k, v, do)
    return q, k, v, do, kv_len


def flash_dq_cuda(q, k, v, do, lse, delta, *, causal: bool = False,
                  kv_len: int = None) -> torch.Tensor:
    """dQ (B, T, H, D) in q's dtype on the current stream. Same semantics
    as ops.flash_attention.attention_dq."""
    global DQ_LAUNCHES
    q, k, v, do, kv_len = _backward_inputs(q, k, v, do, lse, delta, kv_len)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _entry("flash_dq", _DQ_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *do.stride()[:3], *_shape_args(q, causal, kv_len))
    if rc != 0:
        _raise_launch("flash dQ", rc)
    DQ_LAUNCHES += 1
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool = False,
                   kv_len: int = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each (B, T, H, D) in q's dtype, on the current stream.
    Same semantics as ops.flash_attention.attention_dkv."""
    global DKV_LAUNCHES
    q, k, v, do, kv_len = _backward_inputs(q, k, v, do, lse, delta, kv_len)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _entry("flash_dkv", _DKV_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *do.stride()[:3], *_shape_args(q, causal, kv_len))
    if rc != 0:
        _raise_launch("flash dK/dV", rc)
    DKV_LAUNCHES += 1
    return dk, dv


# ---------------------------------------------------------- ring block steps
# They replace ops/flash_attention.py:_ring_fwd_kernel, _ring_dq_kernel and
# _ring_dkv_kernel of the JAX package and compute the functions of the plain
# versions in ops/flash_attention.py (`block_update_plain`,
# `block_grads_plain`). q, do: (B*H, Tq, D); k_blk, v_blk: (B*H, Tk, D);
# all contiguous in one dtype. The state (acc, m, l) and the accumulators
# (dq, dk_blk, dv_blk) are contiguous fp32 and are updated in place; lse and
# delta are (B*H, Tq, 1) fp32. Same checks, errors and no fallback as above.

def _check_block(q, k_blk, v_blk, kv_len) -> int:
    """Raise on q, k_blk, v_blk the block kernels do not take; returns
    kv_len."""
    for name, x in (("q", q), ("k_blk", k_blk), ("v_blk", v_blk)):
        if not x.is_cuda:
            raise ValueError(f"the flash block kernels take CUDA tensors, "
                             f"got {name} on {x.device}")
        if x.dtype not in _DTYPES:
            raise TypeError(f"the flash block kernels take float32 or "
                            f"bfloat16, got {name} of {x.dtype}")
        if x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"the flash block kernels take {name} "
                             f"contiguous (B*H, T, D), got "
                             f"{tuple(x.shape)} strides {x.stride()}")
    if k_blk.dtype != q.dtype or v_blk.dtype != q.dtype \
            or k_blk.device != q.device or v_blk.device != q.device:
        raise ValueError("q, k_blk and v_blk must share one dtype and device")
    bh, tq, d = q.shape
    if k_blk.shape != v_blk.shape or k_blk.shape[0] != bh \
            or k_blk.shape[2] != d:
        raise ValueError(f"k_blk and v_blk must be (B*H, Tk, D) beside q "
                         f"{tuple(q.shape)}, got {tuple(k_blk.shape)} "
                         f"{tuple(v_blk.shape)}")
    _check_head_dim(d)
    tk = k_blk.shape[1]
    if min(bh, tq, tk) < 1:
        raise ValueError(f"(B*H, Tq, Tk) = {(bh, tq, tk)} has an empty "
                         "axis")
    kv_len = tk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= tk:
        raise ValueError(f"kv_len {kv_len} outside [1, {tk}]")
    return kv_len


def _block_args(q, k_blk, q_off, k_off, causal, kv_len) -> list:
    bh, tq, d = q.shape
    return [bh, tq, k_blk.shape[1], d, int(q_off), int(k_off),
            int(bool(causal)), kv_len, 1.0 / math.sqrt(d), _DTYPES[q.dtype],
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream]


def _block_tma_inputs(q, k_blk, v_blk, do=None):
    """q, k_blk, v_blk and dO (or None: the fold has none) as the bf16
    block kernels' tensor maps read them: each that is not `_tma_ready` is
    copied alone (`_tma_copy`). The kernels take every row ld = D rounded
    up to 8 elements apart: D itself when a tensor is read in place (its D
    is then a multiple of 8), the copy's padded width otherwise."""
    return tuple(x if x is None or _tma_ready(x) else _tma_copy(x)
                 for x in (q, k_blk, v_blk, do))


def flash_block_fwd_cuda(q, k_blk, v_blk, acc, m, l, *, q_off: int,
                         k_off: int, causal: bool, kv_len: int = None):
    """Fold one K/V block into (acc, m, l) in place on the current stream.
    Same semantics as ops.flash_attention.block_update_plain. In bf16,
    each of q, k_blk and v_blk that a tensor map cannot read in place is
    copied, once (`_block_tma_inputs`); acc, m and l never are."""
    global BLOCK_FWD_LAUNCHES
    kv_len = _check_block(q, k_blk, v_blk, kv_len)
    bh, tq, d = q.shape
    _check_dense("acc", acc, (bh, tq, d), torch.float32, q.device)
    _check_dense("m", m, (bh, tq, 1), torch.float32, q.device)
    _check_dense("l", l, (bh, tq, 1), torch.float32, q.device)
    if q.dtype == torch.bfloat16:
        q, k_blk, v_blk, _ = _block_tma_inputs(q, k_blk, v_blk)
    fn = _entry("flash_block_fwd", _BLOCK_FWD_ARGS)
    rc = fn(q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            *_block_args(q, k_blk, q_off, k_off, causal, kv_len))
    if rc != 0:
        _raise_launch("flash block forward", rc)
    BLOCK_FWD_LAUNCHES += 1
    return acc, m, l


def _check_block_rows(do, lse, delta, q) -> None:
    bh, tq, _ = q.shape
    _check_dense("dO", do, q.shape, q.dtype, q.device)
    _check_dense("lse", lse, (bh, tq, 1), torch.float32, q.device)
    _check_dense("delta", delta, (bh, tq, 1), torch.float32, q.device)


def flash_block_dq_cuda(q, k_blk, v_blk, do, lse, delta, dq, *, q_off: int,
                        k_off: int, causal: bool, kv_len: int = None):
    """dq += this block's contribution, in place on the current stream.
    Same semantics as the dq of ops.flash_attention.block_grads_plain."""
    global BLOCK_DQ_LAUNCHES
    kv_len = _check_block(q, k_blk, v_blk, kv_len)
    _check_block_rows(do, lse, delta, q)
    _check_dense("dq", dq, q.shape, torch.float32, q.device)
    if q.dtype == torch.bfloat16:
        q, k_blk, v_blk, do = _block_tma_inputs(q, k_blk, v_blk, do)
    fn = _entry("flash_block_dq", _BLOCK_DQ_ARGS)
    rc = fn(q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_block_args(q, k_blk, q_off, k_off, causal, kv_len))
    if rc != 0:
        _raise_launch("flash block dQ", rc)
    BLOCK_DQ_LAUNCHES += 1
    return dq


def flash_block_dkv_cuda(q, k_blk, v_blk, do, lse, delta, dk_blk, dv_blk, *,
                         q_off: int, k_off: int, causal: bool,
                         kv_len: int = None):
    """dk_blk, dv_blk += this rank's contribution to the visiting block,
    in place on the current stream. Same semantics as the dk and dv of
    ops.flash_attention.block_grads_plain."""
    global BLOCK_DKV_LAUNCHES
    kv_len = _check_block(q, k_blk, v_blk, kv_len)
    _check_block_rows(do, lse, delta, q)
    _check_dense("dk_blk", dk_blk, k_blk.shape, torch.float32, q.device)
    _check_dense("dv_blk", dv_blk, k_blk.shape, torch.float32, q.device)
    if q.dtype == torch.bfloat16:
        q, k_blk, v_blk, do = _block_tma_inputs(q, k_blk, v_blk, do)
    fn = _entry("flash_block_dkv", _BLOCK_DKV_ARGS)
    rc = fn(q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk_blk.data_ptr(),
            dv_blk.data_ptr(),
            *_block_args(q, k_blk, q_off, k_off, causal, kv_len))
    if rc != 0:
        _raise_launch("flash block dK/dV", rc)
    BLOCK_DKV_LAUNCHES += 1
    return dk_blk, dv_blk

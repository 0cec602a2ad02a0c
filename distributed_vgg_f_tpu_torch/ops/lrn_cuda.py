"""LRN forward and backward as hand-written Hopper kernels (csrc/lrn_fwd.cu,
csrc/lrn_bwd.cu).

**Forward** (`local_response_norm_cuda`). Replaces the JAX package's
Pallas TPU kernel ``ops/lrn_pallas.py:_fwd_kernel`` (launched by
``_rowwise_call``). It computes the same function as the plain version in
ops/lrn.py: for each
element of NHWC rows of C contiguous channels, the fp32 window sum of
squares over c-r..c+r clipped to [0, C), d = bias + a*S, d**-beta
(rsqrt(d)*sqrt(rsqrt(d)) for beta=0.75, rsqrt(d) for 0.5, powf
otherwise), and the output x*d**-beta stored in the input's dtype.

Bound: device-memory bytes. The kernel reads x once and writes y once
(2 bytes an element each way in bf16) and does ~15 fp32 operations an
element, far below the card's ratio of operations to bytes. The design
keeps each element to one read from device memory: a block stages a
contiguous span of 2048 elements plus an r-element halo on each side in
shared memory as fp32, and every thread forms its window sums from there.
The window of an element never leaves its own row, and a row is
contiguous, so a flat span with a halo covers every window whatever C is.
The TPU kernel's pixel packing and band matmul (lane filling for the MXU)
have no counterpart here. Vectorised 16-byte loads are later work.

**Backward** (`local_response_norm_bwd_cuda`). Replaces
``ops/lrn_pallas.py:_bwd_kernel`` (launched by ``_lrn2d_bwd``). From x
alone (the forward's only residual) and g = dL/dy it recomputes
d = bias + a*S and writes dx = g*d**-beta - 2*a*beta*x*U, where U is the
clipped window sum of t = g*x*d**-(beta+1), in fp32, stored in x's dtype
(the plain `ops.lrn.local_response_norm_bwd`). Bound: bytes (x and g read,
dx written). A block stages its 2048-element span plus a 2r halo each
side of x, forms t over the span plus r each side, then each window sum
of t, all in shared memory.

Each wrapper checks device, dtype (float32 or bfloat16), NHWC contiguity,
C >= 1 (and for the backward: g of x's shape, dtype and device), raises
on anything else, returns the kernel's CUDA error as an exception, and
never falls back to the plain version. `LAUNCHES` (forward) and
`BWD_LAUNCHES` (backward) count launches; nothing else touches them.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_vgg_f_tpu_torch.kernels import build

#: Kernel launches since the last reset — the receipt that a run went
#: through the kernel. Incremented only where the kernel is launched.
LAUNCHES = 0
#: Backward kernel launches since the last reset, counted the same way.
BWD_LAUNCHES = 0

#: Elements one block owns (must equal kTile in csrc/lrn_fwd.cu and
#: csrc/lrn_bwd.cu).
_TILE = 2048
#: Static shared memory a block may use without an opt-in (bytes).
_SMEM_LIMIT = 48 * 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry(name: str, argtypes):
    fn = getattr(build.load(name), f"dvggf_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_FWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, what: str, halo: int, depth_radius: int):
    """Raise on what the kernels do not take; `halo` is the shared memory
    a block needs, in fp32 values, beyond its span."""
    if not x.is_cuda:
        raise ValueError(f"the LRN kernel takes a CUDA tensor, got {what} on "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the LRN kernel takes float32 or bfloat16, got "
                        f"{what} of {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"LRN needs a channel axis of size >= 1, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"the LRN kernel takes {what} contiguous in NHWC "
                         "order (channels last, innermost)")
    if depth_radius < 0 or halo * 4 > _SMEM_LIMIT:
        raise ValueError(f"depth_radius {depth_radius} outside the kernel's "
                         "shared-memory range")


def local_response_norm_cuda(x: torch.Tensor,
                             depth_radius: int = 2,
                             bias: float = 2.0,
                             alpha: float = 1e-4,
                             beta: float = 0.75,
                             *,
                             alpha_scaled: bool = False) -> torch.Tensor:
    """LRN over the last axis of a contiguous CUDA tensor (NHWC), on the
    current stream. Same semantics as ops.lrn.local_response_norm."""
    global LAUNCHES
    _check(x, "x", _TILE + 2 * depth_radius, depth_radius)
    n = 2 * depth_radius + 1
    a = alpha / n if alpha_scaled else alpha
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _entry("lrn_fwd", _FWD_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1],
            depth_radius, float(bias), float(a), float(beta),
            _DTYPES[x.dtype], x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"LRN kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return y


def local_response_norm_bwd_cuda(x: torch.Tensor, g: torch.Tensor,
                                 depth_radius: int = 2,
                                 bias: float = 2.0,
                                 alpha: float = 1e-4,
                                 beta: float = 0.75,
                                 *,
                                 alpha_scaled: bool = False) -> torch.Tensor:
    """dL/dx of LRN over the last axis from x and g = dL/dy (contiguous
    CUDA tensors of one shape, dtype and device, NHWC), on the current
    stream. Same semantics as ops.lrn.local_response_norm_bwd."""
    global BWD_LAUNCHES
    _check(x, "x", 3 * _TILE + 6 * depth_radius, depth_radius)
    _check(g, "g", 3 * _TILE + 6 * depth_radius, depth_radius)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"g must match x in shape, dtype and device: x {tuple(x.shape)} "
            f"{x.dtype} {x.device}, g {tuple(g.shape)} {g.dtype} {g.device}")
    n = 2 * depth_radius + 1
    a = alpha / n if alpha_scaled else alpha
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    fn = _entry("lrn_bwd", _BWD_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), x.numel(),
            x.shape[-1], depth_radius, float(bias), float(a), float(beta),
            float(2.0 * a * beta), _DTYPES[x.dtype], x.device.index, stream)
    if rc != 0:
        raise RuntimeError(
            f"LRN backward kernel launch failed with CUDA error {rc}")
    BWD_LAUNCHES += 1
    return dx

"""LRN forward as a hand-written Hopper kernel (csrc/lrn_fwd.cu).

Replaces the JAX package's Pallas TPU kernel
``ops/lrn_pallas.py:_fwd_kernel`` (launched by ``_rowwise_call``). It
computes the same function as the plain version in ops/lrn.py: for each
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

The wrapper checks device, dtype (float32 or bfloat16), NHWC contiguity
and C >= 1, raises on anything else, and never falls back to the plain
version. `LAUNCHES` counts launches; nothing else touches it.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_vgg_f_tpu_torch.kernels import build

#: Kernel launches since the last reset — the receipt that a run went
#: through the kernel. Incremented only where the kernel is launched.
LAUNCHES = 0

#: Elements one block stages (must equal kTile in csrc/lrn_fwd.cu).
_TILE = 2048
#: Static shared memory a block may use without an opt-in (bytes).
_SMEM_LIMIT = 48 * 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    lib = build.load("lrn_fwd")
    fn = lib.dvggf_lrn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    if not x.is_cuda:
        raise ValueError(f"the LRN kernel takes a CUDA tensor, got one on "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the LRN kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"LRN needs a channel axis of size >= 1, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the LRN kernel takes a tensor contiguous in NHWC "
                         "order (channels last, innermost)")
    if depth_radius < 0 or (_TILE + 2 * depth_radius) * 4 > _SMEM_LIMIT:
        raise ValueError(f"depth_radius {depth_radius} outside the kernel's "
                         f"range [0, {(_SMEM_LIMIT // 4 - _TILE) // 2}]")
    n = 2 * depth_radius + 1
    a = alpha / n if alpha_scaled else alpha
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1],
            depth_radius, float(bias), float(a), float(beta),
            _DTYPES[x.dtype], x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"LRN kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return y

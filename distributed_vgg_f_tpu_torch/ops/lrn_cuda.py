"""LRN forward and backward as hand-written Hopper kernels (csrc/lrn_fwd.cu,
csrc/lrn_bwd.cu, csrc/lrn_common.cuh), each with the preceding ReLU fused
on request.

**Forward** (`local_response_norm_cuda`). Replaces the JAX package's
Pallas TPU kernel ``ops/lrn_pallas.py:_fwd_kernel`` (launched by
``_rowwise_call``). It computes the same function as the plain version in
ops/lrn.py: for each element of NHWC rows of C contiguous channels, the
fp32 window sum of squares over c-r..c+r clipped to [0, C),
d = bias + a*S, d**-beta (rsqrt(d)*sqrt(rsqrt(d)) for beta=0.75, rsqrt(d)
for 0.5, powf otherwise), and the output x*d**-beta stored in the input's
dtype. With ``relu=True`` it reads z and normalizes max(z, 0): the plain
``local_response_norm(F.relu(z))``.

**Backward** (`local_response_norm_bwd_cuda`). Replaces
``ops/lrn_pallas.py:_bwd_kernel`` (launched by ``_lrn2d_bwd``). From x
alone (the forward's only residual) and g = dL/dy it recomputes
d = bias + a*S and writes dx = g*d**-beta - 2*a*beta*x*U, where U is the
clipped window sum of t = g*x*d**-(beta+1), in fp32, stored in x's dtype
(the plain `ops.lrn.local_response_norm_bwd`). With ``relu=True`` it takes
z, recomputes x = max(z, 0), and writes dz = dx (rounded) where z > 0 and
0 elsewhere: the ReLU's backward fused.

Bound: device-memory bytes, both. The forward reads x and writes y
(2 bytes an element each way in bf16) against ~15 fp32 operations an
element; the backward reads x and g and writes dx against ~30. The fused
ReLU removes a whole read-and-write pass before the forward and the
threshold_backward pass after the backward. Each kernel has two variants,
chosen by `variant` from the shape, dtype and radius alone (never after a
failed build or launch):

- **vector**: a row of C channels lives in the registers of a group of
  L = C/8 lanes of one warp (L a power of two <= 32), 8 contiguous
  channels a lane as whole 16-byte vectors (one of bf16, two of fp32),
  radius <= 4. A window's neighbours come from the adjacent lanes by warp
  shuffles, so there is no shared memory, no barrier and no channel
  modulo; a grid-stride walk loads a group's next row while it works on
  this one. VGG-F's two sites (C = 64 and 256, radius 2) take it.
- **general**: any C >= 1 and any radius whose span fits in shared
  memory. A block stages a contiguous span of 2048 elements plus a halo
  (r each side for the forward, 2r for the backward) in shared memory as
  fp32 and forms every window from there.

Each wrapper checks device, dtype (float32 or bfloat16), NHWC contiguity,
C >= 1 (and for the backward: g of x's shape, dtype and device), raises
on anything else, returns the kernel's CUDA error as an exception, and
never falls back to the plain version. A tensor that the vector variant
takes but that starts off a 16-byte boundary (a view at an odd offset) is
copied once first. `LAUNCHES` (forward) and `BWD_LAUNCHES` (backward)
count every launch; `VEC_LAUNCHES` and `VEC_BWD_LAUNCHES` count those of
the vector variant among them. Nothing else touches them.
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
#: The vector variant's share of LAUNCHES.
VEC_LAUNCHES = 0
#: The vector variant's share of BWD_LAUNCHES.
VEC_BWD_LAUNCHES = 0

#: Elements one block of the general variant owns (must equal kTile in
#: csrc/lrn_fwd.cu and csrc/lrn_bwd.cu).
_TILE = 2048
#: Static shared memory a block may use without an opt-in (bytes).
_SMEM_LIMIT = 48 * 1024
#: Elements a lane of the vector variant holds (kLaneElems in
#: csrc/lrn_common.cuh): one 16-byte vector of bf16, two of fp32.
_LANE_ELEMS = 8
#: Largest radius the vector variant is instantiated for (kMaxVecRadius).
_VEC_MAX_RADIUS = 4

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def variant(shape, dtype: torch.dtype, depth_radius: int) -> str:
    """Which kernel variant a tensor of `shape` and `dtype` takes at
    `depth_radius`: "vector" when C/8 lanes is a power of two <= 32 and
    the radius is at most 4 (float32 or bfloat16), else "general". A pure
    function of its arguments; the forward and the backward choose
    alike."""
    c = shape[-1] if len(shape) else 0
    lanes = c // _LANE_ELEMS
    vector = (dtype in _DTYPES and 0 <= depth_radius <= _VEC_MAX_RADIUS
              and c % _LANE_ELEMS == 0 and 1 <= lanes <= 32
              and lanes & (lanes - 1) == 0)
    return "vector" if vector else "general"


def _entry(name: str, argtypes):
    fn = getattr(build.load(name), f"dvggf_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_FWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, what: str, depth_radius: int):
    """Raise on what the kernels do not take."""
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
    if depth_radius < 0:
        raise ValueError(f"depth_radius must be >= 0, got {depth_radius}")


def _vector(x: torch.Tensor, depth_radius: int, halo: int) -> bool:
    """Whether x takes the vector variant; the general variant's block
    needs `halo` fp32 values of shared memory beyond its span."""
    vector = variant(x.shape, x.dtype, depth_radius) == "vector"
    if not vector and (_TILE + halo) * 4 > _SMEM_LIMIT:
        raise ValueError(f"depth_radius {depth_radius} outside the kernel's "
                         "shared-memory range")
    return vector


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when it starts off a 16-byte boundary (the
    vector variant loads whole 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def local_response_norm_cuda(x: torch.Tensor,
                             depth_radius: int = 2,
                             bias: float = 2.0,
                             alpha: float = 1e-4,
                             beta: float = 0.75,
                             *,
                             alpha_scaled: bool = False,
                             relu: bool = False) -> torch.Tensor:
    """LRN over the last axis of a contiguous CUDA tensor (NHWC), on the
    current stream. Same semantics as ops.lrn.local_response_norm; with
    `relu`, as local_response_norm(F.relu(x))."""
    global LAUNCHES, VEC_LAUNCHES
    _check(x, "x", depth_radius)
    vector = _vector(x, depth_radius, 2 * depth_radius)
    n = 2 * depth_radius + 1
    a = alpha / n if alpha_scaled else alpha
    if vector:
        x = _aligned(x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _entry("lrn_fwd", _FWD_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1],
            depth_radius, float(bias), float(a), float(beta), int(relu),
            int(vector), _DTYPES[x.dtype], x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"LRN kernel launch failed with CUDA error {rc}")
    LAUNCHES += 1
    VEC_LAUNCHES += vector
    return y


def local_response_norm_bwd_cuda(x: torch.Tensor, g: torch.Tensor,
                                 depth_radius: int = 2,
                                 bias: float = 2.0,
                                 alpha: float = 1e-4,
                                 beta: float = 0.75,
                                 *,
                                 alpha_scaled: bool = False,
                                 relu: bool = False) -> torch.Tensor:
    """dL/dx of LRN over the last axis from x and g = dL/dy (contiguous
    CUDA tensors of one shape, dtype and device, NHWC), on the current
    stream. Same semantics as ops.lrn.local_response_norm_bwd; with `relu`,
    x is the ReLU's input z and the result is dL/dz, as
    ops.lrn.relu_local_response_norm_bwd."""
    global BWD_LAUNCHES, VEC_BWD_LAUNCHES
    _check(x, "x", depth_radius)
    _check(g, "g", depth_radius)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"g must match x in shape, dtype and device: x {tuple(x.shape)} "
            f"{x.dtype} {x.device}, g {tuple(g.shape)} {g.dtype} {g.device}")
    vector = _vector(x, depth_radius, 2 * _TILE + 6 * depth_radius)
    n = 2 * depth_radius + 1
    a = alpha / n if alpha_scaled else alpha
    if vector:
        x, g = _aligned(x), _aligned(g)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    fn = _entry("lrn_bwd", _BWD_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), x.numel(),
            x.shape[-1], depth_radius, float(bias), float(a), float(beta),
            float(2.0 * a * beta), int(relu), int(vector), _DTYPES[x.dtype],
            x.device.index, stream)
    if rc != 0:
        raise RuntimeError(
            f"LRN backward kernel launch failed with CUDA error {rc}")
    BWD_LAUNCHES += 1
    VEC_BWD_LAUNCHES += vector
    return dx

"""Local Response Normalization across channels (VGG-F applies it after
conv1 and conv2).

`local_response_norm` is the plain PyTorch version: NHWC (the channel
window runs over the last axis), the TF alpha convention (``a = alpha``,
or ``alpha / n`` with ``alpha_scaled``), fp32 math, output in the input
dtype. It is the counterpart of the JAX package's oracle
(``ops/lrn.py local_response_norm``) and the reference the Hopper kernel
(ops/lrn_cuda.py) is held against.

`local_response_norm_bwd` is the plain closed-form backward, the
counterpart of the Pallas ``_bwd_kernel`` (``ops/lrn_pallas.py:74``) and
the reference the backward kernel is held against: d is recomputed from
x, then dx = g*d**-beta - 2*a*beta*x*sum_window(g*x*d**-(beta+1)).

`lrn` is what the model calls. It goes through `LRNFunction`, the
counterpart of the JAX package's custom VJP ``_lrn2d``: the forward
saves only x, and the backward recomputes from it. Forward and backward
each launch the Hopper kernel (ops/lrn_cuda.py) for a CUDA tensor and run
the plain version for a CPU tensor. The plain versions compute in fp32
(fp64 for an fp64 input, so `torch.autograd.gradcheck` can hold them to
their own math) and return the input's dtype. `F.local_response_norm` is
not used: it divides alpha by n, and on the CPU it refuses bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from distributed_vgg_f_tpu_torch.ops import lrn_cuda


def _pow_neg_beta(d: torch.Tensor, beta: float) -> torch.Tensor:
    """d ** -beta, with the sqrt/rsqrt form for the canonical beta=0.75
    (and rsqrt for 0.5), as the kernel computes it."""
    if beta == 0.75:
        inv = torch.rsqrt(d)          # d^-1/2
        return inv * torch.sqrt(inv)  # d^-3/4
    if beta == 0.5:
        return torch.rsqrt(d)
    return d ** -beta


def _upcast(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or in its own dtype when that is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _window_sum(v: torch.Tensor, depth_radius: int) -> torch.Tensor:
    """sum_{j=c-r..c+r, 0<=j<C} v[..., j]: 2r+1 shifted slices of the
    zero-padded last axis, added in window order."""
    c = v.shape[-1]
    padded = F.pad(v, (depth_radius, depth_radius))
    out = padded[..., 0:c]
    for k in range(1, 2 * depth_radius + 1):
        out = out + padded[..., k:k + c]
    return out


def local_response_norm(x: torch.Tensor,
                        depth_radius: int = 2,
                        bias: float = 2.0,
                        alpha: float = 1e-4,
                        beta: float = 0.75,
                        *,
                        alpha_scaled: bool = False) -> torch.Tensor:
    """LRN over the last axis:

    out[c] = x[c] * (bias + a * sum_{j=c-r..c+r, 0<=j<C} x[j]^2) ** -beta

    with a = alpha/n when `alpha_scaled` else alpha, n = 2r+1. The window
    sum adds 2r+1 shifted slices of the zero-padded squares in window
    order, in fp32."""
    n = 2 * depth_radius + 1
    a = alpha / n if alpha_scaled else alpha
    xf = _upcast(x)
    sums = _window_sum(xf * xf, depth_radius)
    return (xf * _pow_neg_beta(bias + a * sums, beta)).to(x.dtype)


def local_response_norm_bwd(x: torch.Tensor,
                            g: torch.Tensor,
                            depth_radius: int = 2,
                            bias: float = 2.0,
                            alpha: float = 1e-4,
                            beta: float = 0.75,
                            *,
                            alpha_scaled: bool = False) -> torch.Tensor:
    """dL/dx of `local_response_norm` from x and g = dL/dy, in closed form
    (the math of the Pallas ``_bwd_kernel``):

    d = bias + a*S, p = d**-beta, t = g*x*(p/d),
    dx = g*p - (2*a*beta) * x * sum_{j=c-r..c+r, 0<=j<C} t[j]

    in fp32 (fp64 for fp64 inputs), returned in x's dtype."""
    n = 2 * depth_radius + 1
    a = alpha / n if alpha_scaled else alpha
    xf = _upcast(x)
    gf = g.to(xf.dtype)
    d = bias + a * _window_sum(xf * xf, depth_radius)
    p = _pow_neg_beta(d, beta)
    t = gf * xf * (p / d)
    u = _window_sum(t, depth_radius)
    return (gf * p - (2.0 * a * beta) * xf * u).to(x.dtype)


class LRNFunction(torch.autograd.Function):
    """LRN with its closed-form backward. Saves only x (the TPU custom
    VJP's residual); the backward recomputes the normalizer from it. Each
    direction dispatches on the tensor's device: the Hopper kernels for
    CUDA, the plain versions for the CPU. `a` is the effective alpha
    (already divided by n when the caller asked for that). Like the
    reference's custom VJP it is differentiable once: a second
    derivative raises instead of silently missing the kernel's terms."""

    @staticmethod
    def forward(ctx, x, depth_radius, bias, a, beta):
        ctx.save_for_backward(x)
        ctx.lrn_args = (depth_radius, bias, a, beta)
        if x.is_cuda:
            return lrn_cuda.local_response_norm_cuda(x, depth_radius, bias,
                                                     a, beta)
        return local_response_norm(x, depth_radius, bias, a, beta)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g = g.contiguous()
        if x.is_cuda:
            dx = lrn_cuda.local_response_norm_bwd_cuda(x, g, *ctx.lrn_args)
        else:
            dx = local_response_norm_bwd(x, g, *ctx.lrn_args)
        return dx, None, None, None, None


def lrn(x: torch.Tensor,
        depth_radius: int = 2,
        bias: float = 2.0,
        alpha: float = 1e-4,
        beta: float = 0.75,
        *,
        alpha_scaled: bool = False) -> torch.Tensor:
    """Differentiable LRN over the last axis — what models call, through
    `LRNFunction`. A CUDA tensor launches the Hopper kernels (which raise
    on what they do not take), forward and backward; a CPU tensor runs
    the plain versions."""
    n = 2 * depth_radius + 1
    a = alpha / n if alpha_scaled else alpha
    return LRNFunction.apply(x, depth_radius, float(bias), float(a),
                             float(beta))

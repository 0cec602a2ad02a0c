"""Local Response Normalization across channels (VGG-F applies it after
conv1 and conv2).

`local_response_norm` is the plain PyTorch version: NHWC (the channel
window runs over the last axis), the TF alpha convention (``a = alpha``,
or ``alpha / n`` with ``alpha_scaled``), fp32 math, output in the input
dtype. It is the counterpart of the JAX package's oracle
(``ops/lrn.py local_response_norm``) and the reference the Hopper kernel
(ops/lrn_cuda.py) is held against.

`lrn` is what the model calls: a CUDA tensor goes to the kernel, a CPU
tensor to the plain version. `F.local_response_norm` is not used: it
divides alpha by n, and on the CPU it refuses bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    c = x.shape[-1]
    xf = x.float()
    sq = F.pad(xf * xf, (depth_radius, depth_radius))
    sums = sq[..., 0:c]
    for k in range(1, n):
        sums = sums + sq[..., k:k + c]
    return (xf * _pow_neg_beta(bias + a * sums, beta)).to(x.dtype)


def lrn(x: torch.Tensor,
        depth_radius: int = 2,
        bias: float = 2.0,
        alpha: float = 1e-4,
        beta: float = 0.75,
        *,
        alpha_scaled: bool = False) -> torch.Tensor:
    """Dispatching LRN over the last axis — what models call. A CUDA tensor
    launches the Hopper kernel (which raises on what it does not take); a
    CPU tensor runs the plain version."""
    if x.is_cuda:
        return lrn_cuda.local_response_norm_cuda(
            x, depth_radius, bias, alpha, beta, alpha_scaled=alpha_scaled)
    return local_response_norm(x, depth_radius, bias, alpha, beta,
                               alpha_scaled=alpha_scaled)

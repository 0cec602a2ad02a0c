"""3x3/2 ceil-mode (Caffe-semantics) max pooling.

Right/bottom padding with -inf up to the ceil-mode output size (at least
one output for tiny maps), then a VALID `F.max_pool2d`. At 224 px this
sizing gives VGG-F's 6x6x256 conv5 output and 9216-wide fc6.
`F.max_pool2d(ceil_mode=True)` is not used: it raises on a 1x1 map, which
the 32 px configurations reach at pool5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_WINDOW = 3
_STRIDE = 2


def _ceil_pad(n: int) -> int:
    """Right/bottom padding of one spatial dim for the ceil-mode size."""
    out = max(1, -(-(n - _WINDOW) // _STRIDE) + 1)
    return max(0, (out - 1) * _STRIDE + _WINDOW - n)


def maxpool_3x3s2_ceil_nchw(x: torch.Tensor) -> torch.Tensor:
    """The pool on an (N, C, H, W) tensor (any memory format)."""
    ph, pw = _ceil_pad(x.shape[2]), _ceil_pad(x.shape[3])
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, _WINDOW, _STRIDE)


def maxpool_3x3s2_ceil(x: torch.Tensor) -> torch.Tensor:
    """The pool on an NHWC tensor — the JAX package's public layout."""
    return maxpool_3x3s2_ceil_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

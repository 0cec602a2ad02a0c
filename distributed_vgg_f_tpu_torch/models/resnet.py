"""ResNet-50 (He et al. 2015, v1.5) with cross-replica sync-BatchNorm: the
counterpart of the JAX package's `models/resnet.py` (`StemConv`,
`BottleneckBlock`, `ResNet`, `ResNet50`).

    conv_init 7x7/2 (pad 3) -> bn_init -> ReLU -> max-pool 3x3/2 (pad 1,
    -inf) -> stages of bottlenecks (3, 4, 6, 3) at widths 64 * 2^s, the
    stride on the 3x3 conv of each later stage's first block -> spatial
    mean -> head

Each bottleneck is conv1 1x1 -> bn1 -> ReLU -> conv2 3x3 -> bn2 -> ReLU
-> conv3 1x1 (4x wide) -> bn3, plus the residual (conv_proj 1x1 ->
bn_proj wherever the shapes differ, stage 1's first block among them),
then ReLU. `bn3` starts with a zero scale (weights.init_params). The
convs have no bias; their SAME padding is Flax's (at stride 2 on an even
map, one row and column after, none before).

BatchNorm is ops/batch_norm.py's (Flax's semantics); with `bn_axis_name`
"data" (JAX's default) its training statistics are averaged over the
data-parallel process group, None keeps them per rank. In eval every BN
reads its running statistics.

`stem="space_to_depth"` computes the stem as JAX's does: the input
relaid 2x2 into (H/2, W/2, 12) and the kernel zero-padded to 8x8 and
rearranged to 4x4x12 at stride 1, padding (2, 1); the same function as
the 7x7/2 conv, and the plain conv when H or W is odd or below 8. The
parameter stays (7, 7, 3, 64) in Flax's layout either way.

Conventions are VGG-F's (models/vggf.py): NHWC input, NCHW activations
in `torch.channels_last` memory, bf16 compute with fp32 parameters,
fp32 logits; no kernel of the port's own runs here (cuDNN's convs,
cuBLAS's head, PyTorch's BatchNorm arithmetic).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_vgg_f_tpu_torch.models.ingest import reject_raw_uint8
from distributed_vgg_f_tpu_torch.ops.batch_norm import BatchNorm

STEMS = ("conv7", "space_to_depth")


class _Conv(nn.Module):
    """A bias-free conv's OIHW weight, uninitialized until weights.py
    loads it."""

    def __init__(self, cout: int, cin: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))


class _Dense(nn.Module):
    def __init__(self, cout: int, cin: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))


def _same_pad(size: int, k: int, stride: int):
    """Flax's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """A bias-free conv with Flax's SAME padding (asymmetric where Flax's
    is)."""
    k = weight.shape[-1]
    (t, b), (l, r) = (_same_pad(x.shape[2], k, stride),
                      _same_pad(x.shape[3], k, stride))
    if t == b and l == r:
        return F.conv2d(x, weight, None, stride, (t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), weight, None, stride)


class StemConv(nn.Module):
    def __init__(self, features: int = 64, stem: str = "conv7"):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown resnet stem {stem!r}; expected "
                             "'conv7' or 'space_to_depth'")
        self.stem = stem
        self.weight = nn.Parameter(torch.empty(features, 3, 7, 7))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, 3, H, W) -> (B, F, ceil(H/2), ceil(W/2)) in `dtype`."""
        w = self.weight.to(dtype)
        b, _, h, wd = x.shape
        if (self.stem == "space_to_depth" and h % 2 == 0 and wd % 2 == 0
                and min(h, wd) >= 8):
            f = w.shape[0]
            # (B, 3, H, W) -> (B, H/2, W/2, 2, 2, 3) -> (B, 12, H/2, W/2),
            # channels in (dy, dx, c) order as JAX's NHWC reshape gives
            xs = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, wd // 2, 2, 3)
            xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, wd // 2, 12)
            xs = xs.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            k = F.pad(w.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))
            k = k.reshape(4, 2, 4, 2, 3, f).permute(0, 2, 1, 3, 4, 5)
            k = k.reshape(4, 4, 12, f).permute(3, 2, 0, 1)
            return F.conv2d(F.pad(xs, (2, 1, 2, 1)), k.contiguous(), None, 1)
        return F.conv2d(x, w, None, 2, 3)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, features: int, strides: int = 1,
                 bn_axis_name: Optional[str] = "data"):
        super().__init__()
        out = 4 * features
        self.strides = int(strides)
        self.conv1 = _Conv(features, cin, 1)
        self.bn1 = BatchNorm(features, axis_name=bn_axis_name)
        self.conv2 = _Conv(features, features, 3)
        self.bn2 = BatchNorm(features, axis_name=bn_axis_name)
        self.conv3 = _Conv(out, features, 1)
        self.bn3 = BatchNorm(out, axis_name=bn_axis_name)
        # JAX projects where the residual's shape differs from the
        # branch's: a change of width or of stride
        self.project = cin != out or self.strides != 1
        if self.project:
            self.conv_proj = _Conv(out, cin, 1)
            self.bn_proj = BatchNorm(out, axis_name=bn_axis_name)

    def forward(self, x: torch.Tensor, *, train: bool,
                dtype: torch.dtype) -> torch.Tensor:
        y = F.relu(self.bn1(conv_same(x, self.conv1.weight.to(dtype)),
                            train=train))
        y = F.relu(self.bn2(conv_same(y, self.conv2.weight.to(dtype),
                                      self.strides), train=train))
        y = self.bn3(conv_same(y, self.conv3.weight.to(dtype)), train=train)
        residual = x
        if self.project:
            residual = self.bn_proj(conv_same(
                x, self.conv_proj.weight.to(dtype), self.strides),
                train=train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, num_classes: int = 1000, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 bn_axis_name: Optional[str] = "data",
                 stem: str = "conv7"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv_init = StemConv(64, stem)
        self.bn_init = BatchNorm(64, axis_name=bn_axis_name)
        self.blocks = []
        cin = 64
        for stage, num_blocks in enumerate(stage_sizes):
            for block in range(num_blocks):
                name = f"stage{stage + 1}_block{block + 1}"
                features = 64 * 2 ** stage
                self.add_module(name, BottleneckBlock(
                    cin, features, 2 if stage > 0 and block == 0 else 1,
                    bn_axis_name))
                self.blocks.append(name)
                cin = 4 * features
        self.head = _Dense(num_classes, cin)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """NHWC images (finished, not raw u8) -> fp32 logits. `train=True`
        normalizes with the batch's statistics (over the data-parallel
        group with sync-BN) and moves the running ones; the model has no
        dropout, so `generator` is not read."""
        reject_raw_uint8(x, "ResNet")
        cd = self.compute_dtype
        x = x.to(cd).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x, cd), train=train))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x, train=train, dtype=cd)
        x = x.to(torch.promote_types(cd, torch.float32)).mean((2, 3)).to(cd)
        head = self.head
        return (F.linear(x, head.weight.to(cd)) + head.bias.to(cd)).float()


def ResNet50(num_classes: int = 1000, **kwargs) -> ResNet:
    kwargs.setdefault("stage_sizes", (3, 4, 6, 3))
    return ResNet(num_classes, **kwargs)

"""VGG-F (CNN-F, Chatfield et al. 2014) — the flagship model.

    conv1 64@11x11/4 (VALID) → ReLU → LRN → maxpool 3x3/2
    conv2 256@5x5/1 (SAME)   → ReLU → LRN → maxpool 3x3/2
    conv3 256@3x3/1 (SAME)   → ReLU
    conv4 256@3x3/1 (SAME)   → ReLU
    conv5 256@3x3/1 (SAME)   → ReLU → maxpool 3x3/2
    flatten (NHWC order) → fc6 4096 → ReLU → dropout → fc7 4096 → ReLU
    → dropout → fc8

The counterpart of the JAX package's `models/vggf.py VGGF`. As there,
`train=True` applies dropout after the fc6 and fc7 ReLUs and
`train=False` (the default) does not. Dropout has `nn.Dropout`'s
semantics — keep with probability 1-p, scale kept values by 1/(1-p) —
with its bits drawn from the `torch.Generator` the caller passes, so the
train step can replay a step's mask from (seed, step).

The public layout is the JAX one: the input is NHWC, plain (S, S, 3) or
4x4-packed (S/4, S/4, 48) in (dy, dx, c) channel order. The stem is the
JAX package's `Conv1SpaceToDepth` (`models/vggf.py:35–78`): a packed
input, or a plain one whose H and W are multiples of 4 and at least 12
(packed here), is convolved VALID at stride 1 with the 11x11 kernel
padded to 12x12 and rearranged to 3x3 over the 48 packed channels
(`pack_stem_weight`): the same function as the 11x11/4 conv, with a
16x deeper contraction and no 3-channel input for cuDNN to pad. Other
sizes take the plain 11x11/4 conv, as JAX's. The parameter stays the
11x11 weight, so checkpoints and the weight bridge do not change. Inside,
activations are NCHW tensors in `torch.channels_last` memory, so cuDNN
runs NHWC and the LRN kernel sees contiguous rows of C channels.

Casts mirror the JAX model: the input is cast to the compute dtype, conv
and dense biases are added in the compute dtype after the product, LRN
computes in fp32 and returns the compute dtype, and the logits are fp32.
The ReLU in front of each LRN is fused into it (ops/lrn.py relu_lrn): the
same function, one kernel each way instead of two passes.
Flattening before fc6 in NHWC order makes fc6 a plain transpose of the
Flax kernel (weights.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_vgg_f_tpu_torch.data.device_ingest import \
    space_to_depth_batch
from distributed_vgg_f_tpu_torch.models.ingest import reject_raw_uint8
from distributed_vgg_f_tpu_torch.ops.lrn import relu_lrn
from distributed_vgg_f_tpu_torch.ops.pooling import (_ceil_pad,
                                                     maxpool_3x3s2_ceil_nchw)


class _Layer(nn.Module):
    """Parameter holder of one conv (OIHW weight) or dense ((out, in)
    weight) layer. Values come from weights.py; construction leaves them
    uninitialized."""

    def __init__(self, weight_shape, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(features))


def depth_to_space(x: torch.Tensor, block: int = 4) -> torch.Tensor:
    """(B, H, W, b*b*C) in (dy, dx, c) channel order -> (B, H*b, W*b, C):
    the inverse of data/device_ingest.py space_to_depth_batch (the model
    does not unpack; tests and tools do)."""
    b, h, w, c = x.shape
    c //= block * block
    x = x.reshape(b, h, w, block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * block, w * block, c)


def pack_stem_weight(w: torch.Tensor) -> torch.Tensor:
    """The stem's (F, 3, 11, 11) OIHW weight as the packed conv's
    (F, 48, 3, 3): padded to 12x12 taps, each 4x4 tap block folded into
    the channels in (dy, dx, c) order, the layout `space_to_depth_batch`
    packs. The padded 12th tap meets pixels the 11-tap kernel never sees,
    so its product is zero and its gradient is dropped by the pad."""
    f = w.shape[0]
    k = F.pad(w, (0, 1, 0, 1))                      # (F, 3, 12, 12)
    k = k.reshape(f, 3, 3, 4, 3, 4)                 # (F, c, ky, dy, kx, dx)
    return k.permute(0, 3, 5, 1, 2, 4).reshape(f, 48, 3, 3)


def takes_packed_stem(h: int, w: int, c: int) -> bool:
    """Whether the stem runs the packed conv on an (h, w, c) input: a
    packed input, or H and W multiples of 4 and at least 12 (JAX's
    condition)."""
    return c == 48 or (h % 4 == 0 and w % 4 == 0 and h >= 12 and w >= 12)


def _pooled(n: int) -> int:
    return (n + _ceil_pad(n) - 3) // 2 + 1


def fc6_fan_in(image_size: int, conv_features: int) -> int:
    """Width of the flattened pool5 output at `image_size` px."""
    side = (image_size - 11) // 4 + 1
    for _ in range(3):
        side = _pooled(side)
    return side * side * conv_features


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as NCHW in channels_last memory: a free view of a
    contiguous NHWC tensor, a copy otherwise."""
    return x.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


class VGGF(nn.Module):
    def __init__(self, num_classes: int = 1000, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224,
                 # LRN hyperparameters (TF / AlexNet-paper convention)
                 lrn_depth_radius: int = 2, lrn_bias: float = 2.0,
                 lrn_alpha: float = 1e-4, lrn_beta: float = 0.75,
                 # layer widths: the defaults ARE CNN-F; vggf_student halves
                 stem_features: int = 64, conv_features: int = 256,
                 fc_features: int = 4096, dropout_rate: float = 0.5):
        super().__init__()
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{dropout_rate}")
        self.compute_dtype = compute_dtype
        self.dropout_rate = float(dropout_rate)
        self.image_size = int(image_size)
        self.lrn_args = (lrn_depth_radius, lrn_bias, lrn_alpha, lrn_beta)
        self.conv1 = _Layer((stem_features, 3, 11, 11), stem_features)
        self.conv2 = _Layer((conv_features, stem_features, 5, 5),
                            conv_features)
        self.conv3 = _Layer((conv_features, conv_features, 3, 3),
                            conv_features)
        self.conv4 = _Layer((conv_features, conv_features, 3, 3),
                            conv_features)
        self.conv5 = _Layer((conv_features, conv_features, 3, 3),
                            conv_features)
        self.fc6 = _Layer((fc_features, fc6_fan_in(image_size,
                                                   conv_features)),
                          fc_features)
        self.fc7 = _Layer((fc_features, fc_features), fc_features)
        self.fc8 = _Layer((num_classes, fc_features), num_classes)

    def _conv(self, layer: _Layer, x, stride: int, padding: int,
              weight: torch.Tensor = None):
        cd = self.compute_dtype
        weight = layer.weight if weight is None else weight
        y = F.conv2d(x, weight.to(cd), None, stride, padding)
        return y + layer.bias.to(cd).view(1, -1, 1, 1)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 with its bias on NHWC images in the compute dtype, plain
        or packed -> NCHW in channels_last memory: the packed 3x3/1 conv
        where `takes_packed_stem`, else the plain 11x11/4 conv."""
        b, h, w, c = x.shape
        if not takes_packed_stem(h, w, c):
            if h < 11 or w < 11:  # JAX's VALID conv gives an empty map
                return x.new_zeros((b, self.conv1.bias.shape[0],
                                    max(0, (h - 11) // 4 + 1),
                                    max(0, (w - 11) // 4 + 1)))
            return self._conv(self.conv1, _nchw(x), 4, 0)
        if c != 48:
            x = space_to_depth_batch(x)
        return self._conv(self.conv1, _nchw(x), 1, 0,
                          weight=pack_stem_weight(self.conv1.weight))

    def _dense(self, layer: _Layer, x):
        cd = self.compute_dtype
        return F.linear(x, layer.weight.to(cd)) + layer.bias.to(cd)

    def _relu_lrn(self, z):
        # ReLU then LRN, fused into one kernel each way; the NHWC view of a
        # channels_last tensor is contiguous: the kernel normalizes rows of
        # C channels in place order
        y = relu_lrn(z.permute(0, 2, 3, 1).contiguous(), *self.lrn_args)
        return y.permute(0, 3, 1, 2)

    def _dropout(self, x, generator):
        p = self.dropout_rate
        keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
        return x * keep.div_(1.0 - p)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The conv trunk alone: NHWC images (finished) -> pool5 flattened
        in NHWC order, in the compute dtype — fc6's input. The int8 tier
        (serving/tiers.py) runs it without the heads."""
        reject_raw_uint8(x, "VGGF")
        x = maxpool_3x3s2_ceil_nchw(
            self._relu_lrn(self.stem(x.to(self.compute_dtype))))
        x = maxpool_3x3s2_ceil_nchw(
            self._relu_lrn(self._conv(self.conv2, x, 1, 2)))
        x = F.relu(self._conv(self.conv3, x, 1, 1))
        x = F.relu(self._conv(self.conv4, x, 1, 1))
        x = F.relu(self._conv(self.conv5, x, 1, 1))
        x = maxpool_3x3s2_ceil_nchw(x)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """NHWC images (finished, not raw u8) -> fp32 logits. `train=True`
        turns dropout on, drawing its bits from `generator` (on the
        input's device), which is then required."""
        dropout = train and self.dropout_rate > 0.0
        if dropout and generator is None:
            raise ValueError("VGGF(train=True) draws its dropout bits from "
                             "an explicit torch.Generator; pass generator=")
        x = F.relu(self._dense(self.fc6, self.trunk(x)))
        if dropout:
            x = self._dropout(x, generator)
        x = F.relu(self._dense(self.fc7, x))
        if dropout:
            x = self._dropout(x, generator)
        return self._dense(self.fc8, x).float()

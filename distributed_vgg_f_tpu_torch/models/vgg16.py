"""VGG-16 (Simonyan & Zisserman 2014, configuration D): the counterpart of
the JAX package's `models/vgg16.py VGG16`.

    conv{b}_{i} 3x3/1 SAME -> ReLU, in blocks of (2, 2, 3, 3, 3) convs at
    (64, 128, 256, 512, 512) features, a 2x2/2 VALID max-pool after each
    block; flatten (NHWC order) -> fc6 4096 -> ReLU -> dropout -> fc7 4096
    -> ReLU -> dropout -> fc8

No LRN (the VGG paper dropped it), so no kernel of the port's own runs
here: the convs are cuDNN's, the dense layers cuBLAS's. The conventions
are VGG-F's (models/vggf.py): NHWC input, activations NCHW in
`torch.channels_last` memory, bf16 compute with fp32 parameters and fp32
logits, biases added in the compute dtype after the product, dropout
bits from the caller's `torch.Generator`, and pool5 flattened in NHWC
order so fc6 is a plain transpose of the Flax kernel (weights.py).
`block_sizes` and `block_features` are the JAX model's `model.extra`
keys.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_vgg_f_tpu_torch.models.ingest import reject_raw_uint8
from distributed_vgg_f_tpu_torch.models.vggf import _Layer


class VGG16(nn.Module):
    def __init__(self, num_classes: int = 1000, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224, dropout_rate: float = 0.5,
                 block_sizes: Sequence[int] = (2, 2, 3, 3, 3),
                 block_features: Sequence[int] = (64, 128, 256, 512, 512)):
        super().__init__()
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{dropout_rate}")
        if len(block_sizes) != len(block_features):
            raise ValueError(f"block_sizes {tuple(block_sizes)} and "
                             f"block_features {tuple(block_features)} differ "
                             "in length")
        self.compute_dtype = compute_dtype
        self.dropout_rate = float(dropout_rate)
        self.image_size = int(image_size)
        self.convs = []
        cin, side = 3, int(image_size)
        for b, (reps, feat) in enumerate(zip(block_sizes, block_features),
                                         start=1):
            for i in range(1, int(reps) + 1):
                name = f"conv{b}_{i}"
                self.add_module(name, _Layer((feat, cin, 3, 3), feat))
                self.convs.append((name, i == reps))
                cin = feat
            side //= 2
        self.fc6 = _Layer((4096, side * side * cin), 4096)
        self.fc7 = _Layer((4096, 4096), 4096)
        self.fc8 = _Layer((num_classes, 4096), num_classes)

    def _dense(self, layer: _Layer, x):
        cd = self.compute_dtype
        return F.linear(x, layer.weight.to(cd)) + layer.bias.to(cd)

    def _dropout(self, x, generator):
        p = self.dropout_rate
        keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
        return x * keep.div_(1.0 - p)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """NHWC images (finished, not raw u8) -> fp32 logits. `train=True`
        turns dropout on, drawing its bits from `generator` (on the
        input's device), which is then required."""
        reject_raw_uint8(x, "VGG16")
        dropout = train and self.dropout_rate > 0.0
        if dropout and generator is None:
            raise ValueError("VGG16(train=True) draws its dropout bits from "
                             "an explicit torch.Generator; pass generator=")
        cd = self.compute_dtype
        x = x.to(cd).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        for name, last in self.convs:
            layer = getattr(self, name)
            x = F.relu(F.conv2d(x, layer.weight.to(cd), None, 1, 1)
                       + layer.bias.to(cd).view(1, -1, 1, 1))
            if last:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self._dense(self.fc6, x))
        if dropout:
            x = self._dropout(x, generator)
        x = F.relu(self._dense(self.fc7, x))
        if dropout:
            x = self._dropout(x, generator)
        return self._dense(self.fc8, x).float()

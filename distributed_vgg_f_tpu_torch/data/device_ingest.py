"""Device-finish prologue for the uint8 ingest wire.

The wire ships raw resampled uint8 pixels (1 byte a pixel); the finish
normalizes them on the device where the batch already lies:
``(x.float() - mean) * inv_std`` with ``inv_std = 1/std`` computed in
fp32. The reciprocal multiply, not a divide, makes the result bitwise
equal to the JAX package's finish (and its host loaders) for identical
pixels.

Single-normalization contract: the finish dispatches on dtype. uint8
batches are normalized exactly once; float batches pass through
untouched, so feeding the finish its own output is a no-op.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def space_to_depth_batch(x: torch.Tensor, block: int = 4) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C) in (dy, dx, c) channel order —
    the layout the VGG-F stem accepts packed."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // block, w // block, block * block * c)


def make_device_finish(mean_rgb: Sequence[float], stddev_rgb: Sequence[float],
                       *, image_dtype: str = "float32") -> Callable:
    """The finish: uint8 batches get normalize → cast; anything else passes
    through untouched. `image_dtype` is 'float32' or 'bfloat16'. Batches
    stay (S, S, 3): the VGG-F stem takes the plain layout (and the packed
    one, `space_to_depth_batch`)."""
    if image_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"image_dtype {image_dtype!r} not one of "
                         "('float32', 'bfloat16')")
    mean = torch.tensor(tuple(mean_rgb), dtype=torch.float32)
    inv_std = (torch.tensor(1.0, dtype=torch.float32)
               / torch.tensor(tuple(stddev_rgb), dtype=torch.float32))
    out_dtype = getattr(torch, image_dtype)

    def finish(images: torch.Tensor) -> torch.Tensor:
        if images.dtype != torch.uint8:
            return images  # already normalized — never touch twice
        x = (images.float() - mean.to(images.device)) \
            * inv_std.to(images.device)
        if out_dtype != torch.float32:
            x = x.to(out_dtype)
        return x

    return finish

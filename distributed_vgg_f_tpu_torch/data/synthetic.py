"""Seeded u8 batches: the `"synthetic"` source of `build_dataset`, and a
fixed batch for timing the train step without the host feed.

The batch is drawn once, in bulk, with numpy from the seed (uniform pixels
0..255, uniform labels), then repeated: making data counts as set-up, not
as step time. With `pin=True` it sits in page-locked host memory, so the
copy to the card is asynchronous and at full link rate.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


class SyntheticU8:
    """An endless iterator over one seeded batch of
    ``{"image": (B, S, S, 3) uint8, "label": (B,) int64}`` tensors."""

    image_dtype = "uint8"

    def __init__(self, batch_size: int, image_size: int, num_classes: int,
                 seed: int = 0, *, pin: bool = False):
        rng = np.random.default_rng(seed)
        images = torch.from_numpy(rng.integers(
            0, 256, (batch_size, image_size, image_size, 3), dtype=np.uint8))
        labels = torch.from_numpy(rng.integers(
            0, num_classes, (batch_size,), dtype=np.int64))
        if pin:
            images, labels = images.pin_memory(), labels.pin_memory()
        self.batch = {"image": images, "label": labels}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        return self.batch

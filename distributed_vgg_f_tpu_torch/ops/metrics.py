"""Classification metrics: top-k correct counts. Counts (not rates) are
returned so they add across eval batches and divide once by the total
example count. Own copy of the JAX package's ``ops/metrics.py``."""

from __future__ import annotations

from typing import Optional

import torch


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, k: int,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Number of examples whose true label is among the top-k logits.
    `valid` (bool per example) masks out padding rows, which would
    otherwise count as class-0 hits."""
    top = torch.topk(logits.float(), k, dim=-1).indices
    hit = (top == labels[:, None]).any(dim=-1)
    if valid is not None:
        hit = hit & valid
    return hit.sum()

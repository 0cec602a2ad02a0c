"""The predict forward and the top-k record shape — the single source of
the predict math the serving engine runs (serving/engine.py)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def build_forward(model: torch.nn.Module, finish: Callable) -> Callable:
    """images -> fp32 softmax probabilities: the device finish (uint8
    batches normalized once, float batches untouched), the model, then a
    softmax over fp32 logits."""

    def forward(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            logits = model(finish(images))
            return torch.softmax(logits.float(), dim=-1)

    return forward


def top_k_records(row, k: int) -> list[dict]:
    """One probability row → the top-k records a response carries, at full
    precision (exact values, so responses compare bitwise with the
    engine's own run)."""
    top = np.argsort(row)[::-1][:k]
    return [{"class": int(c), "prob": float(row[c])} for c in top]

"""Loss functions: softmax cross-entropy and the L2 weight decay coupled
into the loss (TF style, ``loss + wd * sum ||W||^2 / 2``), not decoupled
AdamW-style decay — coupling through momentum matters for parity. Own
copy of the JAX package's ``ops/losses.py``."""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
import torch.nn.functional as F

#: Parameter-path components that are never decayed: biases,
#: normalization scales, ViT position embeddings and the class token.
_EXEMPT = ("bias", "scale", "pos_embed", "cls")


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax-CE over the batch; `labels` are integer class ids.
    Logits are upcast to fp32 so the log-sum-exp is stable under bf16
    compute. With smoothing the target is (1-s)*onehot + s/C."""
    logits = logits.float()
    if label_smoothing > 0.0:
        num_classes = logits.shape[-1]
        onehot = F.one_hot(labels, num_classes).float()
        onehot = onehot * (1.0 - label_smoothing) \
            + label_smoothing / num_classes
        losses = -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
    else:
        losses = F.cross_entropy(logits, labels, reduction="none")
    return losses.mean()


def is_decayable(name: str, param: torch.Tensor) -> bool:
    """Decay kernels only: an ndim >= 2 parameter none of whose dotted
    path components is exempt."""
    if any(part in _EXEMPT for part in name.split(".")):
        return False
    return param.dim() >= 2


def l2_regularization(named_params: Iterable[Tuple[str, torch.Tensor]],
                      weight_decay: float) -> torch.Tensor:
    """0.5 * wd * sum ||W||^2 over the decayable parameters (TF `l2_loss`
    convention), summed in fp32 in parameter order."""
    acc = None
    for name, param in named_params:
        if weight_decay == 0.0 or not is_decayable(name, param):
            continue
        leaf = param.float()
        term = torch.sum(leaf * leaf)
        acc = term if acc is None else acc + term
    if acc is None:
        return torch.zeros((), dtype=torch.float32)
    return 0.5 * weight_decay * acc

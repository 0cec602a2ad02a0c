"""Device resolution for the port's entry points.

Every entry point (`serving.engine.build_engine`, `PredictEngine`,
`serving.server.serve_from_params`, `train.trainer.Trainer`,
`train.step.build_train_step`, `build_eval_step`) takes the CUDA device
by default and resolves it here. Without a CUDA device that raises: no path quietly
carries on on the CPU. The CPU runs only when the caller names it.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, refusing CUDA when none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: the port runs "
                         "on 'cuda' or, when asked, 'cpu'")
    return dev

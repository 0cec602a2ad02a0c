"""On-device augmentation of the train step: the horizontal flip and the
mixup the flagship turns on.

The counterpart of the JAX package's ``data/augment.py``
(`make_device_augment` :184, `_hflip` :73, the mixup branch of `_mix`
:132). The stage runs on the post-finish float batch (B, S, S, 3),
inside the train step, in the order finish -> augment -> space-to-depth:
packing comes after the flip, which would otherwise have to permute
channels inside each 4x4 block.

Every draw comes from a generator keyed by the step's augment key
(seed, step, AUGMENT_RNG_FOLD) and the op's index, so a step replays its
exact flips and mix pairing. Each op's draws are made by a function of
its own (`draw_hflip`, `draw_mixup`) and consumed by another (`hflip`,
`mixup`), so a test can hand the ops the draws the JAX package made. The
draws are made on the CPU and copied to the batch's device: they are
the same on the CPU and the card.

Crop jitter, cutmix and RandAugment-lite are not ported yet (ROADMAP A4);
a config that asks for them is refused.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from distributed_vgg_f_tpu_torch.data.device_ingest import \
    space_to_depth_batch
from distributed_vgg_f_tpu_torch.utils.rng import generator

#: Stream constant of the augment key, distinct from dropout's (the JAX
#: package's fold constant).
AUGMENT_RNG_FOLD = 0xA06

#: Op indices within the augment key (the JAX stage's key split order).
_FLIP, _MIX = 0, 3


def draw_hflip(gen: torch.Generator, batch: int) -> torch.Tensor:
    """Per-image flip decisions, each true with probability 1/2."""
    return torch.rand(batch, generator=gen) < 0.5


def hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Reverse the width axis of the images whose `flip` bit is set."""
    flip = flip.to(x.device).view(-1, 1, 1, 1)
    return torch.where(flip, x.flip(2), x)


def draw_mixup(gen: torch.Generator, batch: int,
               alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch permutation and one Beta(alpha, alpha) lam per step.
    torch's Beta sampler takes no generator, so lam comes from numpy,
    seeded from a draw of `gen`."""
    perm = torch.randperm(batch, generator=gen)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    lam = np.random.default_rng(seed).beta(alpha, alpha)
    return perm, torch.tensor(lam, dtype=torch.float32)


def mixup(x: torch.Tensor, labels: torch.Tensor, perm: torch.Tensor,
          lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """x*lam + x[perm]*(1-lam) in x's dtype; returns the mixed batch, the
    paired labels labels[perm] and lam (fp32). The loss mixes as
    lam*CE(y) + (1-lam)*CE(y[perm])."""
    perm = perm.to(x.device)
    lam = lam.to(x.device, torch.float32)
    lam_x = lam.to(x.dtype)
    return x * lam_x + x[perm] * (1.0 - lam_x), labels[perm], lam


def make_device_augment(aug_cfg, *,
                        space_to_depth: bool = False) -> Optional[Callable]:
    """The augment stage for the train step, or None when
    `aug_cfg.enabled` is false (the step then has no augment at all).

    The returned `augment(key, images, labels) -> (images, mix_labels,
    mix_lam)` takes the step's augment key (a tuple of ints) and the
    post-finish, unpacked (B, S, S, 3) float batch. `mix_labels` and
    `mix_lam` are None unless mixup is on. With `space_to_depth` the
    stage packs the batch 4x4 after augmenting."""
    if aug_cfg is None or not aug_cfg.enabled:
        return None
    for field, value in (("crop_jitter", aug_cfg.crop_jitter),
                         ("cutmix_alpha", aug_cfg.cutmix_alpha),
                         ("rand_ops", aug_cfg.rand_ops)):
        if value:
            raise NotImplementedError(
                f"data.augment.{field}={value}: the port augments with "
                "hflip and mixup only; crop jitter, cutmix and "
                "RandAugment-lite are ROADMAP A4")
    flip_on = bool(aug_cfg.hflip)
    alpha = float(aug_cfg.mixup_alpha)
    pack = bool(space_to_depth)

    def augment(key, images: torch.Tensor, labels: torch.Tensor):
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(
                f"device augmentation expects the unpacked (B, S, S, 3) "
                f"post-finish batch, got {tuple(images.shape)}")
        if images.dtype == torch.uint8:
            raise TypeError(
                "device augmentation runs after the device finish; a raw "
                "uint8 batch here means the finish was not applied")
        in_dtype = images.dtype
        b = images.shape[0]
        x = images.float()
        if flip_on:
            x = hflip(x, draw_hflip(generator(*key, _FLIP), b))
        mix_labels = mix_lam = None
        if alpha > 0:
            perm, lam = draw_mixup(generator(*key, _MIX), b, alpha)
            x, mix_labels, mix_lam = mixup(x, labels, perm, lam)
        x = x.to(in_dtype)
        if pack and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0:
            x = space_to_depth_batch(x)
        return x, mix_labels, mix_lam

    return augment

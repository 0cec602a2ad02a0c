"""On-device augmentation of the train step: horizontal flip, crop jitter,
RandAugment-lite, and mixup or cutmix.

The counterpart of the JAX package's ``data/augment.py``
(`make_device_augment` :184, `_hflip` :73, `_crop_jitter` :79,
`_rand_ops` :93, `_mix` :132). The stage runs on the post-finish float
batch (B, S, S, 3), inside the train step, in the order finish -> flip ->
jitter -> RandAugment -> mix -> cast back -> space-to-depth: packing comes
after the geometric ops, which would otherwise have to permute channels
inside each 4x4 block.

Every draw comes from a generator keyed by the step's augment key
(seed, step, AUGMENT_RNG_FOLD) and the op's index (JAX's key split order:
flip 0, jitter 1, rand 2, mix 3), so a step replays its exact
augmentations. Each op's draws are made by a function of its own
(`draw_hflip`, `draw_crop_jitter`, `draw_rand_ops`, `draw_mix`; all of a
step's by `draw_augment`) and consumed by another (`hflip`, `crop_jitter`,
`rand_ops`, `mixup`, `cutmix`, `mix`), so a test can hand the ops the
draws the JAX package made. The draws are made on the CPU and copied to
the batch's device: they are the same on the CPU and the card.

RandAugment-lite works on the 0..255 pixel scale: it de-normalises with
the finish's own single-rounded constants (data/device_ingest.py), applies
one of identity, brightness, contrast or posterize per image, clips and
re-normalises. Posterize's floor sits on integer pixel values, so every
product and sum is a separate op in JAX's order (no fused multiply-add).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_vgg_f_tpu_torch.data.device_ingest import \
    space_to_depth_batch
from distributed_vgg_f_tpu_torch.utils.rng import generator

#: Stream constant of the augment key, distinct from dropout's (the JAX
#: package's fold constant).
AUGMENT_RNG_FOLD = 0xA06

#: Op indices within the augment key (the JAX stage's key split order).
_FLIP, _JIT, _RAND, _MIX = 0, 1, 2, 3

#: RandAugment-lite's op table (op 0 is the identity), JAX's.
RAND_OPS = ("identity", "brightness", "contrast", "posterize")
#: Largest brightness shift at magnitude 1, in 0..255 levels.
_BRIGHTNESS_MAX_LEVELS = 64.0
#: Largest contrast factor deviation at magnitude 1 (factor in 1 ± this).
_CONTRAST_MAX_DELTA = 0.8
#: Largest posterize shift at magnitude 1: a step of 2^k, k in [0, 3].
_POSTERIZE_MAX_SHIFT = 3.0


class MixDraws(NamedTuple):
    """One step's mix draws: the pairing, the Beta-drawn lam of the op
    that runs, whether it is cutmix, and cutmix's box centre."""
    perm: torch.Tensor          # (B,) int64
    lam: torch.Tensor           # () fp32, lam0 of the chosen op
    use_cut: bool
    cy: int
    cx: int


class AugmentDraws(NamedTuple):
    """Every draw of one step; None for an op that is off."""
    flip: Optional[torch.Tensor]                          # (B,) bool
    jitter: Optional[Tuple[torch.Tensor, torch.Tensor]]   # dy, dx (B,)
    rand: Optional[Tuple[torch.Tensor, torch.Tensor]]     # op, u (n, B)
    mix: Optional[MixDraws]


def draw_hflip(gen: torch.Generator, batch: int) -> torch.Tensor:
    """Per-image flip decisions, each true with probability 1/2."""
    return torch.rand(batch, generator=gen) < 0.5


def hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Reverse the width axis of the images whose `flip` bit is set."""
    flip = flip.to(x.device).view(-1, 1, 1, 1)
    return torch.where(flip, x.flip(2), x)


def draw_crop_jitter(gen: torch.Generator, batch: int,
                     max_px: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image shifts (dy, dx), each uniform over [-max_px, max_px]."""
    dy = torch.randint(-max_px, max_px + 1, (batch,), generator=gen)
    dx = torch.randint(-max_px, max_px + 1, (batch,), generator=gen)
    return dy, dx


def crop_jitter(x: torch.Tensor, dy: torch.Tensor,
                dx: torch.Tensor) -> torch.Tensor:
    """Translate each image by (dy, dx) with edge replication: clipped row
    then column gathers, as JAX's `take_along_axis` pair."""
    b, h, w, c = x.shape
    dy, dx = dy.to(x.device), dx.to(x.device)
    rows = (torch.arange(h, device=x.device)[None, :]
            + dy[:, None]).clamp(0, h - 1)
    x = torch.gather(x, 1, rows[:, :, None, None].expand(b, h, w, c))
    cols = (torch.arange(w, device=x.device)[None, :]
            + dx[:, None]).clamp(0, w - 1)
    return torch.gather(x, 2, cols[:, None, :, None].expand(b, h, w, c))


def draw_rand_ops(gen: torch.Generator, batch: int,
                  n_ops: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each of `n_ops` rounds, a per-image op index uniform over
    RAND_OPS and a per-image strength u uniform over [-1, 1):
    (n_ops, B) int64 and (n_ops, B) fp32."""
    op = torch.randint(0, len(RAND_OPS), (n_ops, batch), generator=gen)
    u = torch.rand((n_ops, batch), generator=gen) * 2.0 - 1.0
    return op, u


def rand_ops(x: torch.Tensor, op: torch.Tensor, u: torch.Tensor,
             mean: torch.Tensor, inv_std: torch.Tensor,
             magnitude: float) -> torch.Tensor:
    """RandAugment-lite on the fp32 batch, one round a row of `op`/`u`:
    every candidate is computed and the per-image op selects, then the
    pixels clip to [0, 255] and re-normalise."""
    dev = x.device
    mean, inv_std = mean.to(dev), inv_std.to(dev)
    std = 1.0 / inv_std
    for i in range(op.shape[0]):
        o = op[i].to(dev).view(-1, 1, 1, 1)
        ui = u[i].to(dev)
        p = x * std + mean                       # back to 0..255
        bright = p + (ui * magnitude * _BRIGHTNESS_MAX_LEVELS).view(
            -1, 1, 1, 1)
        pivot = p.mean(dim=(1, 2), keepdim=True)
        factor = (1.0 + ui * magnitude * _CONTRAST_MAX_DELTA).view(
            -1, 1, 1, 1)
        contrast = (p - pivot) * factor + pivot
        step = torch.exp2(torch.round(
            ui.abs() * magnitude * _POSTERIZE_MAX_SHIFT)).view(-1, 1, 1, 1)
        poster = torch.floor(p / step) * step
        p = torch.where(o == 1, bright,
                        torch.where(o == 2, contrast,
                                    torch.where(o == 3, poster, p)))
        x = (p.clamp(0.0, 255.0) - mean) * inv_std
    return x


def draw_mix(gen: torch.Generator, batch: int, height: int, width: int,
             mixup_alpha: float, cutmix_alpha: float) -> MixDraws:
    """One batch permutation a step and the lam of the op that runs.
    With both alphas > 0, a fair coin picks cutmix or mixup for the whole
    step. torch's Beta sampler takes no generator, so lam, the coin and
    the box centre come from numpy, seeded from a draw of `gen`."""
    perm = torch.randperm(batch, generator=gen)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    rng = np.random.default_rng(seed)
    lam_mix = rng.beta(mixup_alpha, mixup_alpha) if mixup_alpha > 0 else 0.
    lam_cut = (rng.beta(cutmix_alpha, cutmix_alpha) if cutmix_alpha > 0
               else 0.)
    use_cut = cutmix_alpha > 0 and (mixup_alpha <= 0
                                    or bool(rng.random() < 0.5))
    cy, cx = int(rng.integers(0, height)), int(rng.integers(0, width))
    lam = torch.tensor(lam_cut if use_cut else lam_mix, dtype=torch.float32)
    return MixDraws(perm, lam, use_cut, cy, cx)


def mixup(x: torch.Tensor, labels: torch.Tensor, perm: torch.Tensor,
          lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """x*lam + x[perm]*(1-lam) in x's dtype; returns the mixed batch, the
    paired labels labels[perm] and lam (fp32). The loss mixes as
    lam*CE(y) + (1-lam)*CE(y[perm])."""
    perm = perm.to(x.device)
    lam = lam.to(x.device, torch.float32)
    lam_x = lam.to(x.dtype)
    return x * lam_x + x[perm] * (1.0 - lam_x), labels[perm.to(
        labels.device)], lam


def cutmix_box(lam0: torch.Tensor, height: int, width: int, cy: int,
               cx: int) -> Tuple[int, int, int, int]:
    """The pasted box (y0, y1, x0, x1): area fraction 1 - lam0 around
    (cy, cx), clipped to the image; sizes round half to even in fp32, as
    JAX's."""
    ratio = torch.sqrt(1.0 - lam0.float().cpu())
    bh = int(torch.round(ratio * height))
    bw = int(torch.round(ratio * width))
    y0, y1 = (min(max(cy - bh // 2, 0), height),
              min(max(cy + (bh + 1) // 2, 0), height))
    x0, x1 = (min(max(cx - bw // 2, 0), width),
              min(max(cx + (bw + 1) // 2, 0), width))
    return y0, y1, x0, x1


def cutmix(x: torch.Tensor, labels: torch.Tensor, perm: torch.Tensor,
           lam0: torch.Tensor, cy: int, cx: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paste the box of x[perm] into x; lam is re-derived from the clipped
    box, so the label mix matches the pixels pasted. Returns the batch,
    labels[perm] and lam (fp32)."""
    _, h, w, _ = x.shape
    y0, y1, x0, x1 = cutmix_box(lam0, h, w, cy, cx)
    perm = perm.to(x.device)
    out = x.clone()
    out[:, y0:y1, x0:x1] = x[perm, y0:y1, x0:x1]
    area = torch.tensor((y1 - y0) * (x1 - x0), dtype=torch.float32)
    lam = 1.0 - area / float(h * w)
    return out, labels[perm.to(labels.device)], lam.to(x.device)


def mix(x: torch.Tensor, labels: torch.Tensor, draws: MixDraws
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cutmix or mixup, as the step's draws chose."""
    if draws.use_cut:
        return cutmix(x, labels, draws.perm, draws.lam, draws.cy, draws.cx)
    return mixup(x, labels, draws.perm, draws.lam)


def draw_augment(aug_cfg, key, batch: int, height: int,
                 width: int) -> AugmentDraws:
    """All of one step's draws for `aug_cfg` from the step's augment key,
    each op from its own generator (key, op index)."""
    mixup_alpha = float(aug_cfg.mixup_alpha)
    cutmix_alpha = float(aug_cfg.cutmix_alpha)
    return AugmentDraws(
        flip=(draw_hflip(generator(*key, _FLIP), batch)
              if aug_cfg.hflip else None),
        jitter=(draw_crop_jitter(generator(*key, _JIT), batch,
                                 int(aug_cfg.crop_jitter))
                if aug_cfg.crop_jitter > 0 else None),
        rand=(draw_rand_ops(generator(*key, _RAND), batch,
                            int(aug_cfg.rand_ops))
              if aug_cfg.rand_ops > 0 else None),
        mix=(draw_mix(generator(*key, _MIX), batch, height, width,
                      mixup_alpha, cutmix_alpha)
             if mixup_alpha > 0 or cutmix_alpha > 0 else None))


def make_device_augment(aug_cfg, mean_rgb: Sequence[float],
                        stddev_rgb: Sequence[float], *,
                        space_to_depth: bool = False) -> Optional[Callable]:
    """The augment stage for the train step, or None when
    `aug_cfg.enabled` is false (the step then has no augment at all).
    `mean_rgb` and `stddev_rgb` are the finish's: RandAugment
    de-normalises with them.

    The returned `augment(key, images, labels) -> (images, mix_labels,
    mix_lam)` takes the step's augment key (a tuple of ints) and the
    post-finish, unpacked (B, S, S, 3) float batch. `mix_labels` and
    `mix_lam` are None unless mixup or cutmix is on. With
    `space_to_depth` the stage packs the batch 4x4 after augmenting."""
    if aug_cfg is None or not aug_cfg.enabled:
        return None
    mean = torch.tensor(tuple(mean_rgb), dtype=torch.float32)
    inv_std = (torch.tensor(1.0, dtype=torch.float32)
               / torch.tensor(tuple(stddev_rgb), dtype=torch.float32))
    magnitude = float(aug_cfg.rand_magnitude)
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
        b, h, w, _ = images.shape
        draws = draw_augment(aug_cfg, key, b, h, w)
        x = images.float()
        if draws.flip is not None:
            x = hflip(x, draws.flip)
        if draws.jitter is not None:
            x = crop_jitter(x, *draws.jitter)
        if draws.rand is not None:
            x = rand_ops(x, *draws.rand, mean, inv_std, magnitude)
        mix_labels = mix_lam = None
        if draws.mix is not None:
            x, mix_labels, mix_lam = mix(x, labels, draws.mix)
        x = x.to(in_dtype)
        if pack and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0:
            x = space_to_depth_batch(x)
        return x, mix_labels, mix_lam

    return augment

"""The JAX package's augment draws in the port's form.

torch and JAX draw different numbers from one seed, so tests that hold
the port's augment stage to JAX's hand the port the draws JAX's stage
makes from its key (`distributed_vgg_f_tpu/data/augment.py`): the key
split into flip 0, jitter 1, rand 2, mix 3; the jitter's (dy, dx) from
`split(k_jit)`; RandAugment's (op, u) a round from
`split(fold_in(key, i), 3)`, the third key carried to the next round;
the mix's permutation, lam (cutmix's from `fold_in(k_lam, 1)` when both
alphas are on), the coin and the box centre (cx from `fold_in(k_box,
1)`). `jax_step_augment_key` is the key JAX's train step hands its stage
(`train/step.py:249–263`), so a test can swap the port's
`data.augment.draw_augment` for `jax_draws_for_port_key`."""

from __future__ import annotations

import jax
import numpy as np
import torch

from distributed_vgg_f_tpu.data.augment import AUGMENT_RNG_FOLD
from distributed_vgg_f_tpu_torch.data.augment import AugmentDraws, MixDraws


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def jax_flip(k_flip, b):
    return _t(jax.random.bernoulli(k_flip, 0.5, (b,)))


def jax_jitter(k_jit, b, max_px):
    ky, kx = jax.random.split(k_jit)
    return (_t(jax.random.randint(ky, (b,), -max_px, max_px + 1),
               torch.int64),
            _t(jax.random.randint(kx, (b,), -max_px, max_px + 1),
               torch.int64))


def jax_rand(k_rand, b, n_ops):
    ops, us, key = [], [], k_rand
    for i in range(n_ops):
        k_op, k_mag, key = jax.random.split(jax.random.fold_in(key, i), 3)
        ops.append(np.array(jax.random.randint(k_op, (b,), 0, 4)))
        us.append(np.array(jax.random.uniform(k_mag, (b,), minval=-1.0,
                                              maxval=1.0)))
    return _t(np.stack(ops), torch.int64), _t(np.stack(us))


def jax_mix(k_mix, b, h, w, mixup_alpha, cutmix_alpha):
    k_perm, k_lam, k_box, k_choice = jax.random.split(k_mix, 4)
    perm = _t(jax.random.permutation(k_perm, b), torch.int64)
    if mixup_alpha > 0 and cutmix_alpha > 0:
        lam_mix = jax.random.beta(k_lam, mixup_alpha, mixup_alpha)
        lam_cut = jax.random.beta(jax.random.fold_in(k_lam, 1),
                                  cutmix_alpha, cutmix_alpha)
        use_cut = bool(jax.random.bernoulli(k_choice, 0.5))
        lam = lam_cut if use_cut else lam_mix
    elif cutmix_alpha > 0:
        use_cut, lam = True, jax.random.beta(k_lam, cutmix_alpha,
                                             cutmix_alpha)
    else:
        use_cut, lam = False, jax.random.beta(k_lam, mixup_alpha,
                                              mixup_alpha)
    cy = int(jax.random.randint(k_box, (), 0, h))
    cx = int(jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, w))
    return MixDraws(perm, _t(lam, torch.float32), use_cut, cy, cx)


def jax_augment_draws(aug_cfg, key, b, h, w) -> AugmentDraws:
    """Every draw JAX's stage makes from its augment `key` for `aug_cfg`."""
    k_flip, k_jit, k_rand, k_mix = jax.random.split(key, 4)
    mixup_alpha = float(aug_cfg.mixup_alpha)
    cutmix_alpha = float(aug_cfg.cutmix_alpha)
    return AugmentDraws(
        flip=jax_flip(k_flip, b) if aug_cfg.hflip else None,
        jitter=(jax_jitter(k_jit, b, int(aug_cfg.crop_jitter))
                if aug_cfg.crop_jitter > 0 else None),
        rand=(jax_rand(k_rand, b, int(aug_cfg.rand_ops))
              if aug_cfg.rand_ops > 0 else None),
        mix=(jax_mix(k_mix, b, h, w, mixup_alpha, cutmix_alpha)
             if mixup_alpha > 0 or cutmix_alpha > 0 else None))


def jax_step_augment_key(seed, step, rank, impl):
    """The augment key of JAX's train step: the trainer's base key
    (`key(seed + 1, impl)`), folded with the step, the replica and
    AUGMENT_RNG_FOLD."""
    rng = jax.random.fold_in(jax.random.key(seed + 1, impl=impl), step)
    rng = jax.random.fold_in(rng, rank)
    return jax.random.fold_in(rng, AUGMENT_RNG_FOLD)


def jax_draws_for_port_key(impl):
    """A stand-in for the port's `draw_augment` that draws JAX's numbers
    for the port's step key (seed, step, AUGMENT_RNG_FOLD) of a
    one-process run (rank 0, whose replica seed is the seed)."""
    def draw_augment(aug_cfg, key, b, h, w):
        seed, step = int(key[0]), int(key[1])
        return jax_augment_draws(
            aug_cfg, jax_step_augment_key(seed, step, 0, impl), b, h, w)
    return draw_augment

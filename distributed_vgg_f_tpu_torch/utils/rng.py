"""Seeded `torch.Generator`s keyed by tuples of ints.

The JAX train step folds its key as ``fold_in(base_rng, step)`` and folds
constants off that for augmentation. torch has no key folding, so the
port derives one 63-bit seed from the whole tuple (numpy's SeedSequence
hashes it) and seeds a fresh generator with it: the same (seed, step,
stream) always gives the same bits on the same device, and distinct
tuples give independent streams. torch and JAX draw different numbers
from the same seed; tests that compare the two inject the draws.
"""

from __future__ import annotations

import numpy as np
import torch


def fold_seed(*key: int) -> int:
    """One 63-bit seed from a tuple of non-negative ints."""
    words = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) & ((1 << 63) - 1)


def generator(*key: int, device="cpu") -> torch.Generator:
    """A fresh generator on `device` seeded from `key`."""
    return torch.Generator(device=device).manual_seed(fold_seed(*key))


#: Stream constant that folds a replica's rank into the step's seed.
REPLICA_RNG_FOLD = 0x5EED


def replica_seed(seed: int, rank: int) -> int:
    """The seed replica `rank` keys its dropout and augment draws with —
    the port's `fold_in(key, axis_index)`: the seed itself on rank 0, so
    a one-process run draws what it always drew, and a seed folded from
    (seed, rank) on every other rank. Every draw of a step then comes
    from (seed, step, rank) and replays from it."""
    return int(seed) if rank == 0 else fold_seed(seed, REPLICA_RNG_FOLD,
                                                 rank)

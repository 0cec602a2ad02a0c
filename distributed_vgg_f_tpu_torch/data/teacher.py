"""The teacher task: a procedural data set with a real train/val gap and
no external data — an own copy of the JAX package's ``data/teacher.py``
(`Teacher`, `_raw_images`, `TeacherTaskDataset`), in numpy, byte-equal.

- **Images**: per-index procedural textures — 8×8 uniform noise upsampled
  to the image size plus high-frequency noise. The low-resolution part is
  the learnable signal; the rest is nuisance.
- **Labels**: the argmax of a fixed random nonlinear teacher (mean-pool
  8×8 -> tanh hidden layer -> logits) on the clean image, its class
  biases calibrated once so chance is ~1/num_classes.
- **Train stream** (`TeacherTaskDataset`, indices [0, num_examples)):
  augmented inputs (reflect-padded crop shifts of at most 2 px, additive
  noise) and 10 % of labels resampled, seeded per index.

Everything is a pure function of (seed, index). The distillation tool
(train/distill.py) trains the student on it against the teacher's full
logits, and the int8 tier's calibration stream (serving/tiers.py
`calibration_images`) draws from the same textures. The eval split's
factory (`build_teacher`, with the finite eval iterable) is ROADMAP A17.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np


class Teacher:
    """The fixed random labeler: mean-pool 8×8 -> tanh(W1·) -> W2· + b.
    Coarse on purpose (a 4×4 grid at 32 px, 32 hidden units), so the task
    is learnable from a few thousand examples yet not separable."""

    HIDDEN = 32
    POOL = 8

    def __init__(self, image_size: int, num_classes: int, *, seed: int = 7,
                 channels: int = 3):
        rng = np.random.default_rng(seed)
        side = image_size // self.POOL
        feat = side * side * channels
        self.image_size = image_size
        self.channels = channels
        self.w1 = rng.standard_normal((feat, self.HIDDEN)).astype(np.float32) \
            / np.sqrt(feat)
        self.b1 = 0.1 * rng.standard_normal(self.HIDDEN).astype(np.float32)
        self.w2 = rng.standard_normal(
            (self.HIDDEN, num_classes)).astype(np.float32) \
            / np.sqrt(self.HIDDEN)
        # per-class biases calibrated on a deterministic sample, so the
        # argmax labels come out roughly balanced
        self.b2 = np.zeros(num_classes, np.float32)
        sample = _raw_images(rng.integers(0, 2**31, size=2048), image_size,
                             base_seed=seed + 1)
        logits = self._logits(sample)
        self.b2 = (-logits.mean(axis=0)).astype(np.float32)

    def _features(self, images: np.ndarray) -> np.ndarray:
        n, s, _, c = images.shape
        p = self.POOL
        x = images.reshape(n, s // p, p, s // p, p, c).mean(axis=(2, 4))
        return x.reshape(n, -1) / 255.0 - 0.5

    def _logits(self, images: np.ndarray) -> np.ndarray:
        h = np.tanh(self._features(images) @ self.w1 + self.b1)
        return h @ self.w2 + self.b2

    def logits(self, images: np.ndarray) -> np.ndarray:
        """Teacher logits on uint8-ranged pixels: the distillation target
        (the full distribution, not only the argmax `label` gives)."""
        return self._logits(np.asarray(images, np.float32))

    def label(self, images: np.ndarray) -> np.ndarray:
        return np.argmax(self._logits(images), axis=1).astype(np.int32)


def _raw_images(indices: np.ndarray, image_size: int, *,
                base_seed: int) -> np.ndarray:
    """Per-index procedural texture: an 8×8 signal upsampled plus
    high-frequency noise, uint8-ranged float32 (N, S, S, 3)."""
    out = np.empty((len(indices), image_size, image_size, 3), np.float32)
    rep = image_size // 8
    for i, idx in enumerate(np.asarray(indices, np.int64)):
        rng = np.random.default_rng((base_seed << 32) ^ int(idx))
        low = rng.uniform(0.0, 255.0, size=(8, 8, 3)).astype(np.float32)
        img = np.repeat(np.repeat(low, rep, axis=0), rep, axis=1)
        img += rng.normal(0.0, 12.0, size=img.shape).astype(np.float32)
        out[i] = np.clip(img, 0.0, 255.0)
    return out


class TeacherTaskDataset:
    """Train iterator of {'image', 'label'} batches over the teacher task:
    float32 images normalized with `mean` and `std` (127.5 and 64 by
    default), int32 labels."""

    LABEL_NOISE = 0.10

    def __init__(self, batch_size: int, image_size: int, num_classes: int,
                 *, seed: int, num_examples: int, start_index: int = 0,
                 shard_index: int = 0, num_shards: int = 1,
                 image_dtype: str = "float32",
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None):
        if image_dtype != "float32":
            # numpy has no bfloat16 of its own; the port's consumers cast
            # on the device
            raise ValueError(f"the teacher stream is float32, got "
                             f"image_dtype={image_dtype!r}")
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_examples = num_examples
        self.start_index = start_index
        self.seed = seed
        self.teacher = Teacher(image_size, num_classes, seed=7)
        self.mean = (np.asarray(mean, np.float32) if mean is not None
                     else np.float32(127.5))
        self.std = (np.asarray(std, np.float32) if std is not None
                    else np.float32(64.0))
        self.dtype = np.dtype(np.float32)
        self.num_classes = num_classes
        # this process's shard of the example index space
        self._indices = np.arange(start_index,
                                  start_index + num_examples)[
                                      shard_index::num_shards]
        self._rng = np.random.default_rng(seed + 1000 * shard_index)
        self._order = self._indices.copy()
        self._pos = len(self._order)  # shuffle on the first draw

    def _clean_labels(self, images: np.ndarray) -> np.ndarray:
        return self.teacher.label(images)

    def _noisy_labels(self, labels: np.ndarray,
                      indices: np.ndarray) -> np.ndarray:
        out = labels.copy()
        for i, idx in enumerate(np.asarray(indices, np.int64)):
            r = np.random.default_rng((77 << 32) ^ int(idx))
            if r.random() < self.LABEL_NOISE:
                out[i] = r.integers(0, self.num_classes)
        return out

    def _augment(self, images: np.ndarray) -> np.ndarray:
        n, s = images.shape[0], self.image_size
        # shifts below half a teacher cell: a larger one would relabel the
        # image under the teacher's own rule
        pad = 2
        padded = np.pad(images, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                        mode="reflect")
        out = np.empty_like(images)
        ys = self._rng.integers(0, 2 * pad + 1, size=n)
        xs = self._rng.integers(0, 2 * pad + 1, size=n)
        for i in range(n):
            out[i] = padded[i, ys[i]:ys[i] + s, xs[i]:xs[i] + s]
        # no flip: the teacher is not flip-invariant, so flips would
        # corrupt labels far beyond the designed 10 % noise
        out += self._rng.normal(0.0, 4.0, size=out.shape).astype(np.float32)
        return out

    def __iter__(self):
        return self

    def __next__(self) -> Mapping[str, np.ndarray]:
        if self._pos + self.batch_size > len(self._order):
            self._rng.shuffle(self._order)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        clean = _raw_images(idx, self.image_size, base_seed=11)
        labels = self._noisy_labels(self._clean_labels(clean), idx)
        images = (self._augment(clean) - self.mean) / self.std
        return {"image": images.astype(self.dtype), "label": labels}

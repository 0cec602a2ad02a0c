"""Per-model predict engine over a ladder of batch buckets.

The dynamic batcher hands the engine variable-size groups of u8 images;
the engine pads each group with u8 zeros to the nearest bucket, runs the
predict forward (train/predict.py build_forward: device finish, model,
fp32 softmax) on the engine's device, and slices the real rows back out.
The pad rows' outputs never leave `run`.

The engine runs eagerly: each bucket is one fixed geometry, so every
admissible shape is seen at `warmup` (kernel build, cuDNN planning) and
steady traffic meets no first-use cost. `compile_log` keeps each bucket's
first-run seconds. Equal inputs through equal buckets give equal bits;
across bucket geometries agreement is only a tolerance claim.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_vgg_f_tpu_torch.config import ModelConfig
from distributed_vgg_f_tpu_torch.config import \
    resolve_serving_buckets as resolve_buckets
from distributed_vgg_f_tpu_torch.data.device_ingest import make_device_finish
from distributed_vgg_f_tpu_torch.device import resolve_device
from distributed_vgg_f_tpu_torch.models.ingest import (IngestDescriptor,
                                                       ingest_descriptor)
from distributed_vgg_f_tpu_torch.ops.batch_norm import batch_stats_of
from distributed_vgg_f_tpu_torch.train.predict import build_forward


class PredictEngine:
    """One model's bucket ladder + routing metadata, on one device."""

    def __init__(self, *, model_name: str, model: torch.nn.Module,
                 image_size: int, num_classes: int,
                 buckets: Sequence[int] = (), max_batch: int = 32,
                 image_dtype: str = "float32",
                 mean_rgb: Optional[Sequence[float]] = None,
                 stddev_rgb: Optional[Sequence[float]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model_name = str(model_name)
        self.descriptor: IngestDescriptor = ingest_descriptor(model_name)
        self.image_size = int(image_size)
        self.num_classes = int(num_classes)
        self.buckets = resolve_buckets(buckets, max_batch)
        # normalize constants: the caller's when given, the descriptor's
        # otherwise (the zoo pins the two equal)
        mean = tuple(mean_rgb if mean_rgb is not None
                     else self.descriptor.mean_rgb)
        std = tuple(stddev_rgb if stddev_rgb is not None
                    else self.descriptor.stddev_rgb)
        self._model = model.to(self.device).eval()
        # predict convention: batches stay (S, S, 3); the stem takes the
        # plain layout, so the serving wire never ships packed pixels
        finish = make_device_finish(mean, std, image_dtype=image_dtype)
        self._forward = build_forward(self._model, finish)
        self._first_run_lock = threading.Lock()
        #: bucket -> seconds of its first run (warmup or first request)
        self.compile_log: Dict[int, float] = {}
        # the BatchNorm statistics live on the device beside the params
        # (JAX `serving/engine.py:120`)
        self._params_bytes = sum(
            t.numel() * t.element_size()
            for t in [*self._model.parameters(),
                      *batch_stats_of(self._model).values()])

    @property
    def hbm_estimate_bytes(self) -> int:
        """Analytic device-residency lower bound: parameters and BatchNorm
        statistics at their storage dtypes plus the top bucket's
        wire-in/probs-out buffers."""
        top = self.buckets[-1]
        io = top * (self.image_size * self.image_size * 3 * 4  # f32 finish
                    + self.image_size * self.image_size * 3    # u8 wire
                    + self.num_classes * 4)                    # f32 probs
        return self._params_bytes + io

    def _run_bucket(self, padded: np.ndarray) -> np.ndarray:
        bucket = int(padded.shape[0])
        x = torch.from_numpy(padded).to(self.device)
        if bucket in self.compile_log:
            return self._forward(x).cpu().numpy()
        with self._first_run_lock:
            t0 = time.monotonic()
            # the download to the host waits for the device
            probs = self._forward(x).cpu().numpy()
            self.compile_log.setdefault(bucket,
                                        round(time.monotonic() - t0, 4))
        return probs

    def warmup(self) -> int:
        """Run every bucket once now (server start), so the first request
        of any shape pays no first-use cost. Returns the bucket count."""
        for b in self.buckets:
            if b not in self.compile_log:
                self._run_bucket(np.zeros(
                    (b, self.image_size, self.image_size, 3), np.uint8))
        return len(self.buckets)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits a group of n."""
        if n < 1:
            raise ValueError(f"empty batch (n={n})")
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"group of {n} exceeds the top bucket "
                         f"{self.buckets[-1]} — the batcher's max_batch "
                         "must not exceed it")

    def run(self, images: np.ndarray) -> Tuple[np.ndarray, int]:
        """(probs[n, num_classes] float32, bucket) for a u8 group of n."""
        n = int(images.shape[0])
        bucket = self.bucket_for(n)
        if bucket != n:
            padded = np.zeros((bucket,) + tuple(images.shape[1:]), np.uint8)
            padded[:n] = images
        else:
            padded = np.ascontiguousarray(images, np.uint8)
        return self._run_bucket(padded)[:n], bucket

    def describe(self) -> dict:
        """Routing-table row for GET /v1/models."""
        return {"model": self.model_name,
                "device": str(self.device),
                "image_size": self.image_size,
                "num_classes": self.num_classes,
                "buckets": list(self.buckets),
                "payload_bytes": self.image_size * self.image_size * 3,
                "warm_buckets": sorted(self.compile_log),
                "warmup_s": {str(b): s
                             for b, s in sorted(self.compile_log.items())},
                "hbm_estimate_bytes": self.hbm_estimate_bytes,
                "ingest": self.descriptor.describe()}


def build_engine(model_name: str, image_size: int, num_classes: int,
                 buckets: Sequence[int] = (), max_batch: int = 32,
                 weights: str = "", *, device="cuda",
                 compute_dtype: str = "bfloat16",
                 seed: int = 0,
                 extra: Optional[Mapping[str, Any]] = None) -> PredictEngine:
    """An engine over the weights npz (the flat 'layer/leaf' file the JAX
    package's distill writes; a model with BatchNorm reads its statistics
    from the file's ``batch_stats/<layer>/<leaf>`` keys) or, without one,
    the seeded Flax init and Flax's initial statistics. `extra` is the
    model's `ModelConfig.extra` (for ViT: widths, depth and
    `attention_layout`, e.g. ``{"attention_layout": "flash"}``; for
    ResNet: `stage_sizes`, `stem`)."""
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.weights import (init_batch_stats,
                                                      init_params, load_npz,
                                                      load_params)
    dev = resolve_device(device)
    cfg = ModelConfig(name=model_name, num_classes=num_classes,
                      compute_dtype=compute_dtype, extra=dict(extra or {}))
    model = build_model(cfg, image_size=image_size)
    if weights:
        tree = load_npz(weights)
        stats = tree.pop("batch_stats", {})
    else:
        tree = init_params(cfg, seed, image_size=image_size)
        stats = init_batch_stats(cfg, image_size=image_size)
    load_params(model, tree, stats)
    return PredictEngine(model_name=model_name, model=model,
                         image_size=image_size, num_classes=num_classes,
                         buckets=buckets, max_batch=max_batch, device=dev)

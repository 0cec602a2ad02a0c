"""Typed configuration for the port's serving slice.

Own copies of the parts of the JAX package's `config.py` this slice reads:
`ModelConfig` (without the training-only dropout rate and the model
overrides no served model needs), the `DataConfig`
fields serving uses, a `ServingConfig`
limited to the fields the port honours, `resolve_serving_buckets`, and
the model/data/serving part of the `vggf_imagenet_dp` preset. The
admission-controller and tier fields are absent until their slice ports
them: a field the port would accept and ignore is left out instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from distributed_vgg_f_tpu_torch.models.ingest import (IMAGENET_MEAN_RGB,
                                                       IMAGENET_STDDEV_RGB)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "vggf"                 # key into models.registry
    num_classes: int = 1000            # classifier width (ImageNet-1k default)
    # activations/conv compute dtype; params stay float32
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class DataConfig:
    """The data fields serving reads: the payload size and the device
    finish's normalize constants and output dtype."""
    image_size: int = 224    # square input resolution (the u8 payload side)
    # dtype the device finish emits ("float32" | "bfloat16"); the model
    # casts to its compute dtype downstream either way
    image_dtype: str = "float32"
    mean_rgb: Sequence[float] = IMAGENET_MEAN_RGB
    stddev_rgb: Sequence[float] = IMAGENET_STDDEV_RGB  # see mean_rgb


def resolve_serving_buckets(buckets: Sequence[int],
                            max_batch: int) -> tuple:
    """The serving batch-bucket ladder, validated. Explicit `buckets` must
    be unique ascending positive ints covering max_batch (groups pad to
    the nearest bucket); () = the power-of-two ladder up to max_batch,
    whose top bucket IS max_batch so a full flush never splits."""
    if buckets:
        out = tuple(int(b) for b in buckets)
        if list(out) != sorted(set(out)) or out[0] < 1:
            raise ValueError(f"buckets must be unique ascending positive "
                             f"ints, got {list(buckets)}")
        if out[-1] < int(max_batch):
            raise ValueError(
                f"buckets {list(out)} do not cover max_batch={max_batch} "
                "— a full flush would have no bucket to run on")
        return out
    out = []
    b = 1
    while b < int(max_batch):
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(sorted(set(out)))


@dataclass(frozen=True)
class ServingConfig:
    """The dynamic-batching predict server: a stdlib-HTTP front end fed raw
    u8 payloads, a bounded admission queue with max-latency and max-batch
    flush, one warm engine geometry per batch bucket, and typed overload
    behaviour (503 shed, never unbounded latency)."""
    # Bind address. Loopback by default: the endpoint is unauthenticated.
    host: str = "127.0.0.1"
    # 0 = OS-assigned free port (start() returns the bound one).
    port: int = 0
    # Largest batch one flush may form; also the top batch bucket.
    max_batch: int = 32
    # Batch buckets (ascending; groups pad to the nearest). () = the
    # power-of-two ladder 1,2,4,...,max_batch.
    buckets: Sequence[int] = ()
    # Admission window: max milliseconds the OLDEST queued request waits
    # for company before a partial batch flushes.
    max_latency_ms: float = 10.0
    # Bounded admission queue: arrivals past this depth shed with a 503.
    queue_limit: int = 128
    # Cap on one request's total wait (queue + batch + run); exceeded → 504.
    request_timeout_s: float = 30.0
    # Retry-After hint (ms) carried in the 503 shed payload.
    shed_retry_after_ms: int = 50
    # Run every bucket once at add_engine time, so the first request of
    # any shape pays no first-use cost (kernel build, cuDNN planning).
    warmup: bool = True

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(
                f"serving.max_batch must be >= 1, got {self.max_batch}")
        resolve_serving_buckets(self.buckets, self.max_batch)
        if self.queue_limit < 1:
            raise ValueError(
                f"serving.queue_limit must be >= 1, got {self.queue_limit}")
        if self.max_latency_ms <= 0 or self.request_timeout_s <= 0:
            raise ValueError(
                "serving.max_latency_ms and request_timeout_s must be > 0, "
                f"got {self.max_latency_ms}/{self.request_timeout_s}")
        if self.shed_retry_after_ms < 0:
            raise ValueError(
                f"serving.shed_retry_after_ms must be >= 0, got "
                f"{self.shed_retry_after_ms}")


@dataclass(frozen=True)
class ExperimentConfig:
    """The model/data/serving part of an experiment preset."""
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)


def _vggf_imagenet_dp() -> ExperimentConfig:
    """The flagship: VGG-F on ImageNet-1k at 224 px, bf16 compute with
    fp32 params, served on the power-of-two ladder up to 32."""
    return ExperimentConfig(
        name="vggf_imagenet_dp",
        model=ModelConfig(name="vggf", num_classes=1000),
        data=DataConfig(image_size=224),
        serving=ServingConfig())


PRESETS = {"vggf_imagenet_dp": _vggf_imagenet_dp}


def get_config(name: str) -> ExperimentConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(PRESETS)}") from None

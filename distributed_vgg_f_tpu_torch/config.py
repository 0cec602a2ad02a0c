"""Typed configuration of the port.

Own copies of the parts of the JAX package's `config.py` the port reads:
`ModelConfig` (with its `extra` overrides), `OptimConfig`,
`AugmentConfig`, the `DataConfig` fields serving, the training step,
the trainer's feed and eval use,
`MeshConfig` (the gradient exchange: ZeRO-1/2, buckets, the wire),
`TrainConfig` limited to the fields the step, the core loop, its feed,
checkpoints, eval cadence, best slot and preemption read,
`ServingConfig` with its admission controller and `ServingTiersConfig`
(the tier ladder, `SERVING_TIERS`),
`resolve_serving_buckets`, the derived `scaled_lr` / `steps_per_epoch` /
`total_steps`, `supports_space_to_depth` and `zoo_data` (each zoo
preset's data through its model's ingest descriptor), the
`vggf_imagenet_dp`, `vggf_teacher`, `vgg16_imagenet`,
`resnet50_imagenet` and `vit_s16_imagenet` presets, and the command
line's override machinery
(`apply_overrides`, `fold_override_items`, `parse_cli`: the JAX
package's dotted `--set KEY=VALUE` keys and refusals).

`AutotuneConfig` switches the ingest autotuner on or off;
`SnapshotCacheConfig` (JAX `config.py:43–75`) the decoded-crop snapshot
cache behind the train stream (data/snapshot_cache.py).
Fields of later slices (telemetry, elastic resize, ...) are absent
until their slice ports them: a field the port would accept and ignore
is left out instead, and a `--set` of one raises, naming its ROADMAP
item (`UNPORTED_KEYS`).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Optional, Sequence

from distributed_vgg_f_tpu_torch.models.ingest import (IMAGENET_MEAN_RGB,
                                                       IMAGENET_STDDEV_RGB)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "vggf"                 # key into models.registry
    num_classes: int = 1000            # classifier width (ImageNet-1k default)
    # FC-head dropout; 0 disables (eval always runs without)
    dropout_rate: float = 0.5
    # activations/conv compute dtype; params stay float32
    compute_dtype: str = "bfloat16"
    # model-specific keyword overrides (e.g. ViT widths, depth and
    # attention_layout), passed to the model's constructor
    extra: Mapping[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class OptimConfig:
    base_lr: float = 0.01              # LR at reference batch size, scaled linearly
    reference_batch_size: int = 256    # batch size base_lr was tuned at
    momentum: float = 0.9              # SGD momentum coefficient
    nesterov: bool = False             # Nesterov lookahead instead of classical momentum
    weight_decay: float = 5e-4         # L2-in-loss (coupled, TF semantics)
    schedule: str = "step"             # "step" | "cosine" | "constant"
    # step schedule: multiply LR by `decay_factor` at each boundary (epochs)
    decay_epochs: Sequence[float] = (30.0, 60.0, 80.0)
    decay_factor: float = 0.1          # per-boundary LR multiplier
    warmup_epochs: float = 0.0         # linear LR ramp from 0; 0 = none
    grad_clip_norm: float = 0.0        # global-norm clip; 0 disables


@dataclass(frozen=True)
class AugmentConfig:
    """On-device augmentation of the train step (data/augment.py; JAX
    `config.py:455–525`): flip, crop jitter, mixup or cutmix, and
    RandAugment-lite. Off by default; the flagship preset turns on the
    flip and mixup."""
    enabled: bool = False
    hflip: bool = True                 # per-image 50% horizontal flip
    # max |shift| in pixels of the per-image translation (edge pixels
    # replicate); 0 disables
    crop_jitter: int = 0
    mixup_alpha: float = 0.0           # Beta(alpha, alpha) mixup; 0 disables
    # Beta(alpha, alpha) cutmix; 0 disables. With mixup on too, each step
    # draws one of the two
    cutmix_alpha: float = 0.0
    # RandAugment-lite: op draws a round per image from {identity,
    # brightness, contrast, posterize}; 0 disables
    rand_ops: int = 0
    rand_magnitude: float = 0.5        # RandAugment-lite strength in [0, 1]

    def __post_init__(self):
        if self.crop_jitter < 0:
            raise ValueError(f"data.augment.crop_jitter must be >= 0, got "
                             f"{self.crop_jitter}")
        if self.mixup_alpha < 0 or self.cutmix_alpha < 0:
            raise ValueError(
                "data.augment.mixup_alpha and cutmix_alpha must be >= 0, "
                f"got {self.mixup_alpha}/{self.cutmix_alpha}")
        if self.rand_ops < 0:
            raise ValueError(
                f"data.augment.rand_ops must be >= 0, got {self.rand_ops}")
        if not 0.0 <= self.rand_magnitude <= 1.0:
            raise ValueError(
                f"data.augment.rand_magnitude must be in [0, 1], got "
                f"{self.rand_magnitude}")

    @property
    def owns_hflip(self) -> bool:
        """True when the device owns the horizontal flip: the predicate
        the host decoder reads before it flips."""
        return self.enabled and self.hflip

    def describe(self) -> dict:
        """The train record's `augment` block (JAX `config.py:499`)."""
        return {"enabled": self.enabled, "hflip": self.hflip,
                "crop_jitter": self.crop_jitter,
                "mixup_alpha": self.mixup_alpha,
                "cutmix_alpha": self.cutmix_alpha,
                "rand_ops": self.rand_ops,
                "rand_magnitude": self.rand_magnitude,
                "host_flips_disabled": self.owns_hflip}


@dataclass(frozen=True)
class SnapshotCacheConfig:
    """The decoded-crop snapshot cache (data/snapshot_cache.py; JAX
    `config.py:43–75`): the first pass writes each item's crop as the
    native loader shipped it to a bounded on-disk store keyed by the
    source set, the decode parameters and the native ABI; once every item
    is there, batches come from the store and libjpeg never runs. A
    complete store serves the next run from batch 0. Warm epochs re-serve
    the first pass's crop geometry, so it is a lever for decode-bound
    hosts, not a default. Warm reads are always crc32-checked: JAX's
    `validate` switch is refused (`UNPORTED_KEYS`). Counters:
    prefetch/snapshot_{hits,misses,bytes}."""
    enabled: bool = False   # opt-in: a throughput lever for decode-bound hosts
    # Store directory; "" places it under <data_dir>/.dvggf_snapshot.
    dir: str = ""
    # On-disk budget. Writes stop (and the cache never turns warm) rather
    # than exceed it; stale parameter generations are evicted first.
    capacity_bytes: int = 8 << 30

    def __post_init__(self):
        if self.capacity_bytes <= 0:
            raise ValueError(
                f"data.snapshot_cache.capacity_bytes must be > 0, got "
                f"{self.capacity_bytes}")


@dataclass(frozen=True)
class AutotuneConfig:
    """The closed-loop ingest autotuner (data/autotune.py; JAX
    `config.py:77–158`): a per-process controller that reads each log
    window's stall verdict and steers the decode threads, the host
    read-ahead depth and the device ring. Off by default; the flagship
    preset turns it on; DVGGF_AUTOTUNE=0 turns it off whatever this says.
    The controller's settings and rails are data/autotune.py's constants,
    JAX's defaults: a `--set` of one raises (`UNPORTED_KEYS`)."""
    enabled: bool = False   # off by default; the flagship preset turns it on


@dataclass(frozen=True)
class DataConfig:
    """The data fields serving, the training step and the trainer's feed
    read: the source (`build_dataset`: "synthetic" seeded u8 batches or
    "imagenet" TFRecords through the native decoder), the payload size,
    the batch and epoch geometry the schedule derives from, the device
    finish's normalize constants and output dtype, the packed stem layout,
    the on-device augmentation, the autotuner and the snapshot cache."""
    # the train stream's source (data.build_dataset): "synthetic" |
    # "imagenet"; another name (the JAX presets' "teacher") raises there
    name: str = "synthetic"
    data_dir: str = ""       # imagenet: the directory of train-*/validation-*
    # native decode threads a loader; 0 = min(8, the host's CPUs)
    native_threads: int = 0
    image_size: int = 224    # square input resolution (the u8 payload side)
    global_batch_size: int = 256          # the optimizer's batch
    num_train_examples: int = 1_281_167   # ImageNet-1k default
    # eval split size (ImageNet-1k val): an infinite eval stream draws
    # num_eval_examples // global_batch_size batches
    num_eval_examples: int = 50_000
    # dtype the device finish emits ("float32" | "bfloat16"); the model
    # casts to its compute dtype downstream either way
    image_dtype: str = "float32"
    mean_rgb: Sequence[float] = IMAGENET_MEAN_RGB
    stddev_rgb: Sequence[float] = IMAGENET_STDDEV_RGB  # see mean_rgb
    # train batches reach the VGG-F stem 4x4-packed (S/4, S/4, 48), packed
    # after the augmentation (finish -> augment -> space-to-depth)
    space_to_depth: bool = False
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    autotune: AutotuneConfig = field(default_factory=AutotuneConfig)
    snapshot_cache: SnapshotCacheConfig = field(
        default_factory=SnapshotCacheConfig)

    def __post_init__(self):
        if self.native_threads < 0:
            raise ValueError(f"data.native_threads must be >= 0, got "
                             f"{self.native_threads}")


@dataclass(frozen=True)
class ElasticConfig:
    """Live elastic resize on preemption: not ported (ROADMAP A13b); the
    trainer refuses `enabled=True`."""
    enabled: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """The gradient exchange over the data-parallel process group
    (train/step.py, parallel/buckets.py, parallel/zero.py). One process
    drives one card; the group's size is the shard count N, and with
    N = 1 the trainer downgrades ZeRO to replicated SGD."""
    # ZeRO-1: the optimizer state (momentum) held as 1/N flat shards
    shard_opt_state: bool = False
    # ZeRO-2: gradient state held only as 1/N flat shards as well — each
    # bucket's reduce-scatter consumes its gradients as they land, and
    # under grad accumulation the accumulator is the 1/N shard. Without
    # shard_opt_state there is no shard to hold it, and it downgrades
    shard_gradients: bool = False
    # ZeRO-3: the params (and their EMA) held only as 1/N flat shards,
    # gathered just in time by the step, one all-gather a bucket
    shard_params: bool = False
    # bucketed exchange: buckets of ~this many MB in reverse-backward
    # order, each issued as its gradients exist; 0 = one exchange per leaf
    # (DP) or one flat reduce-scatter (ZeRO)
    comm_bucket_mb: float = 0.0
    # gradient wire dtype ("float32" | "bfloat16"): the cast happens after
    # the local backward and before the cross-replica mean; momentum,
    # params and ZeRO-1/2's param all-gather stay fp32, and ZeRO-3's
    # just-in-time gather (a transient of one step) rides this wire too
    reduce_dtype: str = "float32"
    elastic: ElasticConfig = field(default_factory=ElasticConfig)

    def __post_init__(self):
        if self.reduce_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"mesh.reduce_dtype {self.reduce_dtype!r} not "
                             "one of ('float32', 'bfloat16')")
        if self.comm_bucket_mb < 0:
            raise ValueError(
                f"mesh.comm_bucket_mb {self.comm_bucket_mb} < 0 (0 = "
                "single-bucket kill-switch, >0 = bucket size target)")
        if self.shard_params and not self.shard_gradients:
            raise ValueError(
                "mesh.shard_params (ZeRO-3) requires mesh.shard_gradients "
                "(ZeRO-2) — the sharding ladder is cumulative")

    @property
    def sharding_label(self) -> str:
        """The CONFIGURED (dp | zero1 | zero2 | zero3) basis, through the
        derivation the step's `comm_meta` uses (parallel/buckets.py
        sharding_basis). The step reports the EFFECTIVE basis, which a
        one-process run downgrades to dp."""
        from distributed_vgg_f_tpu_torch.parallel.buckets import \
            sharding_basis
        zero1 = self.shard_opt_state
        zero2 = zero1 and self.shard_gradients
        return sharding_basis(zero1, zero2, zero2 and self.shard_params)


@dataclass(frozen=True)
class TrainConfig:
    """The fields the train step, the core loop, its checkpoints, eval
    cadence, best slot and preemption read."""
    epochs: float = 90.0               # training length (fractional allowed)
    steps: int = 0                     # if > 0 overrides epochs
    seed: int = 0                      # params, augmentation and dropout
    log_every: int = 100               # steps between train records
    eval_every_steps: int = 0          # 0 = once per epoch
    checkpoint_every_steps: int = 1000 # durable-save cadence (also saves at run end)
    checkpoint_dir: str = ""           # "" disables checkpointing entirely
    keep_checkpoints: int = 3          # retained durable steps; older ones are pruned
    # Non-finite step skip: a step whose loss or gradient norm is not
    # finite leaves params, momentum, the optimizer's count and the EMA
    # unchanged (the step counter still advances); NonFiniteGuard aborts
    # after max_nonfinite_steps consecutive skips.
    skip_nonfinite: bool = True
    max_nonfinite_steps: int = 10
    # micro-batching: each rank's batch is split into k micro-batches whose
    # gradients accumulate before the one exchange of the step
    grad_accum_steps: int = 1
    # ZeRO-flavoured accumulation (needs mesh.shard_opt_state and
    # grad_accum_steps > 1; the trainer checks): each micro-gradient is
    # reduce-scattered at once and only the 1/N shard accumulates, at k
    # scatter legs a step instead of one
    grad_accum_shard: bool = False
    ema_decay: float = 0.0             # param EMA; 0 disables
    # The trainer-owned feed (fit without a dataset): device batches kept
    # ahead of the step by the prefetch thread (data/prefetch.py).
    prefetch_to_device: int = 2
    # Data watchdog of the prefetch thread: each batch waits at most
    # data_timeout_s, retried data_timeout_retries times with the wait
    # doubling, then DataStallError; 0 disables the timeout (a dead worker
    # is detected regardless).
    data_timeout_s: float = 0.0
    data_timeout_retries: int = 2
    # Keep the best eval_top1 checkpoint in one slot under
    # <checkpoint_dir>/best, replaced whenever an eval of the cadence sets
    # a new best (the score in its metrics.json).
    track_best_eval: bool = True
    # Restore the best slot (chosen by its recorded score) instead of the
    # latest checkpoint: for eval and predict on the best model, or to
    # branch training from it (the steps ahead of it are deleted). Without
    # a best slot the latest is restored, with a logged notice.
    restore_from_best: bool = False
    # On SIGTERM, finish the step in flight, force a checkpoint and return
    # cleanly. A process group stops every rank at the same step, within
    # 3 steps of the signal (parallel/preempt.py).
    handle_preemption: bool = True

    def __post_init__(self):
        if self.grad_accum_steps < 1:
            raise ValueError(f"train.grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum_steps}")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(
                f"train.ema_decay must be in [0, 1), got {self.ema_decay}")
        if self.max_nonfinite_steps < 1:
            raise ValueError(f"train.max_nonfinite_steps must be >= 1, got "
                             f"{self.max_nonfinite_steps}")
        if self.prefetch_to_device < 1:
            raise ValueError(f"train.prefetch_to_device must be >= 1, got "
                             f"{self.prefetch_to_device}")
        if self.data_timeout_s < 0 or self.data_timeout_retries < 0:
            raise ValueError(
                "train.data_timeout_s and data_timeout_retries must be >= 0, "
                f"got {self.data_timeout_s}/{self.data_timeout_retries}")


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


#: The serving tier ladder, in descending-fidelity order: the router's
#: `?tier=` vocabulary (serving/tiers.py `TIERS`).
SERVING_TIERS = ("fp32", "bf16", "int8", "student")


@dataclass(frozen=True)
class ServingTiersConfig:
    """Latency-tiered serving (serving/tiers.py): per-tier engines behind
    the one router — `bf16` (params cast once at build, bf16 activations,
    fp32 logits), `int8` (per-out-channel symmetric int8 weights of the FC
    heads, per-tensor activation scales from a calibration pass over the
    u8 wire; channels below half an activation LSB are elided) and
    `student` (the half-width `vggf_student` distilled by
    train/distill.py). `enabled=false` is the kill switch: the router
    never parses `?tier=`, /v1/models carries no ladder, and the server
    holds fp32 engines only. JAX's per-tier accuracy contract
    (`max_top1_delta_*`) is refused (`UNPORTED_KEYS`): nothing reads it
    until the accuracy receipt (ROADMAP A16)."""
    # Kill switch: off = fp32-only server.
    enabled: bool = False
    # Batches of u8 wire images the int8 calibration pass runs.
    calibration_batches: int = 4
    # Images per calibration batch.
    calibration_batch_size: int = 8
    # Seed of the calibration stream: part of the calibration receipt, so
    # a re-run reproduces the ranges.
    calibration_seed: int = 0

    def __post_init__(self):
        if self.calibration_batches < 1 or self.calibration_batch_size < 1:
            raise ValueError(
                "serving.tiers calibration needs >= 1 batches of >= 1 "
                f"images, got {self.calibration_batches}/"
                f"{self.calibration_batch_size}")


@dataclass(frozen=True)
class ServingConfig:
    """The dynamic-batching predict server: a stdlib-HTTP front end fed raw
    u8 payloads, a bounded admission queue with max-latency and max-batch
    flush, one warm engine geometry per batch bucket, typed overload
    behaviour (503 shed, never unbounded latency), an admission controller
    over the batch window and the tier ladder. Off by default: `--mode
    serve` refuses to start without `enabled=true`."""
    # Kill switch of `--mode serve`: off = the CLI starts no server.
    enabled: bool = False
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
    # for company before a partial batch flushes. The controller's knob
    # baseline.
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
    # Admission controller (serving/controller.py: the ingest autotuner
    # over the batch-window knob, steered by queue-pressure verdicts).
    controller: bool = True
    # Hard rails of the controller's admission-window knob (ms).
    window_min_ms: float = 1.0
    window_max_ms: float = 100.0   # see window_min_ms
    # Seconds between controller windows (verdicts and gauges).
    controller_interval_s: float = 2.0
    # Consecutive pressure windows before the controller widens the window.
    controller_k_windows: int = 3
    # Quiet windows after an actuation before the next may fire.
    controller_cooldown_windows: int = 2
    # Sustained steady windows before a controller-raised window steps
    # back down toward max_latency_ms (0 disables relaxation).
    controller_relax_after_windows: int = 4
    # Queue peak (as a fraction of queue_limit) that reads as pressure
    # even before anything sheds.
    queue_pressure_fraction: float = 0.5
    # Tier a request lands on when it carries no `?tier=`. Ignored (fp32)
    # while serving.tiers.enabled is false.
    tier_default: str = "fp32"
    # The latency tier ladder: see ServingTiersConfig.
    tiers: ServingTiersConfig = field(default_factory=ServingTiersConfig)

    def __post_init__(self):
        if self.tier_default not in SERVING_TIERS:
            raise ValueError(
                f"serving.tier_default {self.tier_default!r} not one of "
                f"{SERVING_TIERS}")
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
        if not 0 < self.window_min_ms <= self.window_max_ms:
            raise ValueError(
                f"serving window rails need 0 < window_min_ms <= "
                f"window_max_ms, got {self.window_min_ms}/"
                f"{self.window_max_ms}")
        if not self.window_min_ms <= self.max_latency_ms \
                <= self.window_max_ms:
            raise ValueError(
                f"serving.max_latency_ms {self.max_latency_ms} outside the "
                f"controller rails [{self.window_min_ms}, "
                f"{self.window_max_ms}] — the knob baseline must be "
                "reachable")
        if self.controller_interval_s <= 0:
            raise ValueError(
                f"serving.controller_interval_s must be > 0, got "
                f"{self.controller_interval_s}")
        if self.controller_k_windows < 1 \
                or self.controller_cooldown_windows < 0 \
                or self.controller_relax_after_windows < 0:
            raise ValueError(
                "serving controller needs k_windows >= 1 and non-negative "
                "cooldown/relax windows, got "
                f"{self.controller_k_windows}/"
                f"{self.controller_cooldown_windows}/"
                f"{self.controller_relax_after_windows}")
        if not 0 < self.queue_pressure_fraction <= 1:
            raise ValueError(
                f"serving.queue_pressure_fraction must be in (0, 1], got "
                f"{self.queue_pressure_fraction}")
        if self.shed_retry_after_ms < 0:
            raise ValueError(
                f"serving.shed_retry_after_ms must be >= 0, got "
                f"{self.shed_retry_after_ms}")


@dataclass(frozen=True)
class ExperimentConfig:
    """The config-tree root: one section per subsystem the port reads."""
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.data.num_train_examples
                   // self.data.global_batch_size)

    @property
    def total_steps(self) -> int:
        if self.train.steps > 0:
            return self.train.steps
        return int(self.train.epochs * self.steps_per_epoch)

    @property
    def scaled_lr(self) -> float:
        """Linear LR scaling with the global batch."""
        return self.optim.base_lr * (self.data.global_batch_size
                                     / self.optim.reference_batch_size)


#: Datasets whose host pipeline implements the packed stem layout.
SPACE_TO_DEPTH_DATASETS = frozenset({"synthetic", "imagenet"})


def supports_space_to_depth(model_name: str, image_size: int,
                            dataset_name: Optional[str] = None) -> bool:
    """Whether a config may set `data.space_to_depth` (JAX
    `config.py:1099`): the model's ingest descriptor packs, the image
    side is a multiple of 4 and, with `dataset_name`, its pipeline packs
    too. The trainer refuses the flag otherwise."""
    from distributed_vgg_f_tpu_torch.models.ingest import ingest_descriptor
    return ingest_descriptor(model_name).space_to_depth \
        and image_size % 4 == 0 and (
            dataset_name is None or dataset_name in SPACE_TO_DEPTH_DATASETS)


def zoo_data(base: DataConfig, model_name: str) -> DataConfig:
    """One zoo preset's data section derived from `base` through the
    model's ingest descriptor (JAX `config.py:1114`): the packed layout
    and the normalize constants come from models/ingest.py. The wire is
    the descriptor's too; the port feeds the u8 wire only (ROADMAP A17),
    which every zoo descriptor names."""
    from distributed_vgg_f_tpu_torch.models.ingest import ingest_descriptor
    d = ingest_descriptor(model_name)
    if d.wire != "u8":
        raise ValueError(f"{model_name}'s ingest descriptor ships the "
                         f"{d.wire!r} wire; the port feeds u8 only "
                         "(ROADMAP A17)")
    return replace(base, space_to_depth=d.space_to_depth,
                   mean_rgb=tuple(d.mean_rgb),
                   stddev_rgb=tuple(d.stddev_rgb))


def _vggf_imagenet_dp() -> ExperimentConfig:
    """The flagship: VGG-F on ImageNet-1k at 224 px, bf16 compute with
    fp32 params, global batch 1024, step LR at 30/60/80 epochs, flips and
    mixup on the device, the packed stem layout, ZeRO-2 with 4 MB buckets
    (downgraded to replicated SGD on one process), served on the
    power-of-two ladder up to 32. Its train stream is ImageNet's TFRecords
    under `data.data_dir` through the native decoder on the u8 wire, its
    ingest steered by the autotuner (data/autotune.py), as JAX's preset
    is."""
    return ExperimentConfig(
        name="vggf_imagenet_dp",
        model=ModelConfig(name="vggf", num_classes=1000),
        optim=OptimConfig(base_lr=0.01, reference_batch_size=256,
                          weight_decay=5e-4,
                          decay_epochs=(30.0, 60.0, 80.0)),
        data=zoo_data(
            DataConfig(name="imagenet", image_size=224,
                       global_batch_size=1024,
                       augment=AugmentConfig(enabled=True, hflip=True,
                                             mixup_alpha=0.2),
                       autotune=AutotuneConfig(enabled=True)),
            "vggf"),
        mesh=MeshConfig(shard_opt_state=True, shard_gradients=True,
                        comm_bucket_mb=4.0),
        train=TrainConfig(epochs=90.0),
        serving=ServingConfig())


def _vggf_teacher() -> ExperimentConfig:
    """The JAX package's offline generalization preset, at 32 px and 10
    classes: fp32 compute, dropout 0.2, warmup, clipping. The port's CPU
    trajectory tests train it on seeded batches they pass to `fit`: the
    teacher task's train stream is data/teacher.py, but its
    `build_dataset` entry (`build_teacher`, with the eval split) waits
    for ROADMAP A17, so `fit` without a dataset raises."""
    return ExperimentConfig(
        name="vggf_teacher",
        model=ModelConfig(name="vggf", num_classes=10,
                          compute_dtype="float32", dropout_rate=0.2),
        optim=OptimConfig(base_lr=0.02, reference_batch_size=64,
                          weight_decay=5e-5, warmup_epochs=1.0,
                          grad_clip_norm=1.0, decay_epochs=(24.0, 30.0)),
        data=DataConfig(name="teacher", image_size=32,
                        global_batch_size=64, num_train_examples=4096,
                        num_eval_examples=1024),
        train=TrainConfig(epochs=32.0, log_every=64, eval_every_steps=256))


def _vit_s16_imagenet() -> ExperimentConfig:
    """ViT-S/16 on ImageNet-1k: the flagship's data (batch 1024, flips and
    mixup on the device) without the packed stem, dropout 0.1 (attention
    weights: 0), SGD with momentum at 1e-3 per 1024 images on a cosine
    schedule after 5 warmup epochs, 300 epochs. The attention layout is
    the model's default, head_major, as in the JAX preset; the flash path
    passes ``extra={"attention_layout": "flash"}``. The mesh is the
    flagship's (ZeRO-2, 4 MB buckets): the preset replaces its base, as
    the JAX one does."""
    base = _vggf_imagenet_dp()
    return replace(
        base,
        name="vit_s16_imagenet",
        model=ModelConfig(name="vit_s16", num_classes=1000,
                          dropout_rate=0.1),
        optim=OptimConfig(base_lr=1e-3, reference_batch_size=1024,
                          momentum=0.9, weight_decay=1e-4,
                          schedule="cosine", warmup_epochs=5.0),
        data=zoo_data(base.data, "vit_s16"),
        train=TrainConfig(epochs=300.0))


def _vgg16_imagenet() -> ExperimentConfig:
    """VGG-16 on ImageNet-1k (BASELINE config #3: the deeper conv stack on
    the flagship's data-parallel path): the flagship with VGG-16, its own
    step LR (0.01 per 256 images after 2 warmup epochs) and its ingest
    descriptor's data (the plain (S, S, 3) layout, no packing)."""
    base = _vggf_imagenet_dp()
    return replace(
        base,
        name="vgg16_imagenet",
        model=ModelConfig(name="vgg16", num_classes=1000),
        optim=OptimConfig(base_lr=0.01, reference_batch_size=256,
                          weight_decay=5e-4,
                          decay_epochs=(30.0, 60.0, 80.0),
                          warmup_epochs=2.0),
        data=zoo_data(base.data, "vgg16"))


def _resnet50_imagenet() -> ExperimentConfig:
    """ResNet-50 on ImageNet-1k with cross-replica sync-BN (BASELINE
    config #4): the flagship with ResNet-50 (no dropout), 0.1 per 256
    images after 5 warmup epochs, L2 1e-4 and its ingest descriptor's
    data."""
    base = _vggf_imagenet_dp()
    return replace(
        base,
        name="resnet50_imagenet",
        model=ModelConfig(name="resnet50", num_classes=1000,
                          dropout_rate=0.0),
        optim=OptimConfig(base_lr=0.1, reference_batch_size=256,
                          weight_decay=1e-4,
                          decay_epochs=(30.0, 60.0, 80.0),
                          warmup_epochs=5.0),
        data=zoo_data(base.data, "resnet50"))


PRESETS = {"vggf_imagenet_dp": _vggf_imagenet_dp,
           "vggf_teacher": _vggf_teacher,
           "vgg16_imagenet": _vgg16_imagenet,
           "resnet50_imagenet": _resnet50_imagenet,
           "vit_s16_imagenet": _vit_s16_imagenet}


def get_config(name: str) -> ExperimentConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(PRESETS)}") from None


# ------------------------------------------------------------ the overrides
#: Dotted keys of the JAX package's config that the port has not (yet):
#: each prefix with the reason a `--set` of it raises. A key neither
#: here nor in the port's tree raises as unknown.
UNPORTED_KEYS = (
    ("telemetry.", "the telemetry planes (TelemetryConfig) wait for "
                   "ROADMAP A14"),
    ("data.service.", "the ingest service client waits for ROADMAP A14"),
    ("data.snapshot_cache.validate", "warm reads are always crc32-checked; "
                                     "a switch to serve unchecked bytes "
                                     "waits for a deployment that needs it "
                                     "(ROADMAP A14b)"),
    ("train.tensorboard_dir", "TensorBoard is not ported: the card's host "
                              "has no tensorflow or tensorboard package "
                              "(ROADMAP A14)"),
    ("train.profile", "the step profiler waits for ROADMAP A14"),
    ("train.fault_injection", "the fault tokens wait for ROADMAP A14"),
    ("data.wire", "the port feeds the u8 wire only; the host wires wait "
                  "for ROADMAP A17"),
    ("data.backend", "the tf.data and grain backends wait for ROADMAP "
                     "A17"),
    ("data.native_jpeg", "the port always decodes natively; the other "
                         "backends wait for ROADMAP A17"),
    ("data.grain_workers", "the grain backend waits for ROADMAP A17"),
    ("data.shuffle_buffer", "the tf.data backend waits for ROADMAP A17"),
    ("data.eval_index_base", "the imagefolder layout waits for ROADMAP "
                             "A17"),
    ("data.val_labels_file", "the imagefolder layout waits for ROADMAP "
                             "A17"),
    ("mesh.elastic.", "elastic resize waits for ROADMAP A13b"),
    ("mesh.num_data", "JAX-specific: the port's shard count is the "
                      "process group's size"),
    ("mesh.data_axis", "JAX-specific: the port's data axis is the process "
                       "group"),
    ("train.debug_nans", "JAX-specific (jax_debug_nans); the port skips "
                         "non-finite steps through train.skip_nonfinite"),
    ("train.checkpoint_save_retries", "the writer's retry budget is "
                                      "checkpoint/manager.py SAVE_RETRIES "
                                      "(2, JAX's default) until a "
                                      "deployment needs another (ROADMAP "
                                      "A14)"),
    ("train.resume_data_fast_forward", "a resume always replays a source "
                                       "that cannot seek, so it trains on "
                                       "the uninterrupted stream (ROADMAP "
                                       "A14)"),
    ("data.autotune.", "the autotuner's settings and rails are "
                       "data/autotune.py's constants (JAX's defaults) "
                       "until a deployment needs another (ROADMAP A14b)"),
    ("data.prefetch", "the host read-ahead starts at data/autotune.py "
                      "HOST_PREFETCH (2, JAX's default) until a "
                      "deployment needs another (ROADMAP A14b)"),
    ("data.iterator_state.", "every checkpoint carries the iterator blob "
                             "and every resume reads it (ROADMAP A14)"),
    ("train.dropout_rng_impl", "JAX-specific (the PRNG implementation); "
                               "the port's dropout draws from torch "
                               "generators"),
    ("serving.tiers.max_top1_delta", "the per-tier accuracy contract is "
                                     "read by the accuracy receipt, which "
                                     "waits for ROADMAP A16"),
)

_BOOL_WORDS = {"true": True, "1": True, "yes": True, "on": True,
               "false": False, "0": False, "no": False, "off": False}


def _coerce_override(current: Any, value: Any) -> Any:
    """A CLI override string cast to the type of the field it replaces:
    bool before int (bool is an int subclass) and never through
    ``bool(str)``; sequences from comma-separated values typed like their
    current elements (``optim.decay_epochs=20,40`` -> ``(20.0, 40.0)``)."""
    if current is None:
        return value
    same_boolness = isinstance(value, bool) == isinstance(current, bool)
    if isinstance(value, type(current)) and same_boolness:
        return value
    if isinstance(current, bool):
        word = str(value).strip().lower()
        if word not in _BOOL_WORDS:
            raise ValueError("boolean override needs true/false/1/0/yes/no/"
                             f"on/off, got {value!r}")
        return _BOOL_WORDS[word]
    if isinstance(current, (int, float)):
        return type(current)(value)
    if isinstance(current, str):
        return str(value)
    if isinstance(current, Sequence) and not isinstance(current,
                                                        (str, bytes)):
        elem_type = type(current[0]) if len(current) else str
        if isinstance(value, str):
            return tuple(elem_type(v.strip()) for v in value.split(",")
                         if v.strip())
        if not isinstance(value, Sequence):
            value = (value,)
        return tuple(elem_type(v) for v in value)
    return value


def _parse_literal(value: Any) -> Any:
    """Typing for a dict entry with no current value to mirror (a fresh
    ``model.extra`` key): numbers first ("1" and "0" stay ints), then the
    word bools, then the raw string."""
    if not isinstance(value, str):
        return value
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    word = value.strip().lower()
    if word in _BOOL_WORDS:
        return _BOOL_WORDS[word]
    return value


def _refuse(path: str) -> KeyError:
    for prefix, why in UNPORTED_KEYS:
        if path == prefix or (prefix.endswith(".")
                              and path.startswith(prefix)) \
                or path.startswith(prefix + "_"):
            return KeyError(f"config key {path!r} is not in the port: {why}")
    return KeyError(f"unknown config key {path!r}")


def _set_path(obj: Any, parts: Sequence[str], value: Any,
              done: str = "") -> Any:
    """Immutably set a dotted path through dataclasses and Mappings
    (``model.extra.<key>`` descends into the dict)."""
    name = parts[0]
    path = done + name
    if isinstance(obj, Mapping):
        current = obj.get(name)
        if len(parts) == 1:
            new_leaf = (_parse_literal(value) if current is None
                        or isinstance(current, Mapping)
                        else _coerce_override(current, value))
            return {**obj, name: new_leaf}
        if current is None:
            raise KeyError(
                f"cannot descend into missing dict key {name!r} "
                f"(remaining path: {'.'.join(parts[1:])})")
        return {**obj, name: _set_path(current, parts[1:], value,
                                       path + ".")}
    if not dataclasses.is_dataclass(obj) or name not in {
            f.name for f in dataclasses.fields(obj)}:
        raise _refuse(done + ".".join(parts))
    current = getattr(obj, name)
    if len(parts) == 1:
        if not isinstance(current, Mapping):
            value = _coerce_override(current, value)
        return dataclasses.replace(obj, **{name: value})
    return dataclasses.replace(
        obj, **{name: _set_path(current, parts[1:], value, path + ".")})


def apply_overrides(cfg: ExperimentConfig,
                    overrides: Mapping[str, Any]) -> ExperimentConfig:
    """Dotted-path overrides, e.g. ``{"data.global_batch_size": 512}``.
    A key of the JAX package's config the port has not raises KeyError
    naming its ROADMAP item; an unknown key raises KeyError."""
    for path, value in overrides.items():
        cfg = _set_path(cfg, path.split("."), value)
    return cfg


def fold_override_items(items: Optional[Sequence[str]]) -> dict:
    """``--set KEY=VALUE`` entries -> the dict `apply_overrides` takes;
    an item without ``=`` or without a key raises ValueError."""
    overrides = {}
    for item in items or ():
        key, sep, value = item.partition("=")
        if not sep or not key:
            raise ValueError(f"override needs KEY=VALUE, got {item!r}")
        overrides[key] = value
    return overrides


def parse_cli(argv: Optional[Sequence[str]] = None, *,
              with_mode: bool = False):
    """The port's command line (cli.py): ``--config`` (a port preset;
    the default is the flagship, `vggf_imagenet_dp`: the JAX package's
    default, `vggf_cifar10_smoke`, is not a port preset until ROADMAP
    A17), repeated ``--set KEY=VALUE``, ``--mode`` and ``--images``.
    Returns the config, or (config, args) with `with_mode`. A malformed
    item exits through the parser; an unported or unknown key raises
    KeyError."""
    parser = argparse.ArgumentParser(
        description="distributed_vgg_f_tpu_torch trainer")
    parser.add_argument("--config", default="vggf_imagenet_dp",
                        help=f"preset name, one of {sorted(PRESETS)}")
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="dotted override, e.g. --set "
                             "data.global_batch_size=512")
    parser.add_argument("--mode",
                        choices=("train", "eval", "predict", "serve"),
                        default="train",
                        help="train (default), eval: one exact pass over "
                             "the validation split from the latest "
                             "checkpoint, predict: classify --images with "
                             "it, serve: the always-on predict server over "
                             "it (needs serving.enabled=true)")
    parser.add_argument("--images", nargs="*", default=[], metavar="PATH",
                        help="predict mode: JPEG files and/or directories "
                             "(searched for *.jpg/*.jpeg/*.JPEG), or .npy "
                             "u8 (S, S, 3) arrays")
    args = parser.parse_args(argv)
    cfg = get_config(args.config)
    try:
        cfg = apply_overrides(cfg, fold_override_items(args.set))
    except ValueError as e:
        parser.error(str(e))
    return (cfg, args) if with_mode else cfg

"""The core training loop — the counterpart of the JAX package's
``train/trainer.py Trainer`` without its planes.

`Trainer(cfg, device=None)` builds the device finish, the augment stage
and the train and eval steps for `cfg` on this process's device (CUDA
unless `device="cpu"`). With a process group up (parallel/distributed.py
`initialize_distributed`; NCCL, one card a process, or gloo on the CPU)
each process is one replica of N: its dataset yields its local
`global_batch_size / N` rows (the JAX multi-host convention), the step
exchanges gradients over the group with the config's mesh (ZeRO-1/2,
buckets, the wire; train/step.py), and the meter counts the global
batch. On one process ZeRO downgrades to replicated SGD, as the JAX
trainer does on a one-shard mesh: `zero1 = shard_opt_state and N > 1`.
`init_state(seed)` builds a model with seeded params
(weights.init_params) on that device, its optimizer (over this rank's
flat shard under ZeRO) and the optional EMA — each state owns its model;
`restore_or_init()` restores the newest intact checkpoint of
`train.checkpoint_dir` into such a state, or returns it fresh; `fit`
(from `restore_or_init()` when given no state) runs the
steps from `state.step` to `num_steps`, feeding the NonFiniteGuard and the
throughput meter, and writes one train record at every `log_every`
window and at the last step, with the reference's keys: `step`, the step
metrics, the meter's rates, `host_wait_fraction`, `nonfinite_skips`
once there are any and `data_decode_errors` once the decoder has
counted any. `evaluate` scores `num_batches` eval batches.

The feed (JAX `trainer.py:880–985`, in its order): `fit(state)` with no
dataset builds the trainer-owned one with `open_feed` — the
`ResumableIngest` over `build_dataset` (data.name: ImageNet TFRecords
through the native decoder, or seeded batches), seeked to `state.step`
(through the restored checkpoint's iterator blob when it has one, with
no batch replayed; replayed when the source cannot seek), then the
`DevicePrefetchIterator`
(train.prefetch_to_device batches ahead, the H2D copy on a side CUDA
stream, the data watchdog), all closed when `fit` returns. A dataset the
caller passes is fed as it is, unprefetched. On either source the first
batch's labels are checked against the model head before its step.

Checkpoints (JAX `trainer.py:254–259, 428–576, 637–664, 1444–1456,
1556–1570`): with `train.checkpoint_dir` set, `self.checkpoints` (checkpoint/
manager.py) is offered the state after every step and keeps those at
`checkpoint_every_steps`, and the end of `fit` forces a save and
`wait()`s for it. Each save's `extra` holds `examples_seen`, the ZeRO-2
bucket receipt `opt_layout` and, on the trainer-owned feed, the
iterator blob. Under a process group every rank calls `save` and the
restore, which are collective; rank 0 writes.

Records go to `self.records` (as ``{"event": ..., **payload}``) and to
the optional `log(event, payload)` callable. The eval cadence and the
best slot, preemption, elastic resize and ZeRO-3, autotune, the
collector and the flight recorder are not ported yet (ROADMAP A10, A13,
A14).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Mapping, Optional

import torch

from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_vgg_f_tpu_torch.checkpoint.retopology import \
    restore_any_topology
from distributed_vgg_f_tpu_torch.config import ExperimentConfig
from distributed_vgg_f_tpu_torch.data import build_dataset
from distributed_vgg_f_tpu_torch.data.augment import make_device_augment
from distributed_vgg_f_tpu_torch.data.device_ingest import make_device_finish
from distributed_vgg_f_tpu_torch.data.iterator_state import (
    INGEST_LABEL, ResumableIngest, restore_from_blob)
from distributed_vgg_f_tpu_torch.data.prefetch import DevicePrefetchIterator
from distributed_vgg_f_tpu_torch.device import resolve_device
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.parallel.collectives import rank_and_size
from distributed_vgg_f_tpu_torch.parallel.zero import zero_layout
from distributed_vgg_f_tpu_torch.resilience.errors import \
    CheckpointIntegrityError
from distributed_vgg_f_tpu_torch.resilience.guard import NonFiniteGuard
from distributed_vgg_f_tpu_torch.telemetry import schema
from distributed_vgg_f_tpu_torch.train.schedule import (build_optimizer,
                                                        build_schedule)
from distributed_vgg_f_tpu_torch.train.state import TrainState
from distributed_vgg_f_tpu_torch.train.step import (build_eval_step,
                                                    build_train_step)
from distributed_vgg_f_tpu_torch.utils.meter import ThroughputMeter
from distributed_vgg_f_tpu_torch.weights import init_params, load_params


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device=None,
                 log: Optional[Callable[[str, dict], None]] = None):
        self.cfg = cfg
        self.device = resolve_device("cuda" if device is None else device)
        self._log = log
        self.records: list = []
        #: the trainer-owned train stream of the last `fit` without a
        #: dataset (closed when that fit returned; its decode_errors()
        #: stays readable)
        self.ingest = None
        mesh, k = cfg.mesh, cfg.train.grad_accum_steps
        if mesh.shard_params or mesh.elastic.enabled:
            raise NotImplementedError(
                "mesh.shard_params (ZeRO-3) and mesh.elastic are not ported "
                "yet (ROADMAP A13)")
        if cfg.train.grad_accum_shard and not (mesh.shard_opt_state
                                               and k > 1):
            raise ValueError(
                "train.grad_accum_shard requires mesh.shard_opt_state=true "
                "AND train.grad_accum_steps > 1")
        _, self.num_shards = rank_and_size()
        if cfg.data.global_batch_size % (self.num_shards * k):
            raise ValueError(
                f"data.global_batch_size {cfg.data.global_batch_size} does "
                f"not split over {self.num_shards} ranks x {k} micro-batches")
        self.local_batch_size = cfg.data.global_batch_size // self.num_shards
        # one shard: ZeRO has nothing to shard and runs as replicated SGD
        self.zero1 = mesh.shard_opt_state and self.num_shards > 1
        self.zero2 = self.zero1 and mesh.shard_gradients
        self.schedule = build_schedule(cfg)
        self.device_finish = make_device_finish(
            cfg.data.mean_rgb, cfg.data.stddev_rgb,
            image_dtype=cfg.data.image_dtype)
        self.device_augment = make_device_augment(
            cfg.data.augment, space_to_depth=cfg.data.space_to_depth)
        self.train_step = build_train_step(
            self.schedule, cfg.optim.weight_decay,
            grad_clip_norm=cfg.optim.grad_clip_norm,
            ema_decay=cfg.train.ema_decay,
            skip_nonfinite=cfg.train.skip_nonfinite,
            device_finish=self.device_finish,
            device_augment=self.device_augment,
            zero1=self.zero1, shard_gradients=self.zero2,
            comm_bucket_mb=mesh.comm_bucket_mb, grad_accum_steps=k,
            grad_accum_shard=cfg.train.grad_accum_shard and self.zero1,
            reduce_dtype=mesh.reduce_dtype, device=self.device)
        self.eval_step = build_eval_step(self.device_finish,
                                         device=self.device)
        # the iterator blob of the last restore, consumed by the next feed
        self._restored_iterator_state = None
        self.checkpoints: Optional[CheckpointManager] = None
        if cfg.train.checkpoint_dir:
            self.checkpoints = CheckpointManager(
                cfg.train.checkpoint_dir,
                max_to_keep=cfg.train.keep_checkpoints,
                save_interval_steps=cfg.train.checkpoint_every_steps)

    def log(self, event: str, payload: Mapping) -> None:
        self.records.append({"event": event, **payload})
        if self._log is not None:
            self._log(event, dict(payload))

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Seeded params (train.seed unless `seed` is given; the same on
        every rank), a fresh optimizer at count 0 (over this rank's flat
        shard under ZeRO), and the EMA when train.ema_decay > 0."""
        cfg = self.cfg
        seed = cfg.train.seed if seed is None else seed
        size = cfg.data.image_size
        return self._state_for(load_params(
            build_model(cfg.model, image_size=size),
            init_params(cfg.model, seed, image_size=size)))

    def _state_for(self, model: torch.nn.Module) -> TrainState:
        """`model`, moved to this trainer's device, with a fresh optimizer
        (over this rank's flat shard under ZeRO) and the EMA."""
        cfg = self.cfg
        model.to(self.device)
        ema = cfg.train.ema_decay > 0.0
        if self.zero1:
            return TrainState.create_sharded(
                model, lambda params: build_optimizer(cfg, params)[0],
                zero_layout(model, self.num_shards, cfg.mesh.comm_bucket_mb),
                ema=ema)
        opt, _ = build_optimizer(cfg, model.parameters())
        return TrainState.create(model, opt, ema=ema)

    # ------------------------------------------------------------ checkpoint
    def restore_or_init(self) -> TrainState:
        """The newest INTACT checkpoint of `train.checkpoint_dir` restored
        into a new state, or `init_state()` when there is none, in this
        run's layout (checkpoint/retopology.py: replicated or ZeRO, any
        shard count). A damaged newest step falls back to the newest
        intact one (`checkpoint_integrity_fallback` logged); checkpoints
        on disk with none intact raise CheckpointIntegrityError, never a
        silent fresh start. Collective under a process group."""
        self._restored_iterator_state = None
        source = self.checkpoints
        if source is not None:
            source.wait()   # every rank sees the same committed steps
        if source is None or source.latest_step() is None:
            return self.init_state()
        step = _agreed(source.best_step())
        if step is None:
            raise CheckpointIntegrityError(
                "checkpoints exist under the configured directory but none "
                "passed integrity verification "
                f"({(source.last_integrity_fallback or {}).get('skipped')})"
                " — refusing to train from scratch over a damaged run; "
                "restore the directory from a replica/backup or clear it to "
                "restart deliberately")
        if source.last_integrity_fallback is not None:
            self.log("checkpoint_integrity_fallback",
                     source.last_integrity_fallback)
        # no seeded draw: every value comes from the checkpoint
        state = self._state_for(build_model(
            self.cfg.model, image_size=self.cfg.data.image_size))
        state, extra, ema_event = restore_any_topology(source, state, step)
        self._restored_iterator_state = extra.get("iterator_state")
        if ema_event is not None:
            self.log(ema_event, {"step": state.step})
        self.log("restore", {"step": state.step, "best": False})
        return state

    def _opt_layout_extra(self, state: TrainState) -> dict:
        """The ZeRO-2 bucket receipt: a bucket-major flat momentum cannot
        be told from the canonical one by its shape, so every checkpoint of
        the bucketed ZeRO exchange carries its geometry (absent = the
        canonical layout)."""
        if state.layout is not None and state.layout.bucket_bytes > 0:
            return {"opt_layout": state.layout.describe()}
        return {}

    def _save_extra(self, state: TrainState, next_step: int,
                    ingest: Optional[ResumableIngest]) -> dict:
        """A checkpoint's `extra`: `examples_seen`, the layout receipt and,
        on the trainer-owned feed, the schema-validated iterator blob at
        the step barrier (`next_step` is the batch a restored run takes
        first)."""
        extra = {"examples_seen":
                 next_step * self.cfg.data.global_batch_size,
                 **self._opt_layout_extra(state)}
        if ingest is not None:
            blob = ingest.capture_state(next_step)
            errors: list = []
            schema.validate_iterator_state_blob(blob, "iterator_state",
                                                errors)
            if errors:  # never let a receipt bug block a durable save
                self.log("iterator_state_capture_invalid",
                         {"errors": errors[:3]})
            else:
                extra["iterator_state"] = blob
        return extra

    @staticmethod
    def _count_state_save(extra: Mapping) -> None:
        """`ingest_state/saves` counts blobs that rode a taken save."""
        if "iterator_state" in extra:
            telemetry.inc("ingest_state/saves")

    # ------------------------------------------------------------------ data
    def make_dataset(self, split: str = "train", data_cfg=None):
        """This rank's `build_dataset` iterator for `split`; `data_cfg`
        overrides the data section for this build only."""
        cfg = self.cfg
        rank, _ = rank_and_size()
        return build_dataset(data_cfg if data_cfg is not None else cfg.data,
                             split, seed=cfg.train.seed,
                             num_shards=self.num_shards, shard_index=rank,
                             num_classes=cfg.model.num_classes)

    def _make_train_ingest(self) -> ResumableIngest:
        """The trainer-owned train stream: the cursor-counting
        ResumableIngest over `make_dataset("train")`."""
        cfg = self.cfg
        return ResumableIngest(
            lambda dc: self.make_dataset("train", data_cfg=dc), cfg.data,
            seed=cfg.train.seed, batches_per_epoch=cfg.steps_per_epoch)

    def open_feed(self, start_step: int = 0):
        """(ingest, feed): the trainer-owned train stream positioned so its
        next batch is batch `start_step`, behind the device prefetcher.
        The position comes first: through the iterator blob of the
        checkpoint `restore_or_init` restored, when it has one that fits
        (`iterator_state_restore` logged, no batch replayed), else by a
        seek, else by replay. The prefetcher's worker draws at once, and a
        seek is exact only before the first draw. The caller closes the
        feed, then the ingest."""
        cfg = self.cfg
        ingest = self._make_train_ingest()
        blob, self._restored_iterator_state = \
            self._restored_iterator_state, None
        try:
            if start_step > 0:
                receipt = None
                if blob is not None:
                    receipt = restore_from_blob(
                        ingest, blob, step=start_step,
                        expect={"seed": cfg.train.seed,
                                "batches_per_epoch": cfg.steps_per_epoch,
                                "ingest": INGEST_LABEL})
                    if receipt is not None:
                        self.log("iterator_state_restore", receipt)
                restored = (receipt is not None
                            or ingest.restore_state(start_step))
                self.log("data_iterator_restore",
                         {"step": start_step, "restored": restored})
                if not restored:
                    for _ in range(start_step):
                        next(ingest)
                    self.log("data_fast_forward", {"batches": start_step})
            feed = DevicePrefetchIterator(
                ingest, self.device, cfg.train.prefetch_to_device,
                batch_timeout_s=cfg.train.data_timeout_s,
                timeout_retries=cfg.train.data_timeout_retries)
        except BaseException:
            ingest.close()
            raise
        return ingest, feed

    def fit(self, state: Optional[TrainState] = None,
            dataset: Optional[Iterable] = None,
            num_steps: Optional[int] = None) -> TrainState:
        """Train from `state.step` (from `restore_or_init()` when `state`
        is None) up to step `num_steps` (the config's total when None),
        one batch (this rank's rows) a step: of `dataset` when one is
        passed, else of the trainer-owned feed (`open_feed`). With
        checkpoints on, the state is offered to the manager after every
        step, and a run that reaches its end forces a save and waits for
        it (`checkpoint_save_dropped` logged if the save was not
        taken)."""
        cfg = self.cfg
        if state is None:
            state = self.restore_or_init()
        total = cfg.total_steps if num_steps is None else int(num_steps)
        guard = (NonFiniteGuard(cfg.train.max_nonfinite_steps, log=self.log)
                 if cfg.train.skip_nonfinite else None)
        ingest = None
        if dataset is None:
            self.ingest, it = self.open_feed(state.step)
            ingest, decode_errors = self.ingest, self.ingest.decode_errors
        else:
            it, decode_errors = iter(dataset), None
        try:
            state = self._run(state, it, total, guard, decode_errors, ingest)
        finally:
            if dataset is None:
                it.close()
                self.ingest.close()
        if self.checkpoints is not None:
            extra = self._save_extra(state, total, ingest)
            saved = self.checkpoints.save(state, extra=extra, force=True,
                                          replace_on_collision=True)
            if saved:
                self._count_state_save(extra)
            self.checkpoints.wait()
            if not saved:
                # the run's end state was not persisted: loud, not silent
                self.log("checkpoint_save_dropped",
                         {"step": total, "forced": True})
        return state

    def _run(self, state: TrainState, it, total: int,
             guard: Optional[NonFiniteGuard], decode_errors,
             ingest: Optional[ResumableIngest]) -> TrainState:
        cfg = self.cfg
        meter = ThroughputMeter(self.num_shards)
        host_wait = 0.0
        first = state.step
        for step in range(first, total):
            t0 = time.monotonic()
            batch = next(it)
            host_wait += time.monotonic() - t0
            if step == first:
                self._check_first_labels(batch["label"])
            state, metrics = self.train_step(state, batch, cfg.train.seed)
            if guard is not None:
                guard.observe(step + 1, metrics["bad_step"])
            if self.checkpoints is not None:
                # the manager keeps the steps at its interval; the
                # collision rule replaces a stale step a branched run
                # re-reaches
                extra = self._save_extra(state, step + 1, ingest)
                if self.checkpoints.save(state, extra=extra,
                                         replace_on_collision=True):
                    self._count_state_save(extra)
            meter.update(cfg.data.global_batch_size)
            if (step + 1) % cfg.train.log_every == 0 or step + 1 == total:
                entry = {"step": step + 1,
                         **{k: float(v) for k, v in metrics.items()},
                         **meter.snapshot(),
                         "host_wait_fraction": round(
                             host_wait / meter.elapsed, 4)}
                if guard is not None and guard.total:
                    entry["nonfinite_skips"] = guard.total
                errors = decode_errors() if callable(decode_errors) else 0
                if errors:
                    entry["data_decode_errors"] = errors
                self.log("train", entry)
        if guard is not None:
            guard.drain()
        return state

    def _check_first_labels(self, labels) -> None:
        """A label past the model head makes the cross-entropy gather read
        past the logits: checked on the first batch of a fit (one sync)."""
        labels = torch.as_tensor(labels)
        n = self.cfg.model.num_classes
        if labels.numel() and int(labels.max()) >= n:
            raise ValueError(
                f"dataset yields label {int(labels.max())} but the model "
                f"head has num_classes={n}; out-of-range labels make the "
                "cross-entropy gather produce nan — align model.num_classes "
                "with the dataset's label space")

    def evaluate(self, state: TrainState, dataset: Iterable,
                 num_batches: int, use_ema: Optional[bool] = None) -> dict:
        """Top-1/top-5 over `num_batches` batches of `dataset`; scores the
        EMA weights whenever the state carries them, unless `use_ema` is
        False."""
        if use_ema is None:
            use_ema = state.ema_params is not None
        totals = {"top1": 0, "top5": 0, "count": 0}
        t0 = time.monotonic()
        it = iter(dataset)
        for _ in range(int(num_batches)):
            counts = self.eval_step(state, next(it), use_ema=use_ema)
            for k in totals:
                totals[k] += int(counts[k])
        n = max(1, totals["count"])
        result = {"eval_top1": totals["top1"] / n,
                  "eval_top5": totals["top5"] / n,
                  "eval_examples": totals["count"],
                  "eval_seconds": time.monotonic() - t0}
        self.log("eval", {"step": state.step, **result})
        return result


def _agreed(step: Optional[int]) -> Optional[int]:
    """`step`, after checking that every rank of the process group chose
    the same one (a restore is collective under ZeRO: two ranks on two
    steps would hang or mix states)."""
    _, n = rank_and_size()
    if n > 1:
        steps = [None] * n
        torch.distributed.all_gather_object(steps, step)
        if len(set(steps)) != 1:
            raise CheckpointIntegrityError(
                f"the ranks resolved different checkpoint steps {steps}: "
                "their views of the checkpoint directory differ")
    return step

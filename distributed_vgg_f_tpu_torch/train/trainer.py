"""The core training loop — the counterpart of the JAX package's
``train/trainer.py Trainer`` without its planes.

`Trainer(cfg, device=None, log=None)` builds the device finish, the
augment stage and the train and eval steps for `cfg` on this process's
device (CUDA unless `device="cpu"`). With a process group up
(parallel/distributed.py `initialize_distributed`; NCCL, one card a
process, or gloo on the CPU) each process is one replica of N: its
dataset yields its local `global_batch_size / N` rows (the JAX
multi-host convention), the step exchanges gradients over the group with
the config's mesh (ZeRO-1/2/3, buckets, the wire; train/step.py), and
the meter counts the global batch. On one process ZeRO downgrades to
replicated SGD, as the JAX trainer does on a one-shard mesh:
`zero1 = shard_opt_state and N > 1`, and the ladder with it (`zero3 =
zero2 and shard_params`). Under ZeRO-3 the state keeps the parameters
and their EMA as this rank's (S,) shards only (train/state.py), every
checkpoint carries the `param_layout` receipt, an eval pass gathers the
exact weights once and releases them, and `params_tree(state)` gives the
whole tree for the offline surfaces (predict, serving).
`init_state(seed)` builds a model
with seeded params (weights.init_params) on that device, its optimizer
(over this rank's flat shard under ZeRO) and the optional EMA;
`restore_or_init()` restores the newest intact checkpoint of
`train.checkpoint_dir` (or, with `train.restore_from_best`, the best
slot) into such a state, or returns it fresh. A model with BatchNorm
(the zoo's ResNet) carries its statistics through all of it: the state,
the step (sync-BN over the group), the checkpoints, the EMA and eval.
`data.space_to_depth` on a model whose stem does not take the packed
layout raises, as JAX's trainer does.

`fit(state=None, dataset=None, num_steps=None, eval_dataset=None)`
(JAX `trainer.py:856–1593`) runs the steps from `state.step` to
`num_steps`, feeding the NonFiniteGuard and the throughput meter, and
writes one train record at every `log_every` window and at the last
step: `step`, the step metrics, the meter's rates and
`host_wait_fraction` over the window (the meter and the wait clocks
restart after each record), `eval_seconds` when an eval ran in the
window, `nonfinite_skips` once there are any, `data_decode_errors`
(summed over the group) once the decoders counted any, and the
`stall`, `augment`, `comm`, `iterator_state` and (with the autotuner)
`autotune` blocks (telemetry/schema.py). The `counters` and
`critical_path` blocks wait for the telemetry planes (ROADMAP A14c).

Stall attribution (JAX `trainer.py:1170–1290, 1402–1456`): three wait
clocks run over each window — `host_wait` around `next()` on the feed,
`ckpt_wait` around the cadence, best-slot and preemption saves (a save
after a record counts toward the next window), and `eval_wait` around
the eval passes, which is taken off the window's wall time.
telemetry/stall.py `StallAttributor` turns them and the guard's new
skips into the record's `stall` block: the verdict (`infeed_bound`,
`checkpoint_bound`, `guard_stalled`, `compute_bound`), the infeed and
checkpoint fractions, the prefetch queue depth and, after an eval,
`eval_seconds`. The telemetry config is not ported: the port behaves as
its JAX defaults (`telemetry.enabled` and `stall_attribution` on,
thresholds 0.25).

The ingest autotuner (JAX `trainer.py:930–1035, 1290–1357`): on the
trainer-owned feed, when `data.autotune` is active (enabled, and not
killed by DVGGF_AUTOTUNE=0), the feed gains the host read-ahead stage
(data/prefetch.py `HostPrefetchIterator`, `autotune.HOST_PREFETCH`
deep) and `self.autotuner` (data/autotune.py) binds its knobs: the decode
threads (`MAX_THREADS` 0 resolves to `max(MIN_THREADS, min(16, vCPUs))`),
the host depth and the device ring. The wire knob stays unbound: the port feeds the u8 wire only
(ROADMAP A17). Rank 0 logs `autotune_armed` (`describe()` without its
history, plus `unbound`); every rank calls `observe(stall)` once a
window, and rank 0's record carries the result. The controller makes no
collective call and no branch that leads to one reads a knob, so ranks
may settle on different values. Otherwise the feed has no host stage
and no `autotune/*` counter moves. With an eval dataset it evaluates every
`train.eval_every_steps` steps (0: once an epoch) and, with
`train.track_best_eval` and checkpoints, keeps the best eval_top1 in
one slot under `<checkpoint_dir>/best` (a forced save only when the
score improves, the threshold seeded from the slot). Training from the
best slot deletes the steps ahead of it first (`branch_truncate`).

Preemption (`train.handle_preemption`, JAX `trainer.py:1107–1136,
1457–1540`): a SIGTERM handler, installed only from the main thread
(elsewhere the feature is off, as in JAX) and restored on the way out,
sets a flag. After a completed step one process reacts at once; a group
reacts through parallel/preempt.py, every rank at the same step within
3 steps of the signal. Then a forced save with the iterator blob, its
wait, the `preempt` record, and `fit` returns (`preempted_at` holds the
step).

The feed (JAX `trainer.py:880–985`): `fit` with no dataset builds the
trainer-owned one with `open_feed` — the `ResumableIngest` over
`build_dataset` (data.name: ImageNet TFRecords through the native
decoder, or seeded batches), positioned at `state.step` through the
restored checkpoint's iterator blob (no batch replayed), else a seek,
else a replay, then the `DevicePrefetchIterator`
(the H2D copy on a side CUDA stream, the data watchdog), all closed
when `fit` returns. A dataset the caller passes is fed as it is,
unprefetched. On either source the first batch's labels are checked
against the model head before its step.

Checkpoints (JAX `trainer.py:254–259, 418–576, 637–664, 1404–1456,
1556–1570`): with `train.checkpoint_dir` set, `self.checkpoints`
(checkpoint/manager.py) is offered the state after every step and keeps
those at `checkpoint_every_steps`, and the end of a run that was not
preempted forces a save and `wait()`s for it. Each save's `extra` holds
`examples_seen`, the ZeRO-2 bucket receipt `opt_layout`, ZeRO-3's
`param_layout` and, on the trainer-owned feed, the iterator blob. Under
a process group every rank calls `save` and the restore, which are
collective; rank 0 writes.

`evaluate(state, dataset, num_batches=None, use_ema=None, step=None)`
(JAX `trainer.py:1734–1815`) scores a finite dataset exactly, to its
end, with the padding rows masked; an infinite one for
`num_eval_examples // global_batch_size` batches; with the EMA, the
averaged weights and the averaged statistics together.

Records go to `self.records` (as ``{"event": ..., **payload}``) and to
the optional `log(event, payload)` callable on rank 0 only, as the JAX
package logs on process 0. Elastic resize (ROADMAP A13b), the
collector, the flight recorder and `/autotunez` (A14c) are not ported
yet.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Iterable, Mapping, Optional

import torch
import torch.distributed as dist

from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_vgg_f_tpu_torch.checkpoint.retopology import \
    restore_any_topology
from distributed_vgg_f_tpu_torch.config import (ExperimentConfig,
                                                 supports_space_to_depth)
from distributed_vgg_f_tpu_torch.data import build_dataset
from distributed_vgg_f_tpu_torch.data import autotune
from distributed_vgg_f_tpu_torch.data.augment import make_device_augment
from distributed_vgg_f_tpu_torch.data.device_ingest import make_device_finish
from distributed_vgg_f_tpu_torch.data.iterator_state import (
    INGEST_LABEL, ResumableIngest, restore_from_blob)
from distributed_vgg_f_tpu_torch.data.prefetch import (DevicePrefetchIterator,
                                                       HostPrefetchIterator)
from distributed_vgg_f_tpu_torch.device import resolve_device
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.parallel.collectives import rank_and_size
from distributed_vgg_f_tpu_torch.parallel.preempt import PreemptConsensus
from distributed_vgg_f_tpu_torch.parallel.zero import zero_layout
from distributed_vgg_f_tpu_torch.resilience.errors import \
    CheckpointIntegrityError
from distributed_vgg_f_tpu_torch.resilience.guard import NonFiniteGuard
from distributed_vgg_f_tpu_torch.telemetry import schema
from distributed_vgg_f_tpu_torch.telemetry.stall import StallAttributor
from distributed_vgg_f_tpu_torch.train.schedule import (build_optimizer,
                                                        build_schedule)
from distributed_vgg_f_tpu_torch.train.state import TrainState
from distributed_vgg_f_tpu_torch.train.step import (build_eval_step,
                                                    build_train_step)
from distributed_vgg_f_tpu_torch.utils.meter import ThroughputMeter
from distributed_vgg_f_tpu_torch.weights import (init_batch_stats,
                                                  init_params, load_params)


#: Why the autotuner's wire knob is unbound in the `autotune_armed`
#: receipt.
WIRE_KNOB_UNBOUND = (
    "the port feeds the u8 wire only; a wire switch needs the host wires "
    "and the position-exact live rebuild (ROADMAP A17)")


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device=None,
                 log: Optional[Callable[[str, dict], None]] = None):
        self.cfg = cfg
        self.device = resolve_device("cuda" if device is None else device)
        self._log = log
        #: rank 0's records; empty on the other ranks
        self.records: list = []
        #: the step a preempted `fit` stopped at; None otherwise
        self.preempted_at: Optional[int] = None
        #: the clock of the train records' rates and host-wait share
        self.clock: Callable[[], float] = time.monotonic
        #: the trainer-owned train stream of the last `fit` without a
        #: dataset (closed when that fit returned; its decode_errors()
        #: stays readable)
        self.ingest = None
        #: the host read-ahead stage of the last `open_feed` that asked
        #: for one (closed with the feed by `fit`)
        self.host_prefetch: Optional[HostPrefetchIterator] = None
        #: the ingest autotuner of the last `fit` that armed one
        self.autotuner: Optional[autotune.IngestAutotuner] = None
        mesh, k = cfg.mesh, cfg.train.grad_accum_steps
        if cfg.data.space_to_depth and not supports_space_to_depth(
                cfg.model.name, cfg.data.image_size, cfg.data.name):
            # the packed layout is VGG-F's stem input (JAX
            # `trainer.py:89–100`): another model (a `--set model.name=`
            # on the flagship) takes (S, S, 3)
            raise ValueError(
                "data.space_to_depth needs the vggf model, "
                "image_size % 4 == 0, and a dataset that implements packing "
                f"(got model={cfg.model.name!r}, "
                f"image_size={cfg.data.image_size}, "
                f"dataset={cfg.data.name!r})")
        if mesh.elastic.enabled:
            raise NotImplementedError(
                "mesh.elastic (live elastic resize) is not ported yet "
                "(ROADMAP A13b)")
        if cfg.train.grad_accum_shard and not (mesh.shard_opt_state
                                               and k > 1):
            raise ValueError(
                "train.grad_accum_shard requires mesh.shard_opt_state=true "
                "AND train.grad_accum_steps > 1")
        self.rank, self.num_shards = rank_and_size()
        if cfg.data.global_batch_size % (self.num_shards * k):
            raise ValueError(
                f"data.global_batch_size {cfg.data.global_batch_size} does "
                f"not split over {self.num_shards} ranks x {k} micro-batches")
        self.local_batch_size = cfg.data.global_batch_size // self.num_shards
        # one shard: ZeRO has nothing to shard and runs as replicated SGD
        self.zero1 = mesh.shard_opt_state and self.num_shards > 1
        self.zero2 = self.zero1 and mesh.shard_gradients
        # ZeRO-3: params and EMA persist as 1/N shards, gathered just in
        # time; downgrades with the ladder
        self.zero3 = self.zero2 and mesh.shard_params
        self.schedule = build_schedule(cfg)
        self.device_finish = make_device_finish(
            cfg.data.mean_rgb, cfg.data.stddev_rgb,
            image_dtype=cfg.data.image_dtype)
        self.device_augment = make_device_augment(
            cfg.data.augment, cfg.data.mean_rgb, cfg.data.stddev_rgb,
            space_to_depth=cfg.data.space_to_depth)
        self.train_step = build_train_step(
            self.schedule, cfg.optim.weight_decay,
            grad_clip_norm=cfg.optim.grad_clip_norm,
            ema_decay=cfg.train.ema_decay,
            skip_nonfinite=cfg.train.skip_nonfinite,
            device_finish=self.device_finish,
            device_augment=self.device_augment,
            zero1=self.zero1, shard_gradients=self.zero2,
            shard_params=self.zero3,
            comm_bucket_mb=mesh.comm_bucket_mb, grad_accum_steps=k,
            grad_accum_shard=cfg.train.grad_accum_shard and self.zero1,
            reduce_dtype=mesh.reduce_dtype, device=self.device)
        self.eval_step = build_eval_step(self.device_finish,
                                         device=self.device)
        # the iterator blob of the last restore, consumed by the next feed
        self._restored_iterator_state = None
        # whether the last restore_or_init restored the best slot
        self._restored_from_best = False
        self.checkpoints: Optional[CheckpointManager] = None
        #: the best-eval slot, made by the first fit with an eval dataset
        self.best_checkpoints: Optional[CheckpointManager] = None
        if cfg.train.checkpoint_dir:
            self.checkpoints = CheckpointManager(
                cfg.train.checkpoint_dir,
                max_to_keep=cfg.train.keep_checkpoints,
                save_interval_steps=cfg.train.checkpoint_every_steps)

    def log(self, event: str, payload: Mapping) -> None:
        """Record an event, on rank 0 only."""
        if self.rank != 0:
            return
        self.records.append({"event": event, **payload})
        if self._log is not None:
            self._log(event, dict(payload))

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Seeded params (train.seed unless `seed` is given; the same on
        every rank), BatchNorm statistics at Flax's init (mean 0, var 1),
        a fresh optimizer at count 0 (over this rank's flat shard under
        ZeRO), and the EMA of both when train.ema_decay > 0."""
        cfg = self.cfg
        seed = cfg.train.seed if seed is None else seed
        size = cfg.data.image_size
        return self._state_for(load_params(
            build_model(cfg.model, image_size=size),
            init_params(cfg.model, seed, image_size=size),
            init_batch_stats(cfg.model, image_size=size)))

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
                ema=ema, shard_params=self.zero3)
        opt, _ = build_optimizer(cfg, model.parameters())
        return TrainState.create(model, opt, ema=ema)

    # ------------------------------------------------------------ checkpoint
    def _make_best_manager(self) -> CheckpointManager:
        """The one-slot best-eval manager under <checkpoint_dir>/best,
        retained and chosen by eval_top1: a crash mid-replacement that
        leaves two steps in the slot still restores the better-scored."""
        cfg = self.cfg
        return CheckpointManager(
            os.path.join(cfg.train.checkpoint_dir, "best"), max_to_keep=1,
            save_interval_steps=1, best_metric="eval_top1")

    def restore_or_init(self) -> TrainState:
        """The newest INTACT checkpoint of `train.checkpoint_dir` restored
        into a new state, or `init_state()` when there is none, in this
        run's layout (checkpoint/retopology.py: replicated or ZeRO, any
        shard count). With `train.restore_from_best` the best slot's
        best-scored step instead, or, without a best slot, the latest
        (`restore_from_best_unavailable` logged). A damaged step falls
        back to the newest intact one (`checkpoint_integrity_fallback`
        logged); checkpoints on disk with none intact raise
        CheckpointIntegrityError, never a silent fresh start. Collective
        under a process group."""
        self._restored_iterator_state = None
        self._restored_from_best = False
        source = self.checkpoints
        if source is not None:
            source.wait()   # every rank sees the same committed steps
            if self.cfg.train.restore_from_best:
                best = self._make_best_manager()
                if _agreed(best.latest_step()) is not None:
                    source = best
                else:
                    self.log("restore_from_best_unavailable",
                             {"fallback": "latest"})
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
        self._restored_from_best = source is not self.checkpoints
        if ema_event is not None:
            self.log(ema_event, {"step": state.step})
        self.log("restore", {"step": state.step,
                             "best": self._restored_from_best})
        return state

    def _opt_layout_extra(self, state: TrainState) -> dict:
        """The layout receipts (JAX `trainer.py:560–585`): a bucket-major
        flat momentum cannot be told from the canonical one by its shape,
        so every checkpoint of the bucketed ZeRO exchange carries its
        geometry, `opt_layout` (absent = the canonical layout); under
        ZeRO-3 the saved params are the flat vector too, and
        `param_layout` names its kind (`bucketed_flat`, whose geometry is
        `opt_layout`'s, or `canonical_flat`), the shard count and its
        length (absent = params saved as the tree)."""
        extra = {}
        if state.layout is not None and state.layout.bucket_bytes > 0:
            extra["opt_layout"] = state.layout.describe()
        if state.shard_params:
            extra["param_layout"] = {
                "kind": ("bucketed_flat" if state.layout.bucket_bytes > 0
                         else "canonical_flat"),
                "num_shards": state.layout.num_shards,
                "total_padded": state.layout.total_padded}
        return extra

    def params_tree(self, state: TrainState, *,
                    ema: bool = False) -> dict:
        """The parameters (or with `ema` the EMA) as the whole tree, the
        port's name -> tensor, for the offline surfaces (predict,
        serving) that run outside the step: under ZeRO-3 read out of the
        gathered (T,) vector through the layout (collective: every rank
        calls it), otherwise the model's own (JAX `trainer.py:385`)."""
        return state.params_tree(ema=ema)

    def _save_extra(self, state: TrainState, next_step: int,
                    ingest: Optional[ResumableIngest]) -> dict:
        """A checkpoint's `extra`: `examples_seen`, the layout receipt and,
        on the trainer-owned feed, the schema-validated iterator blob at the step barrier (`next_step`
        is the batch a restored run takes first)."""
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

    def open_feed(self, start_step: int = 0, host_depth: int = 0):
        """(ingest, feed): the trainer-owned train stream positioned so its
        next batch is batch `start_step`, behind the device prefetcher
        and, with `host_depth` > 0, the host read-ahead stage between them
        (`self.host_prefetch`, `host_depth` deep; None otherwise). The
        position comes first: through the iterator blob of the checkpoint
        `restore_or_init` restored, when it has one that fits
        (`iterator_state_restore` logged, no batch replayed), else by a
        seek, else by replay. The prefetch workers draw at once, and a
        seek is exact only before the first draw. The caller closes the
        feed, then the host stage, then the ingest."""
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
            self.host_prefetch = source = None
            if host_depth > 0:
                self.host_prefetch = source = HostPrefetchIterator(
                    ingest, depth=host_depth, device=self.device)
            feed = DevicePrefetchIterator(
                source or ingest, self.device, cfg.train.prefetch_to_device,
                batch_timeout_s=cfg.train.data_timeout_s,
                timeout_retries=cfg.train.data_timeout_retries)
        except BaseException:
            if self.host_prefetch is not None:
                self.host_prefetch.close()
            ingest.close()
            raise
        return ingest, feed

    def _arm_autotuner(self, feed) -> autotune.IngestAutotuner:
        """The controller over the live feed's knobs (JAX
        `trainer.py:986–1028`): a factory returns None for a surface the
        feed lacks, and the controller steers what exists. Logs
        `autotune_armed` on rank 0."""
        # auto (0) resolves to min(16, vCPUs), never below the floor
        max_threads = autotune.MAX_THREADS or max(
            autotune.MIN_THREADS, min(16, os.cpu_count() or 1))
        tuner = autotune.IngestAutotuner([
            autotune.thread_knob(self.ingest,
                                 min_value=autotune.MIN_THREADS,
                                 max_value=max_threads),
            autotune.host_prefetch_knob(self.host_prefetch,
                                        min_value=autotune.MIN_PREFETCH,
                                        max_value=autotune.MAX_PREFETCH),
            autotune.device_ring_knob(
                feed, min_value=autotune.MIN_PREFETCH_TO_DEVICE,
                max_value=autotune.MAX_PREFETCH_TO_DEVICE)])
        armed = tuner.describe()
        armed.pop("history", None)
        armed["unbound"] = {"wire_u8": WIRE_KNOB_UNBOUND}
        self.log("autotune_armed", armed)
        return tuner

    def fit(self, state: Optional[TrainState] = None,
            dataset: Optional[Iterable] = None,
            num_steps: Optional[int] = None,
            eval_dataset: Optional[Iterable] = None) -> TrainState:
        """Train from `state.step` (from `restore_or_init()` when `state`
        is None) up to step `num_steps` (the config's total when None),
        one batch (this rank's rows) a step: of `dataset` when one is
        passed, else of the trainer-owned feed (`open_feed`). With
        `eval_dataset`, evaluate at the cadence and keep the best slot.
        With checkpoints on, the state is offered to the manager after
        every step, and a run that reaches its end forces a save and
        waits for it (`checkpoint_save_dropped` logged if the save was
        not taken); a preempted run forces its save at the stop
        instead."""
        cfg = self.cfg
        branched = False
        if state is None:
            state = self.restore_or_init()
            # only an actual best-slot restore branches the chain: a fit
            # given a state never deletes steps ahead of it
            branched = self._restored_from_best
        total = cfg.total_steps if num_steps is None else int(num_steps)
        self.preempted_at = None
        if branched and self.checkpoints is not None:
            # training from the best slot abandons the chain beyond it,
            # now: a lazy replacement would leave a crash window in which
            # the latest step is still the pre-branch state
            stale = [s for s in self.checkpoints.all_steps()
                     if s > state.step]
            for s in stale:
                self.checkpoints.delete(s)
            if stale:
                self.log("branch_truncate", {"from_step": state.step,
                                             "deleted_steps": stale})
        if self.num_shards > 1:
            # an eval is collective: a rank without the split would strand
            # the others in the eval's sum
            have, = self._group_sum([eval_dataset is not None])
            if have not in (0, self.num_shards):
                raise ValueError(
                    f"{have} of {self.num_shards} ranks have an eval "
                    "dataset: every rank needs its share of the eval split "
                    "(at least one validation file a rank), or none does")
        if self.best_checkpoints is None and self.checkpoints is not None \
                and cfg.train.track_best_eval and eval_dataset is not None:
            self.best_checkpoints = self._make_best_manager()
        guard = (NonFiniteGuard(cfg.train.max_nonfinite_steps, log=self.log)
                 if cfg.train.skip_nonfinite else None)
        ingest = None
        self.autotuner = None
        if dataset is None:
            tune = autotune.autotune_active(cfg.data.autotune)
            self.ingest, it = self.open_feed(
                state.step, host_depth=autotune.HOST_PREFETCH if tune else 0)
            ingest, decode_errors = self.ingest, self.ingest.decode_errors
            if tune:
                try:
                    self.autotuner = self._arm_autotuner(it)
                except BaseException:
                    self._close_feed(it)
                    raise
        else:
            it, decode_errors = iter(dataset), None
        flag = {"set": False}
        installed = (cfg.train.handle_preemption and threading.current_thread()
                     is threading.main_thread())
        if installed:
            # the handler only sets the flag; the loop reacts after a
            # completed step (signal handlers install from the main thread
            # only: elsewhere the feature is off, as in JAX)
            old_sigterm = signal.signal(
                signal.SIGTERM, lambda signum, frame: flag.update(set=True))
        try:
            state = self._run(state, it, total, guard, decode_errors,
                              ingest, eval_dataset, flag)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, signal.SIG_DFL
                              if old_sigterm is None else old_sigterm)
            if dataset is None:
                self._close_feed(it)
        if self.checkpoints is not None and self.preempted_at is None:
            self._forced_save(state, total, ingest)
        if self.best_checkpoints is not None:
            self.best_checkpoints.wait()
        return state

    def _close_feed(self, feed) -> None:
        """Close the trainer-owned feed: the device stage, the host stage,
        then the ingest under them."""
        feed.close()
        if self.host_prefetch is not None:
            self.host_prefetch.close()
        self.ingest.close()

    def _forced_save(self, state: TrainState, step: int,
                     ingest: Optional[ResumableIngest]) -> None:
        """The end-of-run and the preemption save: forced, waited for, and
        loud when it was not taken (the state was not persisted)."""
        extra = self._save_extra(state, step, ingest)
        saved = self.checkpoints.save(state, extra=extra, force=True,
                                      replace_on_collision=True)
        if saved:
            self._count_state_save(extra)
        self.checkpoints.wait()
        if not saved:
            self.log("checkpoint_save_dropped", {"step": step,
                                                 "forced": True})

    def _group_sum(self, values) -> list:
        """Integers summed over the process group (every rank takes part);
        themselves on one process."""
        if self.num_shards == 1:
            return [int(v) for v in values]
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t)
        return [int(v) for v in t.tolist()]

    def _run(self, state: TrainState, it, total: int,
             guard: Optional[NonFiniteGuard], decode_errors,
             ingest: Optional[ResumableIngest], eval_dataset,
             flag: dict) -> TrainState:
        cfg = self.cfg
        eval_every = cfg.train.eval_every_steps or cfg.steps_per_epoch
        consensus = (PreemptConsensus(self.device)
                     if cfg.train.handle_preemption and self.num_shards > 1
                     else None)
        best_top1 = float("-inf")
        if self.best_checkpoints is not None:
            # a resumed run must not regress the durable best; the save
            # this threshold gates is collective, so it is read from local
            # disk on every rank and must agree
            best_top1 = _agreed(
                float((self.best_checkpoints.latest_extra() or {})
                      .get("eval_top1", float("-inf"))),
                "best-slot eval_top1 thresholds")
        window = {"augment": cfg.data.augment.describe()} \
            if self.device_augment is not None else {}
        clock = self.clock
        meter = ThroughputMeter(self.num_shards, clock=clock)
        attributor = StallAttributor(registry=telemetry.get_registry(),
                                     recorder=telemetry.get_recorder())
        # the time this window spent blocked on the feed, in checkpoint
        # saves and in eval passes
        host_wait = ckpt_wait = eval_wait = 0.0
        guard_seen = 0   # the guard's skips already named in a window
        decode_errors_seen = 0
        first = state.step
        for step in range(first, total):
            t0 = clock()
            batch = next(it)
            host_wait += clock() - t0
            if step == first:
                self._check_first_labels(batch["label"])
            state, metrics = self.train_step(state, batch, cfg.train.seed)
            if guard is not None:
                guard.observe(step + 1, metrics["bad_step"])
            meter.update(cfg.data.global_batch_size)
            if (step + 1) % cfg.train.log_every == 0 or step + 1 == total:
                entry = {"step": step + 1,
                         **{k: float(v) for k, v in metrics.items()},
                         **meter.snapshot(),
                         "host_wait_fraction": round(
                             host_wait / meter.elapsed, 4)}
                if eval_wait > 0:
                    entry["eval_seconds"] = round(eval_wait, 3)
                if guard is not None and guard.total:
                    entry["nonfinite_skips"] = guard.total
                if callable(decode_errors) or self.num_shards > 1:
                    # every rank takes part, with 0 when it has no counter
                    de, = self._group_sum(
                        [decode_errors() if callable(decode_errors) else 0])
                    if de > 0:
                        entry["data_decode_errors"] = de
                    if de > decode_errors_seen:
                        self.log("decode_errors", {
                            "step": step + 1, "total": de,
                            "new": de - decode_errors_seen})
                    decode_errors_seen = max(decode_errors_seen, de)
                # an eval pass fills no wait clock: left in the window's
                # wall time it would dilute every fraction toward 0
                guard_total = guard.total if guard is not None else 0
                entry["stall"] = attributor.window(
                    wall_s=max(1e-9, meter.elapsed - eval_wait),
                    infeed_wait_s=host_wait, checkpoint_wait_s=ckpt_wait,
                    guard_skips=guard_total - guard_seen)
                if eval_wait > 0:
                    entry["stall"]["eval_seconds"] = round(eval_wait, 3)
                guard_seen = guard_total
                if self.autotuner is not None:
                    # every rank steers its own feed, one bounded move a
                    # window at most
                    entry["autotune"] = self.autotuner.observe(
                        entry["stall"])
                entry.update(window)
                comm_meta = getattr(self.train_step, "comm_meta", None)
                if comm_meta:
                    entry["comm"] = dict(comm_meta)
                if ingest is not None:
                    entry["iterator_state"] = ingest.window_receipt(step + 1)
                self.log("train", entry)
                # the next record covers the next window only
                meter.reset()
                host_wait = ckpt_wait = eval_wait = 0.0
            if eval_dataset is not None and (step + 1) % eval_every == 0:
                t_ev = clock()
                result = self.evaluate(state, eval_dataset, step=step + 1)
                eval_wait += clock() - t_ev
                # the group-summed result is the same on every rank, so
                # every rank takes the collective save together
                if self.best_checkpoints is not None \
                        and result["eval_top1"] > best_top1:
                    t_ck = clock()
                    extra = {"eval_top1": result["eval_top1"],
                             "eval_top5": result["eval_top5"],
                             "step": step + 1,
                             **self._save_extra(state, step + 1, ingest)}
                    saved = self.best_checkpoints.save(
                        state, extra=extra, force=True,
                        metrics={"eval_top1": result["eval_top1"]},
                        replace_on_collision=True)
                    ckpt_wait += clock() - t_ck
                    if saved:
                        self._count_state_save(extra)
                        # the threshold moves once the slot holds it
                        best_top1 = result["eval_top1"]
                        self.log("best_checkpoint", {
                            "step": step + 1,
                            "eval_top1": result["eval_top1"]})
            if self.checkpoints is not None:
                # the manager keeps the steps at its interval; the
                # collision rule replaces a stale step a branched run
                # re-reaches
                t_ck = clock()
                extra = self._save_extra(state, step + 1, ingest)
                if self.checkpoints.save(state, extra=extra,
                                         replace_on_collision=True):
                    self._count_state_save(extra)
                ckpt_wait += clock() - t_ck
            # the stop decision is the same on every rank: the config
            # flag, then one rank's own flag or the group's consensus
            stop = False
            if cfg.train.handle_preemption:
                stop = (consensus.poll(flag["set"])
                        if consensus is not None else flag["set"])
            if stop:
                if self.checkpoints is not None:
                    t_ck = clock()
                    self._forced_save(state, step + 1, ingest)
                    ckpt_wait += clock() - t_ck
                self.preempted_at = step + 1
                self.log("preempt", {
                    "step": step + 1,
                    "checkpointed": self.checkpoints is not None})
                break
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
                 num_batches: Optional[int] = None,
                 use_ema: Optional[bool] = None,
                 step: Optional[int] = None) -> dict:
        """One validation pass. A finite dataset (`is_finite`, as
        data/native_jpeg.py `NativeJpegEvalIterator` is) is scored
        exactly: to its end, its padding rows masked by `valid`. An
        infinite one is drawn `num_batches` times (default
        `num_eval_examples // global_batch_size`). The counts stay on the
        device during the pass; under a process group `top1`, `top5`,
        `count` and `eval_decode_errors` are summed over the group once,
        at the end of the pass, so ranks whose shards hold different
        numbers of batches meet at that one collective, and the JAX
        package's per-batch lockstep (`_any_host_has_data`,
        `padding_batch()`) is not needed. Scores the EMA weights whenever
        the state carries them, unless `use_ema` is False. `step` names
        the record's step (default `state.step`)."""
        cfg = self.cfg
        if use_ema is None:
            use_ema = state.ema_params is not None
        totals = torch.zeros(3, dtype=torch.int64, device=self.device)
        t0_ns = time.monotonic_ns()

        def accumulate(batch):
            counts = self.eval_step(state, batch, use_ema=use_ema)
            totals.add_(torch.stack([counts[k].to(self.device)
                                     for k in ("top1", "top5", "count")]))

        # ZeRO-3: one gather for the pass, on every rank, however many
        # batches each rank's shard of the split holds
        with state.gathered(ema=use_ema):
            if num_batches is None and getattr(dataset, "is_finite", False):
                for batch in dataset:
                    accumulate(batch)
            else:
                if num_batches is None:
                    num_batches = max(1, cfg.data.num_eval_examples
                                      // cfg.data.global_batch_size)
                it = iter(dataset)
                for _ in range(int(num_batches)):
                    accumulate(next(it))
        fn = getattr(dataset, "decode_errors", None)
        top1, top5, count, de = self._group_sum(
            totals.tolist() + [fn() if callable(fn) else 0])
        dt_ns = time.monotonic_ns() - t0_ns
        telemetry.record("eval_pass", "eval", t0_ns, dt_ns)
        telemetry.inc("eval/passes")
        n = max(1, count)
        result = {"eval_top1": top1 / n, "eval_top5": top5 / n,
                  "eval_examples": count, "eval_seconds": dt_ns / 1e9}
        # a zero-filled corrupt image still counts as valid: say so
        if de > 0:
            result["eval_decode_errors"] = de
        self.log("eval", {"step": state.step if step is None else step,
                          **result})
        return result

def _agreed(value, what: str = "checkpoint steps"):
    """`value` (a step, a score), after checking that every rank of the
    process group read the same one from its view of the checkpoint
    directory: a restore and a best-slot save are collective, and ranks
    that decide them apart would hang or mix states."""
    _, n = rank_and_size()
    if n > 1:
        values = [None] * n
        torch.distributed.all_gather_object(values, value)
        if len(set(values)) != 1:
            raise CheckpointIntegrityError(
                f"the ranks resolved different {what} {values}: "
                "their views of the checkpoint directory differ")
    return value

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
`fit` runs the
steps from `state.step` to `num_steps`, feeding the NonFiniteGuard and the
throughput meter, and writes one train record at every `log_every`
window and at the last step, with the reference's keys: `step`, the step
metrics, the meter's rates, `host_wait_fraction`, and `nonfinite_skips`
once there are any. `evaluate` scores `num_batches` eval batches.

Records go to `self.records` (as ``{"event": ..., **payload}``) and to
the optional `log(event, payload)` callable. Checkpoints, the eval
cadence, preemption, elastic resize and ZeRO-3, autotune, the collector
and the flight recorder are not ported yet (ROADMAP A9, A10, A13, A14).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Mapping, Optional

from distributed_vgg_f_tpu_torch.config import ExperimentConfig
from distributed_vgg_f_tpu_torch.data.augment import make_device_augment
from distributed_vgg_f_tpu_torch.data.device_ingest import make_device_finish
from distributed_vgg_f_tpu_torch.device import resolve_device
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.parallel.collectives import rank_and_size
from distributed_vgg_f_tpu_torch.parallel.zero import zero_layout
from distributed_vgg_f_tpu_torch.resilience.guard import NonFiniteGuard
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
        model = load_params(build_model(cfg.model, image_size=size),
                            init_params(cfg.model, seed, image_size=size))
        model.to(self.device)
        ema = cfg.train.ema_decay > 0.0
        if self.zero1:
            return TrainState.create_sharded(
                model, lambda params: build_optimizer(cfg, params)[0],
                zero_layout(model, self.num_shards, cfg.mesh.comm_bucket_mb),
                ema=ema)
        opt, _ = build_optimizer(cfg, model.parameters())
        return TrainState.create(model, opt, ema=ema)

    def fit(self, state: TrainState, dataset: Iterable,
            num_steps: Optional[int] = None) -> TrainState:
        """Train from `state.step` up to step `num_steps` (the config's
        total when None), one batch of `dataset` (this rank's rows) a
        step."""
        cfg = self.cfg
        total = cfg.total_steps if num_steps is None else int(num_steps)
        guard = (NonFiniteGuard(cfg.train.max_nonfinite_steps, log=self.log)
                 if cfg.train.skip_nonfinite else None)
        meter = ThroughputMeter(self.num_shards)
        host_wait = 0.0
        it = iter(dataset)
        for step in range(state.step, total):
            t0 = time.monotonic()
            batch = next(it)
            host_wait += time.monotonic() - t0
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
                if guard is not None and guard.total:
                    entry["nonfinite_skips"] = guard.total
                self.log("train", entry)
        if guard is not None:
            guard.drain()
        return state

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

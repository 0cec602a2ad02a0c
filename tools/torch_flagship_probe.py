"""Measurements of the port's flagship training on one CUDA card, on
TFRecords of the JPEG fixture (tests/data/jpeg_fixture: 16 JPEGs packed
into 4 train shards of 1024 records and 1200 validation records, as
chip_smoke.py packs them). It imports torch, numpy and the port only.

    python -m tools.torch_flagship_probe [--steps 30] [--out FILE]
        [--part lr|gaps|both|hostwait|autotune] [--pairs 5]

(a) `lr`: the preset's learning rate on this data. `Trainer.fit` through
    the trainer-owned feed, a record every step, in five variants: the
    preset as it is (bf16, dropout 0.5, flip, mixup 0.2, base_lr 0.01
    scaled to 0.04 at batch 1024, no warmup); bf16 and fp32 with
    dropout, flip and mixup off at the preset's LR; fp32 with them off
    at base_lr 0.001; the preset at base_lr 0.001. Each prints its
    per-step losses, its non-finite skips, and the step at which the
    non-finite guard aborted it, if it did.
(b) `gaps`: where chip_smoke.py phase train_e2e's extra step time over
    phase train_feed's comes from. The same fit at base_lr 0.001 for
    `--steps` steps in six runs: as train_feed (no checkpoints, no eval,
    cuDNN free to choose), with cuDNN deterministic, with a checkpoint
    every 10 steps, with the eval split evaluated every 10 steps, with
    all three (as train_e2e), and as train_feed again. Each prints the
    median ms between consecutive step records over the steps after
    the fourth, with and without the gaps that hold an eval or a save,
    and the median host-wait fraction of its one-step records.

(c) `hostwait`: where the training thread's time goes on a feed-bound
    step. The same fit at base_lr 0.001, a record every step, the
    autotuner off (the ingest right under the device stage), in two
    runs: `lock_across_decode` (the ingest's cursor lock held across the
    whole native decode, as before the two-lock split of
    data/iterator_state.py) and `split_locks` (the port as it is). Four
    readings a step, taken at each record on the training thread: the
    `prefetch/wait_ns` delta; the thread's CPU time
    (`time.thread_time`) against its wall time outside `next()`; its
    run-queue wait (`/proc/thread-self/schedstat`, field 2); and, from a
    second, profiled fit of the same run, the card's idle share between
    consecutive step dispatches (torch.profiler). Where the kernel has
    no schedstat, the run-queue wait reads null and the thread's
    involuntary context switches (`getrusage(RUSAGE_THREAD)`) stand in
    for it. Beside them: the wall
    time of the record's `window_receipt` and of the step's dispatch,
    and the record's `host_wait_fraction` and stall verdict.
(d) `autotune`: whether the preset's ingest autotuner slows a feed-bound
    fit. After a 5-step warm-up fit, `--pairs` pairs of fits of
    `--steps` steps at base_lr 0.001, a record every 5 steps, one with
    the autotuner on and one under DVGGF_AUTOTUNE=0, their order
    alternating (on-off, off-on, ...), all in one process. Each fit
    prints the median ms a step over its windows after the first and
    its moves; the summary prints each arm's median of those with its
    range, each pair's on-minus-off difference, and a verdict from their
    signs: `regression` (on slower in every pair), `faster` (on faster
    in every pair) or `unresolved`.

    python -m tools.torch_flagship_probe --part autotune --pairs 5 \
        --steps 60

One JSON object a line on stdout (and in FILE with --out), the card's
name and power limit (nvidia-smi) first. Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")


def _pack(out_dir: str) -> None:
    sys.path.insert(0, REPO)
    from tools.tfrecord_write import write_shards
    jpegs = []
    for f in sorted(f for f in os.listdir(FIXTURE) if f.endswith(".jpg")):
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            jpegs.append(fh.read())
    labels = [1 + (61 * k) % 1000 for k in range(len(jpegs))]
    write_shards(out_dir, jpegs, labels, shards=4, per_shard=1024)
    write_shards(out_dir, jpegs, labels, shards=2, per_shard=600,
                 prefix="validation")


def _config(data_dir: str, sets: dict):
    from distributed_vgg_f_tpu_torch import config as tcfg
    return tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"), {
        "data.data_dir": data_dir, "train.seed": "0", "train.log_every": "1",
        **sets})


def _fit(cfg, steps: int, evals: bool = False):
    """(train records, the perf_counter stamp of each, the error that
    ended the run or None)."""
    from distributed_vgg_f_tpu_torch.resilience.guard import \
        NonFiniteStepError
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    stamps = []
    trainer = Trainer(cfg, log=lambda event, rec: stamps.append(
        time.perf_counter()) if event == "train" else None)
    state = trainer.init_state()
    error = None
    try:
        trainer.fit(state, num_steps=steps,
                    eval_dataset=trainer.make_dataset("eval")
                    if evals else None)
    except NonFiniteStepError as e:   # the guard's abort is a result
        error = str(e)
    torch.cuda.synchronize()
    train = [r for r in trainer.records if r["event"] == "train"]
    del trainer, state
    torch.cuda.empty_cache()
    return train, stamps, error


LR_VARIANTS = (
    ("preset", {}),
    ("bf16_plain_preset_lr", {"model.dropout_rate": "0.0",
                              "data.augment.enabled": "false"}),
    ("fp32_plain_preset_lr", {"model.compute_dtype": "float32",
                              "model.dropout_rate": "0.0",
                              "data.augment.enabled": "false"}),
    ("fp32_plain_lr0.001", {"model.compute_dtype": "float32",
                            "model.dropout_rate": "0.0",
                            "data.augment.enabled": "false",
                            "optim.base_lr": "0.001"}),
    ("preset_lr0.001", {"optim.base_lr": "0.001"}),
)


def probe_lr(data_dir: str, steps: int):
    for name, sets in LR_VARIANTS:
        cfg = _config(data_dir, sets)
        t0 = time.perf_counter()
        train, _, error = _fit(cfg, steps)
        yield {"part": "lr", "variant": name, "sets": sets,
               "lr": cfg.scaled_lr, "steps": steps,
               "losses": [r["loss"] for r in train],
               "nonfinite_skips": max([r.get("nonfinite_skips", 0)
                                       for r in train] or [0]),
               "first_nonfinite_loss_step": next(
                   (r["step"] for r in train
                    if not math.isfinite(r["loss"])), None),
               "aborted": error, "wall_s": time.perf_counter() - t0}


def probe_gaps(data_dir: str, steps: int):
    scratch = tempfile.mkdtemp(prefix="probe_ck_")
    runs = (("feed", False, False, False), ("e2e", True, True, True),
            ("deterministic", True, False, False),
            ("checkpoints", False, True, False), ("eval", False, False, True),
            ("feed_again", False, False, False))
    try:
        for i, (name, det, ckpt, evals) in enumerate(runs):
            sets = {"optim.base_lr": "0.001",
                    "train.eval_every_steps": "10"}
            if ckpt:
                sets.update({"train.checkpoint_dir":
                             os.path.join(scratch, str(i)),
                             "train.checkpoint_every_steps": "10"})
            cfg = _config(data_dir, sets)
            torch.backends.cudnn.deterministic = det
            try:
                train, stamps, error = _fit(cfg, steps, evals)
            finally:
                torch.backends.cudnn.deterministic = False
            # gap k ends at record k + 1; an eval and a save follow the
            # record of a step that is a multiple of 10
            gaps = [(r["step"], (t1 - t0) * 1e3) for r, t0, t1 in
                    zip(train, stamps, stamps[1:])][4:]
            quiet = [ms for s, ms in gaps if s % 10]
            yield {"part": "gaps", "run": name, "deterministic": det,
                   "checkpoint_every": 10 if ckpt else None,
                   "eval_every": 10 if evals else None, "steps": steps,
                   "step_ms_median": statistics.median(
                       [ms for _, ms in gaps]),
                   "step_ms_median_without_eval_or_save":
                       statistics.median(quiet),
                   "gap_ms": [ms for _, ms in gaps],
                   "host_wait_fraction_median": statistics.median(
                       r["host_wait_fraction"] for r in train[4:]),
                   "aborted": error}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _schedstat():
    """(ns on the CPU, ns runnable but waiting for a CPU) of the calling
    thread from its schedstat, or (None, None) where the kernel exposes
    none."""
    import threading
    for path in ("/proc/thread-self/schedstat",
                 f"/proc/self/task/{threading.get_native_id()}/schedstat"):
        try:
            with open(path) as f:
                run_ns, wait_ns, _ = f.read().split()
            return int(run_ns), int(wait_ns)
        except OSError:
            continue
    return None, None


def _switches():
    """(voluntary, involuntary) context switches of the calling thread:
    an involuntary one is a preemption while runnable."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_THREAD)
    return ru.ru_nvcsw, ru.ru_nivcsw


class _Timed:
    """A proxy that adds each call's wall and thread CPU seconds to
    `acc[name]` and forwards every other attribute."""

    def __init__(self, inner, acc, name, call="__next__"):
        self._inner, self._acc, self._name = inner, acc, name
        self._call = call

    def _timed(self, fn, *a, **k):
        w0, c0 = time.perf_counter(), time.thread_time()
        try:
            return fn(*a, **k)
        finally:
            self._acc[self._name + "_wall"] += time.perf_counter() - w0
            self._acc[self._name + "_cpu"] += time.thread_time() - c0

    def __next__(self):
        return self._timed(self._inner.__next__)

    def __iter__(self):
        return self

    def __call__(self, *a, **k):
        return self._timed(self._inner, *a, **k)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _hostwait_fit(cfg, steps, locked, profiled):
    """One fit, instrumented: per-record readings, or (profiled) the
    torch.profiler trace's per-step idle shares."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from distributed_vgg_f_tpu_torch.data import iterator_state
    from distributed_vgg_f_tpu_torch.telemetry import get_registry
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    reg = get_registry()
    acc = {k: 0.0 for k in ("next_wall", "next_cpu", "receipt_wall",
                            "receipt_cpu", "step_wall", "step_cpu")}
    rows = []
    last = {}

    def on_record(event, rec):
        if event != "train":
            return
        now = {"wall": time.perf_counter(), "cpu": time.thread_time(),
               "wait_ns": reg.counter_value("prefetch/wait_ns", 0),
               **dict(zip(("run_ns", "runq_ns"), _schedstat())),
               **dict(zip(("vcsw", "ivcsw"), _switches())), **acc}
        if last:
            d = {k: None if now[k] is None else now[k] - last[k]
                 for k in now}
            out_wall = d["wall"] - d["next_wall"]
            rows.append({
                "step": rec["step"],
                "wall_ms": d["wall"] * 1e3,
                "prefetch_wait_ms": d["wait_ns"] / 1e6,
                "next_wall_ms": d["next_wall"] * 1e3,
                "outside_next_wall_ms": out_wall * 1e3,
                "outside_next_cpu_ms": (d["cpu"] - d["next_cpu"]) * 1e3,
                "runq_wait_ms": None if d["runq_ns"] is None
                else d["runq_ns"] / 1e6,
                "voluntary_switches": d["vcsw"],
                "involuntary_switches": d["ivcsw"],
                "receipt_wall_ms": d["receipt_wall"] * 1e3,
                "step_dispatch_wall_ms": d["step_wall"] * 1e3,
                "step_dispatch_cpu_ms": d["step_cpu"] * 1e3,
                "host_wait_fraction": rec["host_wait_fraction"],
                "stall": rec.get("stall")})
        last.update(now)

    trainer = Trainer(cfg, log=on_record)
    state = trainer.init_state()
    make_ingest, open_feed = trainer._make_train_ingest, trainer.open_feed

    class LockedIngest(iterator_state.ResumableIngest):
        """The cursor lock held across each whole draw, as
        ResumableIngest held it before the two-lock split."""

        @property
        def next_into(self):
            inner_next_into = self._inner.next_into

            def next_into(images, labels):
                with self._draw_lock, self._lock:
                    self._started = True
                    inner_next_into(images, labels)
                    self._cursor += 1
            return next_into

    def patched_make_ingest():
        ingest = make_ingest()
        if locked:
            ingest.__class__ = LockedIngest
        receipt = ingest.window_receipt
        ingest.window_receipt = _Timed(receipt, acc, "receipt")
        return ingest

    def patched_open_feed(start_step=0, host_depth=0):
        ingest, feed = open_feed(start_step, host_depth=host_depth)
        return ingest, _Timed(feed, acc, "next")

    trainer._make_train_ingest = patched_make_ingest
    trainer.open_feed = patched_open_feed
    step_fn = trainer.train_step

    def marked_step(*a, **k):
        with record_function("probe_step"):
            return step_fn(*a, **k)

    trainer.train_step = _Timed(marked_step if profiled else step_fn, acc,
                                "step", call="__call__")
    trainer.train_step.comm_meta = getattr(step_fn, "comm_meta", None)
    if not profiled:
        trainer.fit(state, num_steps=steps)
        torch.cuda.synchronize()
        del trainer, state
        torch.cuda.empty_cache()
        return rows
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.fit(state, num_steps=steps)
        torch.cuda.synchronize()
    del trainer, state
    torch.cuda.empty_cache()
    events = prof.events()
    # the marker also appears on the device timeline (kineto's user
    # annotation): the host's marks bound the steps, and the device's
    # kernels and copies fill them
    cuda = torch.autograd.DeviceType.CUDA
    starts = sorted(e.time_range.start for e in events
                    if e.name == "probe_step" and e.device_type != cuda)
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == cuda and e.name != "probe_step")
    idle = []
    for s0, s1 in zip(starts, starts[1:]):
        merged = []
        for a, b in device:
            a, b = max(a, s0), min(b, s1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged)
        idle.append(1.0 - busy / (s1 - s0))
    return idle


def probe_hostwait(data_dir: str, steps: int):
    # the feed as train_feed's was before the autotuner: the ingest under
    # the device stage, no host stage between them
    sets = {"optim.base_lr": "0.001", "data.autotune.enabled": "false"}
    for name, locked in (("lock_across_decode", True),
                         ("split_locks", False)):
        cfg = _config(data_dir, sets)
        rows = _hostwait_fit(cfg, steps, locked, profiled=False)
        idle = _hostwait_fit(cfg, min(steps, 12), locked, profiled=True)
        tail = rows[3:]

        def med(key):
            values = [r[key] for r in tail if r[key] is not None]
            return statistics.median(values) if values else None

        yield {"part": "hostwait", "run": name, "steps": steps,
               "cpu_count": os.cpu_count(),
               "native_threads": cfg.data.native_threads,
               "medians_after_step_4": {k: med(k) for k in (
                   "wall_ms", "prefetch_wait_ms", "next_wall_ms",
                   "outside_next_wall_ms", "outside_next_cpu_ms",
                   "runq_wait_ms", "voluntary_switches",
                   "involuntary_switches", "receipt_wall_ms",
                   "step_dispatch_wall_ms", "step_dispatch_cpu_ms",
                   "host_wait_fraction")},
               "device_idle_share_per_step": idle,
               "device_idle_share_median_after_step_3":
                   statistics.median(idle[2:]) if len(idle) > 2 else None,
               "per_step": rows}


def _autotune_fit(cfg, steps: int, killed: bool):
    """(median ms a step over the windows after the first, the moves)."""
    from distributed_vgg_f_tpu_torch.data import autotune
    if killed:
        os.environ[autotune.ENV_KILL] = "0"
    try:
        train, stamps, error = _fit(cfg, steps)
    finally:
        os.environ.pop(autotune.ENV_KILL, None)
    if error is not None:
        raise RuntimeError(f"the fit aborted: {error}")
    every = cfg.train.log_every
    window_ms = [(t1 - t0) * 1e3 / every for t0, t1 in zip(stamps,
                                                           stamps[1:])]
    moves = [(a["window"], a["knob"], a["from"], a["to"]) for r in train
             for a in (r.get("autotune") or {}).get("actuations", [])]
    return statistics.median(window_ms), moves


def probe_autotune(data_dir: str, steps: int, pairs: int):
    cfg = _config(data_dir, {"optim.base_lr": "0.001",
                             "train.log_every": "5"})
    _fit(cfg, 5)    # warm-up: cuDNN's algorithm search, the first draws
    arms = {"on": [], "off": []}
    diffs = []
    for i in range(pairs):
        order = ("on", "off") if i % 2 == 0 else ("off", "on")
        got = {}
        for arm in order:
            got[arm], moves = _autotune_fit(cfg, steps, arm == "off")
            arms[arm].append(got[arm])
            yield {"part": "autotune", "pair": i, "arm": arm,
                   "steps": steps, "step_ms_median": got[arm],
                   "moves": moves}
        diffs.append(got["on"] - got["off"])
    verdict = ("regression" if all(d > 0 for d in diffs)
               else "faster" if all(d < 0 for d in diffs)
               else "unresolved")
    yield {"part": "autotune", "pairs": pairs, "steps": steps,
           "cpu_count": os.cpu_count(),
           **{f"{arm}_step_ms": {"median": statistics.median(v),
                                 "min": min(v), "max": max(v), "fits": v}
              for arm, v in arms.items()},
           "on_minus_off_ms": diffs,
           "on_minus_off_ms_median": statistics.median(diffs),
           "verdict": verdict}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--part", choices=("lr", "gaps", "both",
                                           "hostwait", "autotune"),
                        default="both")
    parser.add_argument("--pairs", type=int, default=5)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps({"card": card, **obj})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    data_dir = tempfile.mkdtemp(prefix="probe_data_")
    try:
        _pack(data_dir)
        if args.part in ("lr", "both"):
            for row in probe_lr(data_dir, args.steps):
                emit(row)
        if args.part in ("gaps", "both"):
            for row in probe_gaps(data_dir, args.steps):
                emit(row)
        if args.part == "hostwait":
            for row in probe_hostwait(data_dir, args.steps):
                emit(row)
        if args.part == "autotune":
            for row in probe_autotune(data_dir, args.steps, args.pairs):
                emit(row)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

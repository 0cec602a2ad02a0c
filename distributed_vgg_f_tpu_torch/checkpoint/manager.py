"""Checkpoint manager of the port — the counterpart of the JAX package's
``checkpoint/manager.py CheckpointManager`` (:48–414), with its behaviour
and signature over a format of its own instead of Orbax.

A step is a directory of one ``.npy`` per array, in the Flax names and
layouts (train/state.py `TrainState.checkpoint_tree`), plus the host
state as JSON:

    <root>/<step>/state/step.npy                  int32 scalar
    <root>/<step>/state/params/conv1/kernel.npy   HWIO, fp32
    <root>/<step>/state/opt/trace.npy             the ZeRO (T,) vector, or
    <root>/<step>/state/opt/trace/<layer>/<leaf>.npy  per parameter
    <root>/<step>/state/opt/count.npy             optax's count, int32
    <root>/<step>/state/ema_params/...            when the run keeps one
    <root>/<step>/state/batch_stats/<layer>/{mean,var}.npy  BatchNorm's
    <root>/<step>/state/ema_batch_stats/...       their EMA
    <root>/<step>/extra.json                      receipts and the blob
    <root>/<step>/metrics.json                    the score (best_metric)

so a step the port wrote and a JAX step converted by
tools/orbax_to_port.py are the same files, read by one restore path. No
pickle. `integrity/` (the checksum manifests, resilience/integrity.py)
and `data_state/` are non-numeric siblings the step scan ignores.

A save is two halves. On the training thread, `save` decides (the save
interval, the collision rules), builds the state's arrays (under ZeRO an
all-gather of the momentum, which is why every rank calls it) and copies
them into host buffers, pinned when they lie on the card: the copy is
enqueued on the current CUDA stream, so it is ordered before the next
step's in-place update of params and momentum, and the training thread
does not wait for it. A writer thread then waits for the copy's event,
writes the files under `<root>/<step>.tmp-*`, hashing each one as it
writes it, fsyncs them, `os.replace`s the directory to `<root>/<step>`
(the commit is atomic) and writes the step's checksum manifest from the
hashes. A save whose buffers the next save would overwrite finishes
first (the next dispatch waits for it). Only rank 0 writes; the other
ranks keep the same bookkeeping.

Retention keeps the `max_to_keep` newest steps in save order (Orbax's),
applied by the writer once the new step is durable, which also removes
manifests whose step is gone. With `best_metric` (the trainer's best
slot) it keeps the `max_to_keep` best-SCORED steps instead (the score,
`metrics[best_metric]` of `save(..., metrics=)`, max mode, written to
the step's `metrics.json`), `best_step()` prefers the best-scored intact
step, and a collision is replaced at an unused index, so a best step
exists at every instant of the replacement. The first save of a manager
with no step on disk is always taken (Orbax's initial-save policy),
later ones at multiples of `save_interval_steps`. The writer retries the
OSError family `SAVE_RETRIES` times.

Counters (`CHECKPOINT_COUNTERS`, telemetry/registry.py) and spans
(`checkpoint_save_dispatch`, `checkpoint_restore`, `checkpoint_wait`,
category "checkpoint") keep the JAX names; the dispatch span holds the
wait for the previous write, as Orbax's does.
`timings` holds the last dispatch's `wait_s` (for the previous write)
and `snapshot_s` (the arrays and their copies enqueued), and the last
write's `write_s` (the writer thread's wait for the copy, the writes,
the commit and the manifest) and `manifest_s` (the hashing and the
manifest's write, within `write_s`).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.parallel.collectives import rank_and_size
from distributed_vgg_f_tpu_torch.resilience.errors import \
    CheckpointIntegrityError
from distributed_vgg_f_tpu_torch.resilience.integrity import (
    list_manifest_steps, remove_step_manifest, step_dir,
    verify_step_manifest, write_manifest)
from distributed_vgg_f_tpu_torch.telemetry.registry import \
    CHECKPOINT_COUNTERS

#: The writer retries the OSError family this many times, with
#: exponential backoff, before a save fails (the JAX trainer's default
#: `train.checkpoint_save_retries`, which the port does not expose).
SAVE_RETRIES = 2

STATE_DIRNAME = "state"
EXTRA_FILE = "extra.json"
METRICS_FILE = "metrics.json"


class LeafMeta(NamedTuple):
    """A saved array's shape and dtype (`state_metadata`)."""
    shape: tuple
    dtype: np.dtype


class _StepExists(Exception):
    """A forced save landed on a step already in the directory."""


class _HashedFile:
    """A file being written, whose bytes are counted and hashed (SHA-256)
    on their way in: its manifest entry without reading it back."""

    def __init__(self, f):
        self._f = f
        self._sha256 = hashlib.sha256()
        self.size = 0
        self.hash_s = 0.0

    def write(self, data) -> int:
        t0 = time.monotonic()
        self._sha256.update(data)
        self.hash_s += time.monotonic() - t0
        n = self._f.write(data)
        self.size += n
        return n

    def entry(self) -> dict:
        return {"size": self.size, "sha256": self._sha256.hexdigest()}


def _scan_steps(root: str) -> list:
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(root, n)))


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _write_file(path: str, write) -> _HashedFile:
    """Write `path` through `write(file)`, fsync it and return its
    size and hash."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        hashed = _HashedFile(f)
        write(hashed)
        f.flush()
        os.fsync(f.fileno())
    return hashed


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _barrier() -> None:
    """Every rank of the default group meets here (nothing without one)."""
    if rank_and_size()[1] > 1:
        torch.distributed.barrier()


def _step_of(state) -> int:
    return int(state["step"] if isinstance(state, Mapping) else state.step)


class CheckpointManager:
    """`save(state, extra=...)` returns once the state's arrays are copied
    to host buffers (the files are written behind it); `restore()` blocks
    and returns `(arrays, extra)`: the saved arrays by name (numpy) and
    the `extra` JSON. `state` is a train/state.py TrainState, or a mapping
    of array names to arrays holding `step`."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1,
                 best_metric: Optional[str] = None):
        """Every durable step gets a checksum manifest; `best_step()` and
        default restores verify it and fall back to the newest INTACT
        step, recording the skipped ones on `last_integrity_fallback`.
        `best_metric`: retain and prefer steps by this score (max)."""
        self._save_interval = max(1, int(save_interval_steps))
        self._max_to_keep = max_to_keep
        self._best_metric = best_metric
        self._dir = os.path.abspath(directory)
        # steps this manager has durably saved: a collision with one of
        # them is a re-save of IDENTICAL state (one state per step)
        self._saved_steps: set = set()
        # verification verdicts, cached per content write
        self._verified: Dict[int, bool] = {}
        self._last_verify_detail = None
        #: {"chosen": step, "skipped": [(step, detail), ...]} after a
        #: best_step() resolution had to skip damaged steps; else None
        self.last_integrity_fallback: Optional[dict] = None
        self.timings: Dict[str, float] = {}
        self._writer = rank_and_size()[0] == 0
        self._buffers: Dict[str, torch.Tensor] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight = None     # (index, future) of the write in flight
        reg = telemetry.get_registry()
        for name in CHECKPOINT_COUNTERS:
            reg.counter(name)
        if self._writer:
            os.makedirs(self._dir, exist_ok=True)
            for name in os.listdir(self._dir):   # a crashed save's leftovers
                head, sep, _ = name.partition(".tmp-")
                if sep and head.isdigit():
                    shutil.rmtree(os.path.join(self._dir, name),
                                  ignore_errors=True)
        # save order (retention drops the oldest first), from disk
        self._steps: list = _scan_steps(self._dir)
        # best_metric mode: each step's score, from its metrics.json
        self._scores: Dict[int, float] = {}
        if best_metric is not None:
            for s in self._steps:
                score = (self.metrics_at(s) or {}).get(best_metric)
                if score is not None:
                    self._scores[s] = float(score)

    # ------------------------------------------------------------------ save
    def save(self, state, extra: Optional[Mapping[str, Any]] = None, *,
             force: bool = False,
             metrics: Optional[Mapping[str, Any]] = None,
             replace_on_collision: bool = False) -> bool:
        """Save `state` at its step; True when the save was taken.
        `metrics` (JSON) go to the step's `metrics.json`; under
        `best_metric` they carry its score.

        `replace_on_collision`: a run branched from an earlier checkpoint
        re-reaches step numbers that already exist on disk holding STALE
        state; with this flag such a collision replaces the stale step,
        synchronously: a plain manager deletes it and re-saves the step,
        a `best_metric` manager saves the replacement at an unused index
        (one past the largest) and retention removes the worse-scored
        entry only once the new one is durable. A collision with a step
        THIS manager already saved is a re-save of identical state and
        returns True untouched."""
        step = _step_of(state)

        def save_at(idx: int, force_flag: bool) -> bool:
            if not force_flag and not self._should_save(idx):
                return False
            if idx in self._steps:
                raise _StepExists(idx)
            with telemetry.span("checkpoint_save_dispatch", "checkpoint"):
                self._dispatch(idx, state, extra, metrics)
            telemetry.inc("checkpoint/saves")
            return True

        def save_replacing() -> bool:
            if step in self._saved_steps:
                return True  # already durable, identical by construction
            if self._best_metric is not None:
                save_at(1 + max(self._steps, default=step), True)
            else:
                if step in self._steps:
                    self.delete(step)
                save_at(step, True)
            self._wait_writer()
            self._saved_steps.add(step)
            return True

        try:
            saved = save_at(step, force)
        except _StepExists:
            return save_replacing() if replace_on_collision else False
        if saved:
            self._saved_steps.add(step)
            return True
        if force or not replace_on_collision:
            return False
        # a cadence save inside a branched run's stale overlap: the
        # interval rule rejects step <= latest before the existence check
        latest = self.latest_step()
        if latest is not None and latest >= step \
                and step % self._save_interval == 0:
            return save_replacing()
        return False

    def _should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self._save_interval == 0 or not self._steps

    def _dispatch(self, idx: int, state, extra, metrics=None) -> None:
        """The training thread's half of a save: wait for the save whose
        buffers this one reuses, build the arrays (a collective under
        ZeRO), enqueue their copy into host buffers and hand the writes
        to the writer thread."""
        t0 = time.monotonic()
        self._wait_writer()
        t1 = time.monotonic()
        tree = (state.checkpoint_tree() if hasattr(state, "checkpoint_tree")
                else state)
        self._steps.append(idx)
        self._verified.pop(idx, None)
        if self._best_metric is not None and metrics \
                and metrics.get(self._best_metric) is not None:
            self._scores[idx] = float(metrics[self._best_metric])
        removed = self._retention()
        for s in removed:
            self._forget(s)
        if not self._writer:
            return
        snapshot, event = self._snapshot(tree)
        self.timings.update(wait_s=t1 - t0, snapshot_s=time.monotonic() - t1)
        job = (idx, snapshot, event, json.dumps(dict(extra or {})),
               None if metrics is None else json.dumps(dict(metrics)),
               removed, set(self._steps))
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint-writer")
        self._inflight = (idx, self._pool.submit(self._write_job, *job))

    def _retention(self) -> list:
        """The steps past `max_to_keep`: the oldest saved, or under
        `best_metric` the worst-scored (unscored ones first, then by
        index)."""
        n = self._max_to_keep
        if n is None or len(self._steps) <= n:
            return []
        if self._best_metric is None:
            return self._steps[:len(self._steps) - n]
        ranked = sorted(self._steps, key=lambda s: (
            s in self._scores, self._scores.get(s, 0.0), s))
        return ranked[:len(self._steps) - n]

    def _snapshot(self, tree: Mapping[str, Any]):
        """Copy every array into this manager's host buffers (pinned for
        a CUDA source, the copy on the source's current stream) and
        return them with an event that marks the copies done (None when
        everything came from the host)."""
        snapshot, device = {}, None
        for key, value in tree.items():
            t = torch.as_tensor(value).detach()
            buf = self._buffers.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype \
                    or (t.is_cuda and not buf.is_pinned()):
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.is_cuda)
                self._buffers[key] = buf
            buf.copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda:
                device = t.device
            snapshot[key] = buf
        for key in set(self._buffers) - set(snapshot):
            del self._buffers[key]
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        return snapshot, event

    def _write_job(self, idx, snapshot, event, extra_json, metrics_json,
                   removed, kept) -> None:
        t0 = time.monotonic()
        if event is not None:
            event.synchronize()
        files, hash_s = self._retry_io(
            lambda: self._write_step(idx, snapshot, extra_json,
                                     metrics_json))
        t1 = time.monotonic()
        self._retry_io(lambda: write_manifest(self._dir, idx, files))
        t2 = time.monotonic()
        self.timings.update(write_s=t2 - t0, manifest_s=hash_s + t2 - t1)
        for s in removed:   # retention, only once the new step is durable
            shutil.rmtree(step_dir(self._dir, s), ignore_errors=True)
        for s in list_manifest_steps(self._dir):   # and orphaned manifests
            if s not in kept:
                remove_step_manifest(self._dir, s)

    def _write_step(self, idx: int, snapshot, extra_json: str,
                    metrics_json: Optional[str]) -> tuple:
        """Write one step under a tmp name, fsync it, rename it into
        place: a step exists whole or not at all. Returns its manifest's
        `files` and the seconds spent hashing them."""
        tmp = os.path.join(self._dir, f"{idx}.tmp-{uuid.uuid4().hex[:8]}")
        written = {}
        try:
            for key, buf in snapshot.items():
                arr = buf.numpy()
                rel = os.path.join(STATE_DIRNAME, *key.split("/")) + ".npy"
                written[rel] = _write_file(
                    os.path.join(tmp, rel),
                    lambda f: np.save(f, arr, allow_pickle=False))
            written[EXTRA_FILE] = _write_file(
                os.path.join(tmp, EXTRA_FILE),
                lambda f: f.write(extra_json.encode()))
            if metrics_json is not None:
                written[METRICS_FILE] = _write_file(
                    os.path.join(tmp, METRICS_FILE),
                    lambda f: f.write(metrics_json.encode()))
            # a stale manifest of this index must not judge the new files
            remove_step_manifest(self._dir, idx)
            os.replace(tmp, step_dir(self._dir, idx))
            _fsync_dir(self._dir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return ({rel: h.entry() for rel, h in written.items()},
                sum(h.hash_s for h in written.values()))

    def _retry_io(self, fn):
        """Run `fn`, retrying the OSError family with exponential backoff
        (`SAVE_RETRIES` retries)."""
        delay = 0.1
        for attempt in range(SAVE_RETRIES + 1):
            try:
                return fn()
            except OSError:
                if attempt == SAVE_RETRIES:
                    telemetry.inc("checkpoint/save_failures")
                    raise
                telemetry.inc("checkpoint/save_retries")
                time.sleep(delay)
                delay *= 2

    def _wait_writer(self) -> None:
        """Block until the write in flight is durable and manifested; its
        failure raises here, and the step it was writing is forgotten."""
        if self._inflight is None:
            return
        _, future = self._inflight
        self._inflight = None
        try:
            future.result()
        except BaseException:
            self._steps = _scan_steps(self._dir)
            raise

    def _forget(self, step: int) -> None:
        if step in self._steps:
            self._steps.remove(step)
        self._verified.pop(step, None)
        self._scores.pop(step, None)

    # ------------------------------------------------------------- integrity
    def verify_step(self, step: int) -> bool:
        """True when the step's files match its checksum manifest, or no
        manifest exists to check against (a step whose writer had not
        finished, or a crash between its commit and its manifest, stays
        restorable, vouched for by the atomic rename). Verdicts are
        cached."""
        if step not in self._verified:
            verdict, detail = verify_step_manifest(self._dir, step)
            self._verified[step] = verdict is not False
            if verdict is False:
                self._last_verify_detail = (step, detail)
        return self._verified[step]

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        """The step saved last (Orbax's `latest_step`), or None."""
        return self._steps[-1] if self._steps else None

    def best_step(self) -> Optional[int]:
        """The step a default restore uses: the best-scored one under
        `best_metric`, else the latest, SKIPPING any step that fails
        verification and falling back newest first. None when no intact
        step remains (never a reason to reinitialize silently: see
        restore()). Skipped steps are recorded on
        `last_integrity_fallback`."""
        self._wait_writer()
        order = []
        if self._scores:
            order.append(max(self._scores,
                             key=lambda s: (self._scores[s], s)))
        order.extend(s for s in sorted(self._steps, reverse=True)
                     if s not in order)
        skipped = []
        self.last_integrity_fallback = None
        for step in order:
            if self.verify_step(step):
                if skipped:
                    self.last_integrity_fallback = {"chosen": step,
                                                    "skipped": skipped}
                    telemetry.inc("checkpoint/integrity_fallbacks")
                return step
            skipped.append((step, (self._last_verify_detail
                                   or (step, "corrupt"))[1]))
        if skipped:
            self.last_integrity_fallback = {"chosen": None,
                                            "skipped": skipped}
        return None

    def restore(self, step: Optional[int] = None) -> tuple:
        """(arrays, extra) at `step` (default: the newest INTACT step). An
        EXPLICITLY requested step that fails verification raises
        CheckpointIntegrityError (substituting another would be silent
        time travel), as does a default restore with steps on disk but
        none intact; no steps at all raise FileNotFoundError."""
        self._wait_writer()
        if step is not None and not self.verify_step(step):
            raise CheckpointIntegrityError(
                f"checkpoint step {step} under {self._dir} failed integrity "
                f"verification ({self._last_verify_detail}) — the files are "
                "truncated or corrupt")
        step = step if step is not None else self.best_step()
        if step is None:
            if self._steps:
                raise CheckpointIntegrityError(
                    f"every checkpoint under {self._dir} failed integrity "
                    "verification "
                    f"({(self.last_integrity_fallback or {}).get('skipped')})"
                    " — refusing to restore corrupt state; restore from a "
                    "replica/backup or clear the directory to restart from "
                    "scratch")
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        t0 = time.monotonic_ns()
        base = os.path.join(step_dir(self._dir, step), STATE_DIRNAME)
        arrays = {}
        for dirpath, _, files in os.walk(base):
            for name in sorted(files):
                if name.endswith(".npy"):
                    path = os.path.join(dirpath, name)
                    key = os.path.relpath(path[:-4], base)
                    arrays[key.replace(os.sep, "/")] = np.load(
                        path, allow_pickle=False)
        if not arrays:
            raise FileNotFoundError(f"checkpoint step {step} under "
                                    f"{self._dir} holds no arrays")
        extra = self.extra_at(step)
        dt = time.monotonic_ns() - t0
        telemetry.record("checkpoint_restore", "checkpoint", t0, dt)
        telemetry.inc("checkpoint/restores")
        telemetry.inc("checkpoint/restore_ns", dt)
        return arrays, extra

    def delete(self, step: int) -> None:
        """Remove a saved step (and its manifest)."""
        self._wait_writer()
        if self._writer:
            shutil.rmtree(step_dir(self._dir, step), ignore_errors=True)
            remove_step_manifest(self._dir, step)
        self._forget(step)

    def state_metadata(self, step: Optional[int] = None
                       ) -> Dict[str, LeafMeta]:
        """Shapes and dtypes of the saved arrays at `step` (default: the
        newest intact), read from the .npy headers without the data."""
        step = step if step is not None else self.best_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        base = os.path.join(step_dir(self._dir, step), STATE_DIRNAME)
        out = {}
        for dirpath, _, files in os.walk(base):
            for name in sorted(files):
                if not name.endswith(".npy"):
                    continue
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    version = np.lib.format.read_magic(f)
                    read = (np.lib.format.read_array_header_1_0
                            if version == (1, 0)
                            else np.lib.format.read_array_header_2_0)
                    shape, _, dtype = read(f)
                key = os.path.relpath(path[:-4], base).replace(os.sep, "/")
                out[key] = LeafMeta(tuple(shape), dtype)
        return out

    def extra_at(self, step: int) -> Mapping[str, Any]:
        """The `extra` JSON of one step, without reading its arrays."""
        return _read_json(os.path.join(step_dir(self._dir, step),
                                       EXTRA_FILE)) or {}

    def metrics_at(self, step: int) -> Optional[Mapping[str, Any]]:
        """The `metrics` JSON a step was saved with, or None."""
        return _read_json(os.path.join(step_dir(self._dir, step),
                                       METRICS_FILE))

    def latest_extra(self) -> Optional[Mapping[str, Any]]:
        """The `extra` JSON of the step a default restore would use (the
        best-scored under `best_metric`), without reading its arrays;
        None without an intact step. The best slot's threshold: a
        resumed run must not regress the durable best."""
        step = self.best_step()
        return None if step is None else self.extra_at(step)

    def iterator_state_at(self, step: int) -> Optional[Mapping[str, Any]]:
        """The iterator-state blob of one step's `extra`, or None."""
        blob = self.extra_at(step).get("iterator_state")
        return blob if isinstance(blob, Mapping) else None

    def wait(self) -> None:
        """Block until pending saves are durable and manifested; under a
        process group every rank then meets, so no rank reads a step
        before it is committed."""
        t0 = time.monotonic_ns()
        self._wait_writer()
        _barrier()
        dt = time.monotonic_ns() - t0
        telemetry.record("checkpoint_wait", "checkpoint", t0, dt)
        telemetry.inc("checkpoint/wait_ns", dt)

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def all_steps(self) -> list:
        return sorted(self._steps)

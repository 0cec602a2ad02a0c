"""Closed-loop ingest autotuner — an own copy of the JAX package's
``data/autotune.py``: a per-process feedback controller that reads the
stall verdict of each log window (telemetry/stall.py) and steers the live
feed's knobs, tf.data's AUTOTUNE with a receipt trail:

- **decode threads**: the native decoder's pool, resized mid-stream
  (`NativeJpegTrainIterator.set_num_threads`, through `ResumableIngest`;
  the stream is the same at any size);
- **host read-ahead**: `HostPrefetchIterator.set_depth` (data/prefetch.py),
  starting at `HOST_PREFETCH`;
- **device ring** (`train.prefetch_to_device`):
  `DevicePrefetchIterator.set_buffer_size`.

JAX's restart fan-out knob is bound only where its config raises
`max_restart_fanout` above 1 and its wire knob only with the host wires:
the port has neither setting, so neither knob (ROADMAP A14b, A17). Under
the snapshot cache (data/snapshot_cache.py) the decode pool closes at the
switch to warm: `set_num_threads` then returns None, and the controller
marks the thread knob unavailable at its next move.

Control discipline: `K_WINDOWS` consecutive same-direction verdicts
before any move (an actuation resets the streak); `COOLDOWN_WINDOWS`
quiet windows after a move; one bounded step of one knob a window
(doubling for the thread pool, +1 for depths), clamped to the rails,
where the controller reports `blocked: rail`; a knob whose direction flips
`FREEZE_AFTER_FLIPS` times is frozen for the run.

Verdict -> action: infeed_bound steps the first knob below its rail up,
in the knob list's order; compute_bound moves nothing, unless
`RELAX_AFTER_WINDOWS` > 0, when knobs the controller raised step back
down toward their baseline after that many compute-bound windows;
checkpoint_bound and guard_stalled move nothing.

Receipts: the `autotune/*` counters and per-knob gauges of the registry,
the train record's `autotune` block (`observe`), `describe()` and
`history()`. The `/autotunez` endpoint and the flight recorder wait for
ROADMAP A14c; a caller may pass an object with `record_actuation(act)` as
`flight`.

Settings: the module constants below, JAX's `AutotuneConfig` defaults;
no deployment has needed another value yet, so none is a config field
(ROADMAP A14b). Kill switch: `data.autotune.enabled` is off by default
(the flagship preset turns it on), and `DVGGF_AUTOTUNE=0` turns it off
whatever the config says: the trainer then builds no host stage, binds
no knob and moves no counter. Stdlib only at import; the native decoder is reached
only through the knobs a caller binds.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from distributed_vgg_f_tpu_torch import telemetry

#: Environment kill-switch (checked at controller-creation sites, the same
#: discipline as DVGGF_DECODE_SIMD / DVGGF_WIRE_U8 / DVGGF_DECODE_RESTART):
#: "0" disables autotuning regardless of config, byte-identical to
#: controller-absent.
ENV_KILL = "DVGGF_AUTOTUNE"

#: Consecutive same-direction verdicts required before ANY actuation.
K_WINDOWS = 3
#: Quiet windows after an actuation before the next one may fire.
COOLDOWN_WINDOWS = 2
#: Windows with no actuation before the controller reports settled.
SETTLED_AFTER_WINDOWS = 6
#: Sustained compute_bound windows before a controller-raised knob steps
#: back toward its baseline; 0 disables down-steps (a compute-bound
#: workload then produces zero actuations).
RELAX_AFTER_WINDOWS = 0
#: Direction flips on one knob before the oscillation guard freezes it.
FREEZE_AFTER_FLIPS = 2
#: Actuation-log ring size (bounds describe()'s history).
HISTORY = 64
#: Hard rails per knob; MAX_THREADS 0 = min(16, host vCPUs) at bind time.
MIN_THREADS, MAX_THREADS = 1, 0
MIN_PREFETCH, MAX_PREFETCH = 1, 8
MIN_PREFETCH_TO_DEVICE, MAX_PREFETCH_TO_DEVICE = 1, 4
#: The host read-ahead stage's starting depth (JAX `data.prefetch`).
HOST_PREFETCH = 2

#: Verdicts that drive an UP escalation vs the one that may relax.
_UP_VERDICT = "infeed_bound"
_RELAX_VERDICT = "compute_bound"


def autotune_killed() -> bool:
    return os.environ.get(ENV_KILL, "").strip() == "0"


def autotune_active(cfg) -> bool:
    """The single activation predicate: config-enabled AND not env-killed.
    The trainer gates everything on it, the host stage included, so the
    kill-switch path is the controller-absent path."""
    return bool(getattr(cfg, "enabled", False)) and not autotune_killed()


@dataclass
class Knob:
    """One actuatable pipeline parameter. `apply(target)` returns the
    now-active value (possibly clamped by the subsystem) or None when the
    subsystem refuses — the controller then marks the knob unavailable
    instead of believing an actuation that never happened."""
    name: str
    get: Callable[[], Optional[int]]
    apply: Callable[[int], Optional[int]]
    min_value: int
    max_value: int
    step: int = 1
    geometric: bool = False       # double/halve instead of +/- step
    # -- controller-owned state --------------------------------------------
    value: Optional[int] = None
    baseline: Optional[int] = None
    available: bool = True
    frozen: bool = False
    last_direction: int = 0
    flips: int = 0
    unavailable_reason: str = ""

    def target(self, direction: int) -> int:
        v = int(self.value)
        if self.geometric:
            t = v * 2 if direction > 0 else v // 2
        else:
            t = v + direction * self.step
        if direction < 0 and self.baseline is not None:
            # relax steps back down TOWARD the baseline, never past it — a
            # geometric halving from a railed value would otherwise
            # overshoot below the user-configured starting point
            t = max(t, self.baseline)
        return max(self.min_value, min(self.max_value, t))


def thread_knob(loader, *, min_value: int = 1,
                max_value: int = 8) -> Optional[Knob]:
    """Decode-worker knob over a live native loader (or a wrapper that
    forwards to one, as ResumableIngest does). None when the loader
    exposes no resize surface or the native resize dispatch refuses
    (-DDVGGF_NO_RESIZE / DVGGF_THREAD_RESIZE=0)."""
    get = getattr(loader, "num_threads", None)
    setter = getattr(loader, "set_num_threads", None)
    if not (callable(get) and callable(setter)):
        return None
    if get() is None:
        return None
    # probe: a set to the current value must round-trip, else the native
    # dispatch is refusing (kill-switch/compile-out) and the knob is absent
    if setter(get()) is None:
        return None
    return Knob("native_threads", get, setter, min_value, max_value,
                geometric=True)


def host_prefetch_knob(hp, *, min_value: int = 1,
                       max_value: int = 8) -> Optional[Knob]:
    if not hasattr(hp, "set_depth"):
        return None
    return Knob("host_prefetch", lambda: hp.depth, hp.set_depth,
                min_value, max_value)


def device_ring_knob(dp, *, min_value: int = 1,
                     max_value: int = 4) -> Optional[Knob]:
    if not hasattr(dp, "set_buffer_size"):
        return None
    return Knob("prefetch_to_device", lambda: dp.buffer_size,
                dp.set_buffer_size, min_value, max_value)


class IngestAutotuner:
    """The per-process feedback controller. `observe(stall_record)` once
    per log window; everything else is receipts. The settings are the
    module's constants as they stand when the controller is made."""

    def __init__(self, knobs: Sequence[Optional[Knob]], *,
                 registry=None, flight=None,
                 clock: Callable[[], float] = time.time):
        self._settings = {
            "k_windows": K_WINDOWS, "cooldown_windows": COOLDOWN_WINDOWS,
            "settled_after_windows": SETTLED_AFTER_WINDOWS,
            "relax_after_windows": RELAX_AFTER_WINDOWS,
            "freeze_after_flips": FREEZE_AFTER_FLIPS}
        self._reg = registry if registry is not None \
            else telemetry.get_registry()
        #: an optional `record_actuation(act)` sink (the flight recorder
        #: waits for ROADMAP A14c)
        self._flight = flight
        self._clock = clock
        self._lock = threading.Lock()
        self._windows = 0
        self._streak_verdict: Optional[str] = None
        self._streak = 0
        self._last_actuation_window: Optional[int] = None
        self._actuations_total = 0
        self._history: deque = deque(maxlen=HISTORY)
        self.knobs: List[Knob] = [k for k in knobs if k is not None]
        for k in self.knobs:
            v = k.get()
            if v is None:
                k.available = False
                k.unavailable_reason = "get() returned None at bind"
            else:
                k.value = int(v)
                k.baseline = int(v)
        # pre-created: a visible zero reads as "instrumented, nothing
        # happened"
        reg = self._reg
        reg.counter("autotune/windows")
        reg.counter("autotune/actuations")
        reg.counter("autotune/blocked_hysteresis")
        reg.counter("autotune/blocked_cooldown")
        reg.counter("autotune/blocked_rail")
        reg.counter("autotune/oscillation_freezes")
        # -1 = knob not bound in this process (vs a real value once bound)
        reg.set_gauge("autotune/native_threads", -1)
        reg.set_gauge("autotune/host_prefetch", -1)
        reg.set_gauge("autotune/prefetch_to_device", -1)
        reg.set_gauge("autotune/restart_fanout", -1)
        reg.set_gauge("autotune/wire_u8", -1)
        reg.set_gauge("autotune/settled", 0)
        for k in self.knobs:
            if k.available:
                reg.set_gauge(f"autotune/{k.name}", k.value)

    # ------------------------------------------------------------ properties
    @property
    def settled(self) -> bool:
        with self._lock:
            return self._settled_locked()

    def _settled_locked(self) -> bool:
        since = self._windows - (self._last_actuation_window or 0)
        return since >= self._settings["settled_after_windows"]

    @property
    def actuations_total(self) -> int:
        with self._lock:
            return self._actuations_total

    def history(self) -> List[dict]:
        with self._lock:
            return [dict(a) for a in self._history]

    # -------------------------------------------------------------- control
    def observe(self, stall: Optional[Dict] = None) -> Dict[str, object]:
        """One log window: fold the stall verdict into the hysteresis
        state, maybe actuate ONE bounded step, and return the window's
        `autotune` record (the trainer attaches it to the JSONL train
        entry). Thread-safe against concurrent `describe()` probes."""
        with self._lock:
            self._windows += 1
            self._reg.inc("autotune/windows")
            verdict = (stall or {}).get("verdict")
            if verdict == self._streak_verdict:
                self._streak += 1
            else:
                self._streak_verdict, self._streak = verdict, 1
            direction, needed = 0, 0
            if verdict == _UP_VERDICT:
                direction, needed = 1, self._settings["k_windows"]
            elif verdict == _RELAX_VERDICT \
                    and self._settings["relax_after_windows"] > 0 \
                    and any(k.available and not k.frozen
                            and k.value > k.baseline for k in self.knobs):
                direction, needed = -1, self._settings["relax_after_windows"]
            blocked = None
            actuations: List[dict] = []
            if direction != 0:
                if self._streak < needed:
                    blocked = "hysteresis"
                    self._reg.inc("autotune/blocked_hysteresis")
                elif self._in_cooldown():
                    blocked = "cooldown"
                    self._reg.inc("autotune/blocked_cooldown")
                else:
                    act = self._actuate(direction, verdict)
                    if act is not None:
                        actuations.append(act)
                    else:
                        blocked = "rail"
                        self._reg.inc("autotune/blocked_rail")
            settled = self._settled_locked()
            self._reg.set_gauge("autotune/settled", int(settled))
            record: Dict[str, object] = {
                "window": self._windows,
                "verdict": verdict,
                "settled": settled,
                "knobs": {k.name: k.value for k in self.knobs
                          if k.available},
            }
            if actuations:
                record["actuations"] = actuations
            if blocked is not None:
                record["blocked"] = blocked
            return record

    def _in_cooldown(self) -> bool:
        if self._last_actuation_window is None:
            return False
        return (self._windows - self._last_actuation_window) \
            <= self._settings["cooldown_windows"]

    def _actuate(self, direction: int, verdict: str) -> Optional[dict]:
        """Step the first eligible knob in escalation order (reversed for
        relax: undo the most-escalated lever first). Returns the actuation
        record, or None when every knob is railed/frozen/unavailable."""
        order = self.knobs if direction > 0 else list(reversed(self.knobs))
        for k in order:
            if not k.available or k.frozen or k.value is None:
                continue
            if direction > 0 and k.value >= k.max_value:
                continue
            if direction < 0 and k.value <= max(k.min_value, k.baseline):
                continue
            target = k.target(direction)
            if target == k.value:
                continue
            applied = k.apply(target)
            if applied is None:
                # the subsystem refused (kill-switch flipped mid-run, warm
                # snapshot closed the decode pool, ...) — the knob is gone,
                # not actuated
                k.available = False
                k.unavailable_reason = "apply() refused at runtime"
                continue
            applied = int(applied)
            if applied == k.value:
                # clamped back by the subsystem: treat as railed here on
                continue
            if k.last_direction and direction != k.last_direction:
                k.flips += 1
                if k.flips >= self._settings["freeze_after_flips"]:
                    k.frozen = True
                    self._reg.inc("autotune/oscillation_freezes")
            old, k.value = k.value, applied
            k.last_direction = direction
            self._last_actuation_window = self._windows
            self._streak = 0  # fresh evidence required before the next move
            self._actuations_total += 1
            self._reg.inc("autotune/actuations")
            self._reg.set_gauge(f"autotune/{k.name}", applied)
            act = {"window": self._windows, "knob": k.name,
                   "from": old, "to": applied,
                   "direction": "up" if direction > 0 else "down",
                   "verdict": verdict,
                   "ts_unix": round(float(self._clock()), 3)}
            if k.frozen:
                act["frozen"] = True
            self._history.append(act)
            if self._flight is not None:
                try:
                    self._flight.record_actuation(act)
                except Exception:  # noqa: BLE001 — receipts never kill
                    pass
            return act
        return None

    # -------------------------------------------------------------- receipts
    def describe(self) -> dict:
        """Full controller state: the trainer's `autotune_armed` receipt
        (without `history`) and the payload `/autotunez` will serve
        (ROADMAP A14c)."""
        with self._lock:
            return {
                "enabled": True,
                "live": True,
                "windows": self._windows,
                "settled": self._settled_locked(),
                "actuations_total": self._actuations_total,
                "streak": {"verdict": self._streak_verdict,
                           "count": self._streak},
                "config": dict(self._settings),
                "knobs": [{
                    "name": k.name, "value": k.value,
                    "baseline": k.baseline,
                    "min": k.min_value, "max": k.max_value,
                    "available": k.available, "frozen": k.frozen,
                    **({"unavailable_reason": k.unavailable_reason}
                       if k.unavailable_reason else {}),
                } for k in self.knobs],
                "history": [dict(a) for a in self._history],
            }

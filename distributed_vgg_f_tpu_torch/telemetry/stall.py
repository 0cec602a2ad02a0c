"""Per-window stall attribution — an own copy of the JAX package's
``telemetry/stall.py`` (`VERDICTS`, `classify` :54, `occupancy_from_spans`
:102, `StallAttributor` :133): turn "throughput dropped" into a named
cause.

The trainer's step loop spends its wall time in four places a host can
do something about, and each leaves a distinct signature:

- **infeed_bound**: the training thread blocked in `next()` on the feed
  (decode, storage, read-ahead): a high "infeed" span occupancy or
  host-wait share, the prefetch queue at 0.
- **checkpoint_bound**: it blocked in the checkpoint machinery (cadence,
  best-slot and forced saves): "checkpoint" span occupancy.
- **guard_stalled**: steps complete but the non-finite guard discards
  their updates (`guard_skips` > 0 in the window).
- **compute_bound**: none of the above; the card sets the pace.

`classify(...)` takes the trainer's own accumulated wait seconds;
`occupancy_from_spans(...)` and `StallAttributor.window_from_spans(...)`
derive the same fractions from the span ring (telemetry/spans.py), for
callers that only bracketed the interval.

Priority: guard_stalled first; between checkpoint_bound and infeed_bound
each fraction must reach its own threshold, and of two candidates the
larger fraction wins, checkpoint on a tie; compute_bound is the residual.
The queue depth rides along from the `prefetch/queue_depth` gauge
(data/prefetch.py). Stdlib only.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

#: The verdict taxonomy (README "Observability"). guard_stalled outranks
#: everything; checkpoint vs infeed is decided by the larger blocked
#: fraction (checkpoint wins ties); compute_bound is the residual.
VERDICTS = ("guard_stalled", "checkpoint_bound", "infeed_bound",
            "compute_bound")

#: Span categories that count toward each attributable bucket.
INFEED_CATEGORIES = ("infeed",)
CHECKPOINT_CATEGORIES = ("checkpoint",)


def classify(wall_s: float, infeed_wait_s: float = 0.0,
             checkpoint_wait_s: float = 0.0, guard_skips: int = 0, *,
             infeed_threshold: float = 0.25,
             checkpoint_threshold: float = 0.25,
             queue_depth: Optional[float] = None) -> Dict[str, object]:
    """One verdict record for a logged interval.

    `wall_s` is the interval's wall-clock span; the wait inputs are the time
    the CONSUMER was blocked in each bucket inside it. `queue_depth` (the
    prefetch queue's last observed depth) rides along as corroboration: an
    infeed_bound verdict with a full queue is suspicious and worth seeing.
    """
    wall = max(float(wall_s), 1e-9)
    infeed_fraction = min(1.0, max(0.0, float(infeed_wait_s)) / wall)
    ckpt_fraction = min(1.0, max(0.0, float(checkpoint_wait_s)) / wall)
    # Candidacy is per-bucket (each fraction against ITS OWN threshold);
    # only between two qualified candidates does the larger fraction win
    # (checkpoint taking ties). An unqualified competitor must not veto a
    # qualified one — with asymmetric thresholds, infeed 0.35 under a 0.4
    # threshold must not drag checkpoint 0.30 (over its 0.25 threshold)
    # down to compute_bound (code-review r8).
    ckpt_candidate = ckpt_fraction >= checkpoint_threshold
    infeed_candidate = infeed_fraction >= infeed_threshold
    if guard_skips > 0:
        verdict = "guard_stalled"
    elif ckpt_candidate and (not infeed_candidate
                             or ckpt_fraction >= infeed_fraction):
        verdict = "checkpoint_bound"
    elif infeed_candidate:
        verdict = "infeed_bound"
    else:
        verdict = "compute_bound"
    record: Dict[str, object] = {
        "verdict": verdict,
        "infeed_fraction": round(infeed_fraction, 4),
        "checkpoint_fraction": round(ckpt_fraction, 4),
    }
    if guard_skips:
        record["guard_skips"] = int(guard_skips)
    if queue_depth is not None:
        record["queue_depth"] = queue_depth
    return record


def occupancy_from_spans(spans: Iterable[Sequence],
                         start_ns: int, end_ns: int) -> Dict[str, float]:
    """Per-category busy seconds inside [start_ns, end_ns) from span tuples
    (telemetry/spans.py shape). Overlapping spans of the SAME category are
    merged (union, not sum) — two threads both blocked on the infeed at the
    same instant is one stalled instant, and double-counting would push a
    fraction past 1.0."""
    window = max(0, int(end_ns) - int(start_ns))
    by_cat: Dict[str, list] = {}
    for name, cat, s0, dur, *_rest in spans:
        s1 = s0 + dur
        lo, hi = max(s0, start_ns), min(s1, end_ns)
        if hi > lo:
            by_cat.setdefault(cat, []).append((lo, hi))
    out: Dict[str, float] = {}
    for cat, ivals in by_cat.items():
        ivals.sort()
        busy = 0
        cur_lo, cur_hi = ivals[0]
        for lo, hi in ivals[1:]:
            if lo <= cur_hi:
                cur_hi = max(cur_hi, hi)
            else:
                busy += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
        busy += cur_hi - cur_lo
        out[cat] = min(busy, window) / 1e9
    return out


class StallAttributor:
    """Stateful helper binding the classification to the live registry and
    span recorder: `window(...)` for callers with their own accumulated
    waits (the trainer), `window_from_spans(...)` for callers that only
    bracketed the interval (tests, offline traces)."""

    def __init__(self, registry=None, recorder=None, *,
                 infeed_threshold: float = 0.25,
                 checkpoint_threshold: float = 0.25):
        self._registry = registry
        self._recorder = recorder
        self.infeed_threshold = float(infeed_threshold)
        self.checkpoint_threshold = float(checkpoint_threshold)

    def _queue_depth(self) -> Optional[float]:
        if self._registry is None:
            return None
        # direct gauge read — a snapshot() here would sweep every poller
        # (native ctypes calls) per log window just for one number
        return self._registry.gauge("prefetch/queue_depth")

    def window(self, *, wall_s: float, infeed_wait_s: float = 0.0,
               checkpoint_wait_s: float = 0.0,
               guard_skips: int = 0) -> Dict[str, object]:
        return classify(wall_s, infeed_wait_s, checkpoint_wait_s,
                        guard_skips,
                        infeed_threshold=self.infeed_threshold,
                        checkpoint_threshold=self.checkpoint_threshold,
                        queue_depth=self._queue_depth())

    def window_from_spans(self, start_ns: int, end_ns: int,
                          guard_skips: int = 0) -> Dict[str, object]:
        """Verdict from span overlaps alone: the interval's infeed /
        checkpoint occupancy is computed from the recorder's ring buffer.
        Requires the recorder to still hold the window (ring capacity)."""
        if self._recorder is None:
            raise ValueError("window_from_spans needs a recorder")
        occ = occupancy_from_spans(self._recorder.snapshot(),
                                   start_ns, end_ns)
        wall_s = max(1e-9, (end_ns - start_ns) / 1e9)
        infeed = sum(occ.get(c, 0.0) for c in INFEED_CATEGORIES)
        ckpt = sum(occ.get(c, 0.0) for c in CHECKPOINT_CATEGORIES)
        return classify(wall_s, infeed, ckpt, guard_skips,
                        infeed_threshold=self.infeed_threshold,
                        checkpoint_threshold=self.checkpoint_threshold,
                        queue_depth=self._queue_depth())

"""Admission controller — the ingest autotuner (data/autotune.py) reused
over one knob, the batch window.

The serving trade an operator cannot pin by hand is batch window against
queue depth: a wide window batches well but taxes every light-traffic
request with its whole wait; a narrow one keeps light traffic quick but
flushes small buckets under load, and the queue, not the window, becomes
the latency. The controller derives a verdict for each window from the
batcher's evidence and steers the window through the autotuner's
discipline: hysteresis (k consecutive verdicts), cooldown, bounded
geometric steps, hard rails, the oscillation freeze and the receipt
trail (actuation history, `autotune/*` counters: the controller class is
shared, so its namespace is too; the serving effects land in
`serving/*`).

Verdicts:

- ``queue_pressure`` -> observed as `infeed_bound`: the window is too
  narrow for the arrival rate — something shed, or the queue peaked at
  `queue_pressure_fraction` of its bound or more. The controller doubles
  the window toward its rail.
- ``steady`` -> observed as `compute_bound`: with
  `controller_relax_after_windows` > 0 a window the controller raised
  halves back toward the configured baseline after that many quiet
  windows.

The knob is `DynamicBatcher.window_ms` / `set_window_ms`, its rails
`serving.window_min_ms` / `window_max_ms`, its baseline
`serving.max_latency_ms`. The flight recorder is optional (`flight`, an
object with `record_actuation(act)`; the recorder waits for ROADMAP
A14c).
"""

from __future__ import annotations

from typing import Optional

from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.data.autotune import IngestAutotuner, Knob

#: The verdict of a pressured window (observed as the autotuner's UP
#: verdict) and of a quiet one.
PRESSURE_VERDICT = "queue_pressure"
STEADY_VERDICT = "steady"


class AdmissionController:
    """One batcher's admission-window feedback loop."""

    def __init__(self, serving_cfg, batcher, *, registry=None, flight=None):
        self.cfg = serving_cfg
        self.batcher = batcher
        self._reg = registry if registry is not None \
            else telemetry.get_registry()
        self._reg.counter("serving/controller_actuations")
        knob = Knob("batch_window_ms",
                    get=lambda: int(batcher.window_ms),
                    apply=batcher.set_window_ms,
                    min_value=max(1, int(serving_cfg.window_min_ms)),
                    max_value=max(1, int(serving_cfg.window_max_ms)),
                    geometric=True)
        self._tuner = IngestAutotuner(
            [knob], registry=self._reg, flight=flight,
            settings={
                "k_windows": serving_cfg.controller_k_windows,
                "cooldown_windows": serving_cfg.controller_cooldown_windows,
                "relax_after_windows":
                    serving_cfg.controller_relax_after_windows})
        self._last_verdict: Optional[str] = None

    def classify(self, stats: dict) -> str:
        """A window's stats (`DynamicBatcher.window_stats`) -> verdict."""
        pressure_depth = self.cfg.queue_pressure_fraction \
            * self.batcher.queue_limit
        if stats.get("shed", 0) > 0 \
                or stats.get("queue_peak", 0) >= pressure_depth:
            return PRESSURE_VERDICT
        return STEADY_VERDICT

    def observe_window(self, stats: dict) -> dict:
        """One controller window: classify, feed the autotuner (pressure
        as its UP verdict, steady as its relax verdict), and return the
        window's record with the serving verdict beside the autotuner's."""
        verdict = self.classify(stats)
        self._last_verdict = verdict
        mapped = "infeed_bound" if verdict == PRESSURE_VERDICT \
            else "compute_bound"
        record = self._tuner.observe({
            "verdict": mapped,
            "queue_peak": stats.get("queue_peak", 0),
            "shed": stats.get("shed", 0)})
        if record.get("actuations"):
            self._reg.inc("serving/controller_actuations",
                          len(record["actuations"]))
        self._reg.set_gauge("serving/window_ms", self.batcher.window_ms)
        record["serving_verdict"] = verdict
        return record

    @property
    def window_ms(self) -> int:
        return self.batcher.window_ms

    def describe(self) -> dict:
        """The controller's receipt: the autotuner's state (the knob
        against its rails, settled, the actuation history) with the
        verdicts it steers from and the last one seen."""
        out = self._tuner.describe()
        out["verdicts"] = [PRESSURE_VERDICT, STEADY_VERDICT]
        out["last_verdict"] = self._last_verdict
        return out

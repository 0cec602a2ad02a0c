"""Host-side non-finite step monitor — the counterpart of the JAX
package's ``resilience/guard.py NonFiniteGuard``.

The train step (train/step.py, `skip_nonfinite=True`) decides whether the
step was finite — `isfinite(loss + l2) & isfinite(grad_norm)` — drops the
update of a bad step and reports the decision as the `bad_step` metric.
This class is the host half: it counts consecutive skips and aborts with
a diagnostic once the run is clearly not training anymore. It resolves
each step's flag LAG steps after it was queued, as the reference does; a
flag may be a Python number or a 0-dim tensor.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

from distributed_vgg_f_tpu_torch.telemetry import get_registry


class NonFiniteStepError(RuntimeError):
    """Too many consecutive training steps were non-finite."""


class NonFiniteGuard:
    """Counts reported bad steps; raises after `max_consecutive`."""

    LAG = 2  # steps between a flag's arrival and its reading

    def __init__(self, max_consecutive: int,
                 log: Optional[Callable[[str, dict], None]] = None):
        if max_consecutive < 1:
            raise ValueError(
                f"max_consecutive must be >= 1, got {max_consecutive}")
        self.max_consecutive = max_consecutive
        self.consecutive = 0
        self.total = 0
        self._log = log
        self._pending: collections.deque = collections.deque()

    def observe(self, step: int, bad_flag) -> None:
        """Queue this step's `bad_step` flag; resolve the one from LAG
        steps ago. Raises NonFiniteStepError once `max_consecutive`
        consecutive steps were skipped."""
        self._pending.append((step, bad_flag))
        if len(self._pending) > self.LAG:
            self._check(*self._pending.popleft())

    def drain(self) -> None:
        """Resolve every still-queued flag (after the loop ends)."""
        while self._pending:
            self._check(*self._pending.popleft())

    def _check(self, step: int, bad_flag) -> None:
        if not float(bad_flag) > 0.0:
            self.consecutive = 0
            return
        self.consecutive += 1
        self.total += 1
        get_registry().inc("resilience/nonfinite_skips")
        if self._log is not None:
            self._log("nonfinite_step_skipped", {
                "step": step, "consecutive": self.consecutive,
                "total": self.total})
        if self.consecutive >= self.max_consecutive:
            get_registry().inc("resilience/nonfinite_aborts")
            raise NonFiniteStepError(
                f"{self.consecutive} consecutive training steps (through "
                f"step {step}) produced a non-finite loss or gradient norm; "
                f"their updates were skipped (parameters are unchanged "
                f"since step {step - self.consecutive}), but the run is not "
                f"training. Common causes: NaN input batches, an "
                f"out-of-range label space, or a diverging learning rate "
                f"(try optim.grad_clip_norm or a lower optim.base_lr). "
                f"{self.total} step(s) were skipped in total; the abort "
                f"threshold is train.max_nonfinite_steps="
                f"{self.max_consecutive}.")

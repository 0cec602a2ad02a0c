"""The port's stall attribution (distributed_vgg_f_tpu_torch/telemetry/
stall.py) against the JAX package's telemetry/stall.py on a seeded numpy
grid: `classify` (asymmetric thresholds, ties between the infeed and
checkpoint fractions, fractions on a threshold, guard skips, a queue
depth), `occupancy_from_spans` (overlapping spans of one category, spans
across the window's edges, empty windows) and `StallAttributor.window` /
`window_from_spans` over each package's own registry and span recorder
holding the same gauge and spans. Equal means equal: the records are
dicts of rounded floats, strings and ints, compared with ==."""

import numpy as np
import pytest

from distributed_vgg_f_tpu.telemetry import registry as jreg
from distributed_vgg_f_tpu.telemetry import spans as jspans
from distributed_vgg_f_tpu.telemetry import stall as jstall
from distributed_vgg_f_tpu_torch.telemetry import registry as preg
from distributed_vgg_f_tpu_torch.telemetry import schema
from distributed_vgg_f_tpu_torch.telemetry import spans as pspans
from distributed_vgg_f_tpu_torch.telemetry import stall as pstall

THRESHOLDS = [(0.25, 0.25), (0.4, 0.25), (0.25, 0.4), (0.1, 0.6),
              (0.5, 0.5), (1.0, 0.0)]


def _grid(seed, n=400):
    """(wall, infeed, ckpt, guard, queue_depth) rows: random waits, exact
    ties, waits on a threshold, zero and tiny walls."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        wall = float(rng.choice([rng.uniform(1e-3, 5.0), 0.0, 1e-12]))
        infeed = float(rng.uniform(0, 1.2) * wall)
        ckpt = float(rng.choice([rng.uniform(0, 1.2) * max(wall, 1e-9),
                                 infeed]))
        guard = int(rng.choice([0, 0, 0, 1, 3]))
        depth = rng.choice([None, 0, 2, 3.0])
        rows.append((wall, infeed, ckpt, guard,
                     None if depth is None else float(depth)))
    for t in (0.25, 0.4):
        rows += [(1.0, t, 0.0, 0, None), (1.0, 0.0, t, 0, None),
                 (1.0, t, t, 0, 1.0), (2.0, 2 * t, 2 * t, 0, 0.0),
                 (1.0, 0.35, 0.30, 0, None), (1.0, -0.5, 2.0, 0, None)]
    return rows


@pytest.mark.parametrize("thresholds", THRESHOLDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_classify_equals_jax(seed, thresholds):
    ti, tc = thresholds
    seen = set()
    for wall, infeed, ckpt, guard, depth in _grid(seed):
        kw = dict(infeed_threshold=ti, checkpoint_threshold=tc,
                  queue_depth=depth)
        got = pstall.classify(wall, infeed, ckpt, guard, **kw)
        want = jstall.classify(wall, infeed, ckpt, guard, **kw)
        assert got == want, (wall, infeed, ckpt, guard, depth, thresholds)
        errors = []
        schema.validate_stall_block(got, "stall", errors)
        assert errors == []
        seen.add(got["verdict"])
    assert pstall.VERDICTS == jstall.VERDICTS
    assert seen <= set(pstall.VERDICTS) and len(seen) >= 3


def _spans(rng, n, t0, t1):
    cats = ["infeed", "checkpoint", "infeed_source", "coord"]
    out = []
    for _ in range(n):
        s0 = int(rng.integers(t0 - 2_000_000, t1))
        dur = int(rng.integers(0, 4_000_000))
        out.append((f"s{len(out)}", str(rng.choice(cats)), s0, dur,
                    int(rng.integers(1, 4))))
    # two overlapping spans of one category and one inside another
    out += [("a", "infeed", t0 + 100, 5_000, 1),
            ("b", "infeed", t0 + 2_000, 9_000, 2),
            ("c", "infeed", t0 + 3_000, 10, 3)]
    return out


@pytest.mark.parametrize("seed", range(6))
def test_occupancy_from_spans_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    t0 = 1_000_000_000
    t1 = t0 + int(rng.integers(0, 20_000_000))
    spans = _spans(rng, int(rng.integers(0, 60)), t0, t1)
    for lo, hi in ((t0, t1), (t1, t0), (t0 + 50, t0 + 60)):
        assert pstall.occupancy_from_spans(spans, lo, hi) == \
            jstall.occupancy_from_spans(spans, lo, hi)


@pytest.mark.parametrize("seed", range(4))
def test_attributor_windows_equal_jax(seed):
    rng = np.random.default_rng(200 + seed)
    t0 = 5_000_000_000
    t1 = t0 + int(rng.integers(1_000_000, 30_000_000))
    spans = _spans(rng, 40, t0, t1)
    regs = (preg.TelemetryRegistry(), jreg.TelemetryRegistry())
    recs = (pspans.SpanRecorder(), jspans.SpanRecorder())
    depth = float(rng.integers(0, 4))
    for reg in regs:
        reg.set_gauge("prefetch/queue_depth", depth)
    for rec in recs:
        for name, cat, s0, dur, _ in spans:
            rec.record(name, cat, s0, dur)
    for ti, tc in THRESHOLDS:
        port = pstall.StallAttributor(regs[0], recs[0], infeed_threshold=ti,
                                      checkpoint_threshold=tc)
        ref = jstall.StallAttributor(regs[1], recs[1], infeed_threshold=ti,
                                     checkpoint_threshold=tc)
        for guard in (0, 2):
            got = port.window_from_spans(t0, t1, guard_skips=guard)
            assert got == ref.window_from_spans(t0, t1, guard_skips=guard)
            assert got["queue_depth"] == depth
            wall = float(rng.uniform(0.01, 1.0))
            waits = dict(infeed_wait_s=float(rng.uniform(0, wall)),
                         checkpoint_wait_s=float(rng.uniform(0, wall)))
            assert port.window(wall_s=wall, guard_skips=guard, **waits) == \
                ref.window(wall_s=wall, guard_skips=guard, **waits)
    with pytest.raises(ValueError, match="recorder"):
        pstall.StallAttributor().window_from_spans(0, 1)
    # no registry: no queue depth, as in JAX
    assert "queue_depth" not in pstall.StallAttributor().window(wall_s=1.0)


def test_stall_validator_refuses_bad_blocks():
    for block, fragment in (
            ([], "not an object"),
            ({"verdict": "slow", "infeed_fraction": 0.1,
              "checkpoint_fraction": 0.0}, "'verdict'"),
            ({"verdict": "infeed_bound", "infeed_fraction": 1.5,
              "checkpoint_fraction": 0.0}, "infeed_fraction"),
            ({"verdict": "guard_stalled", "infeed_fraction": 0.0,
              "checkpoint_fraction": 0.0, "guard_skips": 0},
             "guard_skips"),
            ({"verdict": "compute_bound", "infeed_fraction": 0.0,
              "checkpoint_fraction": 0.0, "eval_seconds": -1.0},
             "eval_seconds")):
        errors = []
        schema.validate_stall_block(block, "stall", errors)
        assert errors and fragment in errors[0], (block, errors)

"""The port's admission controller (distributed_vgg_f_tpu_torch/serving/
controller.py) against the JAX package's, and the port's server driving
it, on the CPU.

- Fed the same sequence of window stats over fake batchers, the port's
  `AdmissionController` and JAX's give the same verdicts, the same
  actuations (window, knob, from, to, direction), the same `blocked`
  reasons and the same `window_ms` trajectory, with the serving
  defaults and with other hysteresis settings.
- The batcher's window stats carry the queue's peak since the last poll
  (reset at each poll) beside the lifetime peak of `describe()`, and
  `set_window_ms` changes the window of the batch forming now.
- The port's server (controller on, `controller_interval_s` 0.05 s)
  under a burst past `queue_limit` sheds, widens its window, then
  relaxes back to the configured baseline once traffic stops."""

import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.config import ModelConfig, ServingConfig
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.serving.batcher import DynamicBatcher
from distributed_vgg_f_tpu_torch.serving.controller import \
    AdmissionController
from distributed_vgg_f_tpu_torch.serving.engine import PredictEngine
from distributed_vgg_f_tpu_torch.serving.server import PredictServer
from distributed_vgg_f_tpu_torch.weights import init_params, load_params

SIZE, CLASSES = 32, 10


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


class _FakeBatcher:
    """The knob surface of DynamicBatcher, nothing else."""

    def __init__(self, window_ms, queue_limit):
        self.window_ms = int(window_ms)
        self.queue_limit = int(queue_limit)

    def set_window_ms(self, ms):
        self.window_ms = max(1, int(ms))
        return self.window_ms


def _stats_sequence(seed, n=60, queue_limit=32):
    """Bursts of pressure (sheds or a high peak) between quiet stretches."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        phase = (i // 10) % 3
        if phase == 0:      # a burst
            out.append({"shed": int(rng.integers(0, 3)),
                        "queue_peak": int(rng.integers(queue_limit // 2,
                                                       queue_limit + 1)),
                        "admitted": 40, "completed": 40,
                        "queue_depth": 3, "latencies_ms": [5.0]})
        elif phase == 1:    # quiet
            out.append({"shed": 0, "queue_peak": int(rng.integers(0, 4)),
                        "admitted": 2, "completed": 2, "queue_depth": 0,
                        "latencies_ms": []})
        else:               # mixed
            hot = bool(rng.random() < 0.4)
            out.append({"shed": int(hot), "queue_peak":
                        int(rng.integers(0, queue_limit)),
                        "admitted": 10, "completed": 10, "queue_depth": 1,
                        "latencies_ms": [2.0]})
    return out


def _strip(record):
    acts = [{k: v for k, v in a.items() if k != "ts_unix"}
            for a in record.get("actuations", [])]
    return (record["serving_verdict"], record["verdict"],
            record.get("blocked"), record["knobs"], acts,
            record["settled"])


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, {}),
    (2, dict(controller_k_windows=1, controller_cooldown_windows=0,
             controller_relax_after_windows=1)),
    (3, dict(controller_k_windows=2, controller_relax_after_windows=0,
             max_latency_ms=4.0, window_min_ms=2.0, window_max_ms=64.0,
             queue_pressure_fraction=0.25))])
def test_controller_decisions_match_jax(seed, kw):
    from distributed_vgg_f_tpu import telemetry as jtelemetry
    from distributed_vgg_f_tpu.serving.controller import \
        AdmissionController as JaxController
    ours_cfg, jax_cfg = ServingConfig(**kw), jcfg.ServingConfig(**kw)
    ours_b = _FakeBatcher(ours_cfg.max_latency_ms, ours_cfg.queue_limit)
    jax_b = _FakeBatcher(jax_cfg.max_latency_ms, jax_cfg.queue_limit)
    ours = AdmissionController(ours_cfg, ours_b)

    class _NoFlight:
        def record_actuation(self, act):
            pass

    theirs = JaxController(jax_cfg, jax_b,
                           registry=jtelemetry.TelemetryRegistry(),
                           flight=_NoFlight())
    moves = 0
    for stats in _stats_sequence(seed, queue_limit=ours_cfg.queue_limit):
        got = ours.observe_window(dict(stats))
        want = theirs.observe_window(dict(stats))
        assert _strip(got) == _strip(want)
        assert ours_b.window_ms == jax_b.window_ms
        moves += len(got.get("actuations", []))
    assert moves > 0
    reg = telemetry.get_registry()
    assert reg.counter_value("serving/controller_actuations") == moves
    assert reg.gauge("serving/window_ms") == ours_b.window_ms
    got, want = ours.describe(), theirs.describe()
    for key in ("windows", "settled", "actuations_total", "streak",
                "verdicts", "last_verdict"):
        assert got[key] == want[key], key
    for g, w in zip(got["knobs"], want["knobs"]):
        assert g == {k: w[k] for k in g}
    assert [{k: v for k, v in a.items() if k != "ts_unix"}
            for a in got["history"]] \
        == [{k: v for k, v in a.items() if k != "ts_unix"}
            for a in want["history"]]


def _engine():
    cfg = ModelConfig(num_classes=CLASSES, compute_dtype="float32",
                      extra={"stem_features": 8, "conv_features": 16,
                             "fc_features": 32})
    model = load_params(build_model(cfg, image_size=SIZE),
                        init_params(cfg, 0, image_size=SIZE))
    return PredictEngine(model_name="vggf", model=model, image_size=SIZE,
                         num_classes=CLASSES, buckets=(1, 2), max_batch=2,
                         device="cpu")


class _SlowEngine:
    def __init__(self, engine, delay_s):
        self._engine = engine
        self.delay_s = delay_s

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def run(self, images):
        time.sleep(self.delay_s)
        return self._engine.run(images)


def test_batcher_window_stats_peak_and_live_window():
    engine = _SlowEngine(_engine(), 0.05)
    batcher = DynamicBatcher(engine, max_batch=1, window_ms=10,
                             queue_limit=16)
    img = np.zeros((SIZE, SIZE, 3), np.uint8)
    try:
        pending = [batcher.submit(img) for _ in range(6)]
        first = batcher.window_stats()
        assert first["queue_peak"] >= 5 and first["admitted"] == 6
        for p in pending:
            assert p.event.wait(30)
        stats = batcher.window_stats()
        # the peak since the previous poll: reset to the depth then, and
        # nothing was admitted since
        assert stats["queue_peak"] == first["queue_depth"]
        assert first["completed"] + stats["completed"] == 6
        assert batcher.window_stats()["queue_peak"] == 0
        assert batcher.describe()["queue_peak"] >= 5
        assert batcher.set_window_ms(40) == 40 == batcher.window_ms
    finally:
        batcher.close()
    # a wider window set while a batch forms holds that batch longer
    batcher = DynamicBatcher(_engine(), max_batch=2, window_ms=2000,
                             queue_limit=4)
    try:
        t0 = time.monotonic()
        p = batcher.submit(img)
        time.sleep(0.05)
        batcher.set_window_ms(1)
        assert p.event.wait(30)
        assert time.monotonic() - t0 < 1.0
    finally:
        batcher.close()


def test_server_widens_under_a_burst_then_relaxes():
    cfg = ServingConfig(max_batch=1, buckets=(1,), queue_limit=4,
                        max_latency_ms=5.0, window_max_ms=80.0,
                        warmup=False, controller_interval_s=0.05,
                        controller_k_windows=1,
                        controller_cooldown_windows=0,
                        controller_relax_after_windows=2)
    server = PredictServer(cfg)
    server.add_engine(_SlowEngine(_engine(), 0.03))
    port = server.start()
    img = np.zeros((SIZE, SIZE, 3), np.uint8)
    statuses = []

    def post():
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/predict/vggf", data=img.tobytes(),
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                statuses.append(r.status)
        except urllib.error.HTTPError as e:
            statuses.append(e.code)

    try:
        # one burst past the queue's bound (a second would flip the knob
        # twice, and the oscillation guard would freeze it)
        threads = [threading.Thread(target=post) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert 503 in statuses and 200 in statuses
        ctrl = server.controller("vggf")
        widest = max(r["records"][("vggf", "fp32")]["window_ms"]
                     for r in server.window_log)
        assert widest > 5
        deadline = time.monotonic() + 30
        while server.batcher("vggf").window_ms != 5:
            assert time.monotonic() < deadline, ctrl.describe()
            time.sleep(0.05)
        hist = ctrl.describe()["history"]
        assert [a["direction"] for a in hist][:1] == ["up"]
        assert hist[-1]["direction"] == "down" and hist[-1]["to"] == 5
        verdicts = [r["records"][("vggf", "fp32")]["serving_verdict"]
                    for r in server.window_log]
        assert "queue_pressure" in verdicts and verdicts[-1] == "steady"
        reg = telemetry.get_registry()
        assert reg.counter_value("serving/controller_actuations") \
            == len(hist) >= 2
        # every move replays: a fresh controller fed the recorded window
        # stats makes the same verdicts and moves the window alike
        fake = _FakeBatcher(cfg.max_latency_ms, cfg.queue_limit)
        fresh = AdmissionController(cfg, fake,
                                    registry=telemetry.TelemetryRegistry())
        for r in list(server.window_log):
            rec = r["records"][("vggf", "fp32")]
            again = fresh.observe_window(rec["stats"])
            assert again["serving_verdict"] == rec["serving_verdict"]
            assert [(a["from"], a["to"]) for a in
                    again.get("actuations", [])] \
                == [(a["from"], a["to"]) for a in rec.get("actuations", [])]
            assert fake.window_ms == rec["window_ms"]
    finally:
        server.close()

"""Predict server — the u8-wire HTTP front end over the dynamic batcher.

    POST /v1/predict/<model>[?tier=<t>&k=<k>]
                                    body: raw uint8 pixels, C-order,
                                    exactly image_size*image_size*3 bytes
    → 200 {"model", ["tier",] "top_k": [{"class", "prob"}...], "bucket",
           "latency_ms"}            prob at full precision
    → 400 {"error": "bad_request", ...}      wrong size/model/tier
    → 503 {"error": "overloaded", "kind": "shed"|"draining",
           "queue_depth", "queue_limit", "retry_after_ms"}
                                    + Retry-After header
    → 504 {"error": "timeout"}      nothing answered within
                                    serving.request_timeout_s
    GET  /v1/models                 the routing table

One server fronts many models: `add_engine` registers one engine, its
batcher and (with `serving.controller`) its admission controller
(serving/controller.py) per (model, tier). The housekeeping thread runs
once every `serving.controller_interval_s`: it feeds each controller its
batcher's window and refreshes the `serving/*` gauges of the process
registry (telemetry/registry.py).

Latency tiers: a request picks its tier with `?tier=fp32|bf16|int8|
student` (an unknown value is a typed 400 naming the ladder); without
the parameter it gets `serving.tier_default`, or fp32 where the model has
no engine of that tier. Each tier is an engine with its own batcher, so
batches never mix tiers and each tier's latency quantiles
(`serving/tier_latency_*`) are its own. The kill switch
`serving.tiers.enabled` (off by default): off, `add_engine` refuses
non-fp32 engines, `?tier=` is ignored, and the responses and the table
carry no tier.

The `/servingz` page (`servingz_payload`) and the flight recorder wait
for the exporter of ROADMAP A14c.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.config import SERVING_TIERS
from distributed_vgg_f_tpu_torch.serving.batcher import (DynamicBatcher,
                                                         OverloadShed)
from distributed_vgg_f_tpu_torch.serving.controller import (
    STEADY_VERDICT, AdmissionController)
from distributed_vgg_f_tpu_torch.serving.engine import PredictEngine
from distributed_vgg_f_tpu_torch.train.predict import top_k_records


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    #: listen() backlog: a burst must reach the admission queue and shed
    #: with a typed 503, not die as connection resets below it
    request_queue_size = 512


def _precreate(reg) -> None:
    """Counters/gauges created at server start: a visible zero reads as
    "instrumented, nothing happened". One literal per (tier, metric)."""
    reg.counter("serving/requests")
    reg.counter("serving/admitted")
    reg.counter("serving/shed")
    reg.counter("serving/errors")
    reg.counter("serving/batches")
    reg.counter("serving/batch_images")
    reg.counter("serving/padded_images")
    reg.counter("serving/controller_actuations")
    reg.set_gauge("serving/queue_depth", 0)
    reg.set_gauge("serving/models", 0)
    reg.set_gauge("serving/shed_rate", 0.0)
    reg.set_gauge("serving/window_ms", 0)
    reg.set_gauge("serving/latency_p50_ms", 0.0)
    reg.set_gauge("serving/latency_p95_ms", 0.0)
    reg.set_gauge("serving/latency_p99_ms", 0.0)
    reg.counter("serving/tier_requests_fp32")
    reg.counter("serving/tier_requests_bf16")
    reg.counter("serving/tier_requests_int8")
    reg.counter("serving/tier_requests_student")
    reg.set_gauge("serving/tier_latency_p50_ms_fp32", 0.0)
    reg.set_gauge("serving/tier_latency_p50_ms_bf16", 0.0)
    reg.set_gauge("serving/tier_latency_p50_ms_int8", 0.0)
    reg.set_gauge("serving/tier_latency_p50_ms_student", 0.0)
    reg.set_gauge("serving/tier_latency_p99_ms_fp32", 0.0)
    reg.set_gauge("serving/tier_latency_p99_ms_bf16", 0.0)
    reg.set_gauge("serving/tier_latency_p99_ms_int8", 0.0)
    reg.set_gauge("serving/tier_latency_p99_ms_student", 0.0)


class PredictServer:
    """HTTP front end + (model, tier) router + housekeeping loop."""

    def __init__(self, serving_cfg, *, registry=None):
        self.cfg = serving_cfg
        self._reg = registry if registry is not None \
            else telemetry.get_registry()
        _precreate(self._reg)
        # routing key (model, tier): one engine and one batcher a pair
        self._engines: Dict[tuple, PredictEngine] = {}
        self._batchers: Dict[tuple, DynamicBatcher] = {}
        self._controllers: Dict[tuple, AdmissionController] = {}
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._house_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._windows = 0
        self._started_mono = time.monotonic()
        #: the last 4096 housekeeping windows: {"window", "records":
        #: (model, tier) -> the controller's window record (or only the
        #: verdict without a controller), the batcher's stats and the
        #: window in force after it}
        self.window_log: deque = deque(maxlen=4096)

    # --------------------------------------------------------------- routing
    def _tiers_enabled(self) -> bool:
        return bool(self.cfg.tiers.enabled)

    def add_engine(self, engine: PredictEngine) -> None:
        """Register one (model, tier) engine with its own batcher and, with
        `serving.controller`, its admission controller. With
        `serving.tiers.enabled` false only fp32 engines register."""
        tier = str(getattr(engine, "tier", "fp32"))
        if tier != "fp32" and not self._tiers_enabled():
            raise ValueError(
                f"engine ({engine.model_name!r}, tier={tier!r}) refused: "
                "serving.tiers.enabled is false — the kill switch pins "
                "this server to the fp32-only surface")
        key = (engine.model_name, tier)
        with self._lock:
            if key in self._engines:
                raise ValueError(f"model {engine.model_name!r} tier "
                                 f"{tier!r} already registered")
            batcher = DynamicBatcher(
                engine, max_batch=self.cfg.max_batch,
                window_ms=self.cfg.max_latency_ms,
                queue_limit=self.cfg.queue_limit,
                # entries older than the request timeout are expired, never
                # run: their handlers already replied 504
                reap_after_s=self.cfg.request_timeout_s,
                registry=self._reg)
            self._engines[key] = engine
            self._batchers[key] = batcher
            if self.cfg.controller:
                self._controllers[key] = AdmissionController(
                    self.cfg, batcher, registry=self._reg)
            # distinct models, not engines
            self._reg.set_gauge(
                "serving/models", len({m for m, _ in self._engines}))
        if self.cfg.warmup:
            engine.warmup()

    def engine(self, model: str,
               tier: str = "fp32") -> Optional[PredictEngine]:
        with self._lock:
            return self._engines.get((model, tier))

    def batcher(self, model: str,
                tier: str = "fp32") -> Optional[DynamicBatcher]:
        with self._lock:
            return self._batchers.get((model, tier))

    def controller(self, model: str,
                   tier: str = "fp32") -> Optional[AdmissionController]:
        with self._lock:
            return self._controllers.get((model, tier))

    def _model_tiers(self, model: str):
        """The tiers registered for one model, in ladder order."""
        with self._lock:
            mine = {t for m, t in self._engines if m == model}
        return [t for t in SERVING_TIERS if t in mine]

    # ------------------------------------------------------------- lifecycle
    @property
    def port(self) -> Optional[int]:
        return self._server.server_address[1] if self._server else None

    @property
    def endpoint(self) -> str:
        return f"{self.cfg.host}:{self.port}"

    def start(self) -> int:
        """Bind + serve + start housekeeping; returns the BOUND port."""
        if self._server is not None:
            return self.port
        srv = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: N802 — quiet
                pass

            def do_POST(self):  # noqa: N802
                srv._handle_post(self)

            def do_GET(self):  # noqa: N802
                srv._handle_get(self)

        self._server = _HTTPServer(
            (self.cfg.host, int(self.cfg.port)), Handler)
        self._started_mono = time.monotonic()
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, name="serving-http",
            daemon=True)
        self._serve_thread.start()
        self._house_thread = threading.Thread(
            target=self._housekeeping, name="serving-housekeeping",
            daemon=True)
        self._house_thread.start()
        return self.port

    def wait(self) -> None:
        """Block the caller (the CLI's serve mode) until close()."""
        self._closed.wait()

    def close(self) -> None:
        """Drain, don't drop: stop the listener and admission, answer every
        in-flight request, then join the threads."""
        if self._closed.is_set():
            return
        self._closed.set()
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        with self._lock:
            batchers = list(self._batchers.values())
        for b in batchers:
            b.close()
        for t in (self._serve_thread, self._house_thread):
            if t is not None:
                t.join(timeout=10)

    # ---------------------------------------------------------- housekeeping
    def _housekeeping(self) -> None:
        interval = max(0.01, float(self.cfg.controller_interval_s))
        while not self._closed.wait(interval):
            try:
                self.refresh_gauges()
            except Exception:  # noqa: BLE001 — receipts never kill serving
                self._reg.inc("serving/errors")

    def refresh_gauges(self) -> None:
        """One window: each batcher's stats to its controller, then the
        gauges — queue depth summed and the widest window over every
        (model, tier), shed rate, latency quantiles overall and a tier —
        and the window's records appended to `window_log`."""
        self._windows += 1
        lat_all: list = []
        lat_by_tier: Dict[str, list] = {}
        shed = admitted = depth_total = window_max = 0
        records: Dict[tuple, dict] = {}
        with self._lock:
            items = list(self._batchers.items())
            controllers = dict(self._controllers)
        for key, batcher in items:
            stats = batcher.window_stats()
            lat_all.extend(stats["latencies_ms"])
            lat_by_tier.setdefault(key[1], []).extend(stats["latencies_ms"])
            shed += stats["shed"]
            admitted += stats["admitted"]
            depth_total += stats["queue_depth"]
            ctrl = controllers.get(key)
            records[key] = ctrl.observe_window(stats) if ctrl is not None \
                else {"serving_verdict": STEADY_VERDICT}
            records[key]["stats"] = {k: v for k, v in stats.items()
                                     if k != "latencies_ms"}
            records[key]["window_ms"] = batcher.window_ms
            window_max = max(window_max, batcher.window_ms)
        self._reg.set_gauge("serving/queue_depth", depth_total)
        self._reg.set_gauge("serving/window_ms", window_max)
        total = shed + admitted
        self._reg.set_gauge("serving/shed_rate",
                            round(shed / total, 4) if total else 0.0)
        for q, value in _quantiles(lat_all).items():
            self._reg.set_gauge(f"serving/latency_{q}_ms", value)
        for tier, lats in lat_by_tier.items():
            tq = _quantiles(lats)
            if tq:
                self._reg.set_gauge(
                    f"serving/tier_latency_p50_ms_{tier}", tq["p50"])
                self._reg.set_gauge(
                    f"serving/tier_latency_p99_ms_{tier}", tq["p99"])
        self.window_log.append({"window": self._windows,
                                "records": records})

    # -------------------------------------------------------------- handling
    def _handle_post(self, req: BaseHTTPRequestHandler) -> None:
        self._reg.inc("serving/requests")
        t0 = time.monotonic()
        try:
            path, _, query = req.path.partition("?")
            if not path.startswith("/v1/predict/"):
                _reply(req, 404, {"error": "not found",
                                  "endpoints": ["/v1/predict/<model>",
                                                "/v1/models"]})
                return
            model = path[len("/v1/predict/"):].strip("/")
            tiers_on = self._tiers_enabled()
            requested = _tier_from_query(query) if tiers_on else None
            if requested is not None and requested not in SERVING_TIERS:
                # names the offending value and the ladder
                _reply(req, 400, {"error": "bad_request",
                                  "detail": f"unknown tier {requested!r}",
                                  "tier": requested,
                                  "tiers": list(SERVING_TIERS)})
                return
            tier = requested if requested is not None else (
                self.cfg.tier_default if tiers_on else "fp32")
            engine = self.engine(model, tier)
            if engine is None and requested is None and tier != "fp32":
                # an implicit default the model lacks degrades to fp32; an
                # explicit ask is never substituted (400 below)
                tier = "fp32"
                engine = self.engine(model, tier)
            if engine is None:
                registered = self._model_tiers(model)
                if registered:
                    _reply(req, 400, {
                        "error": "bad_request",
                        "detail": f"model {model!r} does not serve tier "
                                  f"{tier!r}",
                        "tier": tier, "tiers": registered})
                    return
                with self._lock:
                    known = sorted({m for m, _ in self._engines})
                _reply(req, 400, {"error": "bad_request",
                                  "detail": f"unknown model {model!r}",
                                  "models": known})
                return
            self._reg.inc(f"serving/tier_requests_{tier}")
            length = int(req.headers.get("Content-Length") or 0)
            expect = engine.image_size * engine.image_size * 3
            if length != expect:
                _reply(req, 400, {
                    "error": "bad_request",
                    "detail": f"payload must be exactly {expect} bytes of "
                              f"raw uint8 pixels "
                              f"({engine.image_size}x{engine.image_size}"
                              f"x3, the u8 wire), got {length}"})
                return
            body = req.rfile.read(length)
            if len(body) != length:
                _reply(req, 400, {
                    "error": "bad_request",
                    "detail": f"body truncated: declared {length} bytes, "
                              f"received {len(body)}"})
                return
            image = np.frombuffer(body, np.uint8).reshape(
                engine.image_size, engine.image_size, 3)
            batcher = self.batcher(model, tier)
            try:
                pending = batcher.submit(image)
            except OverloadShed as shed:
                # the header is second-granular: round the hint UP so a
                # compliant client never retries early
                retry_s = -(-int(self.cfg.shed_retry_after_ms) // 1000) or 1
                _reply(req, 503, {
                    "error": "overloaded", "kind": shed.kind,
                    "model": model,
                    "queue_depth": shed.queue_depth,
                    "queue_limit": shed.queue_limit,
                    "retry_after_ms": int(self.cfg.shed_retry_after_ms),
                }, headers={"Retry-After": str(retry_s)})
                return
            if not pending.event.wait(float(self.cfg.request_timeout_s)):
                self._reg.inc("serving/errors")
                _reply(req, 504, {"error": "timeout", "model": model,
                                  "timeout_s": self.cfg.request_timeout_s})
                return
            if pending.error is not None:
                self._reg.inc("serving/errors")
                if isinstance(pending.error, TimeoutError):
                    _reply(req, 504, {"error": "timeout", "model": model,
                                      "detail": str(pending.error)})
                    return
                _reply(req, 500, {"error": "predict_failed",
                                  "detail": repr(pending.error)})
                return
            k = _top_k_from_query(query, engine.num_classes)
            _reply(req, 200, {
                "model": model,
                # the answering tier rides the body only with tiers on
                **({"tier": tier} if tiers_on else {}),
                "top_k": top_k_records(pending.probs, k),
                "bucket": pending.bucket,
                "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
            })
        except (BrokenPipeError, ConnectionError):
            pass  # client hung up
        except Exception as e:  # noqa: BLE001 — a request must never kill
            self._reg.inc("serving/errors")
            try:
                _reply(req, 500, {"error": "internal", "detail": repr(e)})
            except OSError:
                pass

    def _handle_get(self, req: BaseHTTPRequestHandler) -> None:
        self._reg.inc("serving/requests")
        path = req.path.split("?", 1)[0].rstrip("/")
        if path == "/v1/models":
            tiers_on = self._tiers_enabled()
            with self._lock:
                engines = dict(self._engines)
            rows: Dict[str, dict] = {}
            for (name, tier), eng in engines.items():
                # the row is the fp32 engine's; the ladder rides a "tiers"
                # sub-table when the tier plane is on
                if tier == "fp32":
                    base = dict(eng.describe())
                    base.update(rows.get(name) or {})
                    rows[name] = base
                if tiers_on:
                    rows.setdefault(name, {}).setdefault(
                        "tiers", {})[tier] = eng.describe()
            _reply(req, 200, {"models": rows})
            return
        _reply(req, 404, {"error": "not found",
                          "endpoints": ["/v1/predict/<model>",
                                        "/v1/models"]})

    # -------------------------------------------------------------- receipts
    def servingz_payload(self) -> dict:
        """The live admission state (the payload the `/servingz` route of
        ROADMAP A14c will serve): queue depth, bucket occupancy, shed
        rate, windows, controller receipts — and with tiers on, each
        model's ladder and the ladder's build receipt."""
        tiers_on = self._tiers_enabled()
        with self._lock:
            models: Dict[str, dict] = {}
            for key in sorted(self._engines):
                name, tier = key
                row = {"engine": self._engines[key].describe(),
                       "admission": self._batchers[key].describe()}
                ctrl = self._controllers.get(key)
                if ctrl is not None:
                    row["controller"] = ctrl.describe()
                if tier == "fp32":
                    models.setdefault(name, {}).update(row)
                if tiers_on:
                    models.setdefault(name, {}).setdefault(
                        "tiers", {})[tier] = row
        payload = {"enabled": True,
                   "endpoint": self.endpoint if self._server else None,
                   "uptime_s": round(
                       time.monotonic() - self._started_mono, 3),
                   "windows": self._windows,
                   "shed_rate": self._reg.gauge("serving/shed_rate", 0.0),
                   "latency_ms": {
                       q: self._reg.gauge(f"serving/latency_{q}_ms")
                       for q in ("p50", "p95", "p99")},
                   "models": models}
        if tiers_on:
            payload["tier_default"] = self.cfg.tier_default
            payload["ladder"] = self.ladder_receipt()
        return payload

    def ladder_receipt(self) -> dict:
        """Each (model, tier)'s build cost: the bucket -> first-run
        seconds and the HBM residency estimate."""
        with self._lock:
            engines = dict(self._engines)
        out: Dict[str, dict] = {}
        for (name, tier), eng in sorted(engines.items()):
            out.setdefault(name, {})[tier] = {
                "served_by": eng.served_by,
                "warmup_s": {str(b): s for b, s in
                             sorted(eng.compile_log.items())},
                "hbm_estimate_bytes": int(eng.hbm_estimate_bytes)}
        return out


def _quantiles(latencies_ms) -> dict:
    if not latencies_ms:
        return {}
    arr = np.asarray(latencies_ms, np.float64)
    return {"p50": round(float(np.percentile(arr, 50)), 3),
            "p95": round(float(np.percentile(arr, 95)), 3),
            "p99": round(float(np.percentile(arr, 99)), 3)}


def _tier_from_query(query: str) -> Optional[str]:
    """The `?tier=` value as sent (the caller validates it: an unknown
    value is a 400 naming the ladder, never a silent default)."""
    for part in (query or "").split("&"):
        key, sep, value = part.partition("=")
        if sep and key == "tier":
            return value
    return None


def _top_k_from_query(query: str, num_classes: int, default: int = 5) -> int:
    k = default
    for part in (query or "").split("&"):
        key, sep, value = part.partition("=")
        if sep and key == "k":
            try:
                k = int(value)
            except ValueError:
                pass
    return max(1, min(k, num_classes))


def _reply(req: BaseHTTPRequestHandler, status: int, payload: dict,
           headers: Optional[dict] = None) -> None:
    body = json.dumps(payload).encode()
    req.send_response(status)
    req.send_header("Content-Type", "application/json")
    req.send_header("Content-Length", str(len(body)))
    for key, value in (headers or {}).items():
        req.send_header(key, value)
    req.end_headers()
    req.wfile.write(body)


def serve_from_params(cfg, params, *, batch_stats=None, device="cuda",
                      start: bool = True) -> PredictServer:
    """One engine over `params` (a Flax param tree, e.g. from
    weights.load_npz or weights.init_params) and, for a model with
    BatchNorm, `batch_stats` (its Flax `batch_stats` tree: the npz's
    ``batch_stats`` entry, or weights.init_batch_stats) for `cfg.model`
    (its `extra` included, e.g. ViT's attention layout), routed under the
    model's name, behind a server configured by `cfg.serving`."""
    from distributed_vgg_f_tpu_torch.device import resolve_device
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.weights import load_params
    dev = resolve_device(device)
    model = build_model(cfg.model, image_size=cfg.data.image_size)
    load_params(model, params, batch_stats)
    engine = PredictEngine(
        model_name=cfg.model.name, model=model,
        image_size=cfg.data.image_size, num_classes=cfg.model.num_classes,
        buckets=cfg.serving.buckets, max_batch=cfg.serving.max_batch,
        image_dtype=cfg.data.image_dtype, mean_rgb=cfg.data.mean_rgb,
        stddev_rgb=cfg.data.stddev_rgb, device=dev)
    server = PredictServer(cfg.serving)
    server.add_engine(engine)
    if start:
        server.start()
    return server


def serve_from_trainer(trainer, *, start: bool = True) -> PredictServer:
    """The `--mode serve` entry: one engine over the trainer's checkpoint
    (run_predict's restore, which reads a ZeRO-3 checkpoint's flat params
    as any other), routed under the configured model's name.
    With `serving.tiers.enabled` the tiers derivable from it are built
    over that base engine: bf16, and int8 for the vggf family; the
    student tier needs its own distilled weights (train/distill.py) and
    is added with `tiers.build_student_engine` and `add_engine`. Logs the
    `serving_start` record with the ladder's build receipt."""
    cfg = trainer.cfg
    server = PredictServer(cfg.serving)
    base = PredictEngine.from_trainer(trainer)
    server.add_engine(base)
    if cfg.serving.tiers.enabled:
        from distributed_vgg_f_tpu_torch.serving.tiers import \
            build_tier_engines
        tiers = ["bf16"]
        # int8 quantizes the CNN-F head stack: the vggf family only
        if cfg.model.name.startswith("vggf"):
            tiers.append("int8")
        for eng in build_tier_engines(base, cfg.serving.tiers,
                                      tiers=tiers).values():
            server.add_engine(eng)
    if start:
        server.start()
    trainer.log("serving_start", {
        "endpoint": server.endpoint if start else None,
        "tiers_enabled": server._tiers_enabled(),
        "ladder": server.ladder_receipt()})
    return server

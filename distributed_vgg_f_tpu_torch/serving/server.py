"""Predict server — the u8-wire HTTP front end over the dynamic batcher.

    POST /v1/predict/<model>        body: raw uint8 pixels, C-order,
                                    exactly image_size*image_size*3 bytes
    → 200 {"model", "top_k": [{"class", "prob"}...], "bucket",
           "latency_ms"}            prob at full precision
    → 400 {"error": "bad_request", ...}      wrong size/model
    → 503 {"error": "overloaded", "kind": "shed"|"draining",
           "queue_depth", "queue_limit", "retry_after_ms"}
                                    + Retry-After header
    → 504 {"error": "timeout"}      nothing answered within
                                    serving.request_timeout_s
    GET  /v1/models                 the routing table

`serving/*` counters and latency-quantile gauges land in the process
registry (telemetry/registry.py); a housekeeping thread refreshes the
gauges once a window. One server fronts many models: `add_engine`
registers one engine and its batcher per model name. This slice serves
the fp32-route engine per model; the tier ladder, the admission
controller and the exporter come with later slices.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.serving.batcher import (DynamicBatcher,
                                                         OverloadShed)
from distributed_vgg_f_tpu_torch.serving.engine import PredictEngine
from distributed_vgg_f_tpu_torch.train.predict import top_k_records

#: Seconds between housekeeping windows (gauge refresh cadence).
HOUSEKEEPING_INTERVAL_S = 2.0


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    #: listen() backlog: a burst must reach the admission queue and shed
    #: with a typed 503, not die as connection resets below it
    request_queue_size = 512


def _precreate(reg) -> None:
    """Counters/gauges created at server start: a visible zero reads as
    "instrumented, nothing happened"."""
    reg.counter("serving/requests")
    reg.counter("serving/admitted")
    reg.counter("serving/shed")
    reg.counter("serving/errors")
    reg.counter("serving/batches")
    reg.counter("serving/batch_images")
    reg.counter("serving/padded_images")
    reg.set_gauge("serving/queue_depth", 0)
    reg.set_gauge("serving/models", 0)
    reg.set_gauge("serving/shed_rate", 0.0)
    reg.set_gauge("serving/window_ms", 0)
    reg.set_gauge("serving/latency_p50_ms", 0.0)
    reg.set_gauge("serving/latency_p95_ms", 0.0)
    reg.set_gauge("serving/latency_p99_ms", 0.0)


class PredictServer:
    """HTTP front end + model router + housekeeping loop."""

    def __init__(self, serving_cfg, *, registry=None):
        self.cfg = serving_cfg
        self._reg = registry if registry is not None \
            else telemetry.get_registry()
        _precreate(self._reg)
        self._engines: Dict[str, PredictEngine] = {}
        self._batchers: Dict[str, DynamicBatcher] = {}
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._house_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()

    # --------------------------------------------------------------- routing
    def add_engine(self, engine: PredictEngine) -> None:
        """Register one model's engine with its own batcher; the URL path
        routes by `engine.model_name`."""
        with self._lock:
            if engine.model_name in self._engines:
                raise ValueError(
                    f"model {engine.model_name!r} already registered")
            batcher = DynamicBatcher(
                engine, max_batch=self.cfg.max_batch,
                window_ms=self.cfg.max_latency_ms,
                queue_limit=self.cfg.queue_limit,
                # entries older than the request timeout are expired, never
                # run: their handlers already replied 504
                reap_after_s=self.cfg.request_timeout_s,
                registry=self._reg)
            self._engines[engine.model_name] = engine
            self._batchers[engine.model_name] = batcher
            self._reg.set_gauge("serving/models", len(self._engines))
        if self.cfg.warmup:
            engine.warmup()

    def engine(self, model: str) -> Optional[PredictEngine]:
        with self._lock:
            return self._engines.get(model)

    def batcher(self, model: str) -> Optional[DynamicBatcher]:
        with self._lock:
            return self._batchers.get(model)

    # ------------------------------------------------------------- lifecycle
    @property
    def port(self) -> Optional[int]:
        return self._server.server_address[1] if self._server else None

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
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, name="serving-http",
            daemon=True)
        self._serve_thread.start()
        self._house_thread = threading.Thread(
            target=self._housekeeping, name="serving-housekeeping",
            daemon=True)
        self._house_thread.start()
        return self.port

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
        while not self._closed.wait(HOUSEKEEPING_INTERVAL_S):
            try:
                self.refresh_gauges()
            except Exception:  # noqa: BLE001 — receipts never kill serving
                self._reg.inc("serving/errors")

    def refresh_gauges(self) -> None:
        """One window: queue depth, shed rate, window and latency
        quantiles, aggregated over every model."""
        with self._lock:
            batchers = list(self._batchers.values())
        lat, shed, admitted, depth, window = [], 0, 0, 0, 0
        for b in batchers:
            stats = b.window_stats()
            lat.extend(stats["latencies_ms"])
            shed += stats["shed"]
            admitted += stats["admitted"]
            depth += stats["queue_depth"]
            window = max(window, b.window_ms)
        self._reg.set_gauge("serving/queue_depth", depth)
        self._reg.set_gauge("serving/window_ms", window)
        total = shed + admitted
        self._reg.set_gauge("serving/shed_rate",
                            round(shed / total, 4) if total else 0.0)
        for key, value in _quantiles(lat).items():
            self._reg.set_gauge(f"serving/latency_{key}_ms", value)

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
            engine = self.engine(model)
            batcher = self.batcher(model)
            if engine is None or batcher is None:
                with self._lock:
                    known = sorted(self._engines)
                _reply(req, 400, {"error": "bad_request",
                                  "detail": f"unknown model {model!r}",
                                  "models": known})
                return
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
            with self._lock:
                engines = dict(self._engines)
            _reply(req, 200, {"models": {name: eng.describe()
                                         for name, eng in engines.items()}})
            return
        _reply(req, 404, {"error": "not found",
                          "endpoints": ["/v1/predict/<model>",
                                        "/v1/models"]})


def _quantiles(latencies_ms) -> dict:
    if not latencies_ms:
        return {}
    arr = np.asarray(latencies_ms, np.float64)
    return {"p50": round(float(np.percentile(arr, 50)), 3),
            "p95": round(float(np.percentile(arr, 95)), 3),
            "p99": round(float(np.percentile(arr, 99)), 3)}


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


def serve_from_params(cfg, params, *, device="cuda",
                      start: bool = True) -> PredictServer:
    """One engine over `params` (a Flax param tree, e.g. from
    weights.load_npz or weights.init_params) for `cfg.model` (its `extra`
    included, e.g. ViT's attention layout), routed under the model's name,
    behind a server configured by `cfg.serving`."""
    from distributed_vgg_f_tpu_torch.device import resolve_device
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.weights import load_params
    dev = resolve_device(device)
    model = build_model(cfg.model, image_size=cfg.data.image_size)
    load_params(model, params)
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

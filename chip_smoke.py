#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (distributed_vgg_f_tpu_torch) on one
NVIDIA GPU — the quickest proof that the port builds, is right, serves
and trains on the card.

    python3 chip_smoke.py

Phases, one JSON line each:
  card      name and power limit (nvidia-smi), torch and CUDA versions
  build     nvcc build of every kernel under distributed_vgg_f_tpu_torch/
            csrc/ for sm_90a, with its seconds
  kernel    the LRN forward kernel against its plain PyTorch version on
            the card, at the served path's shapes (buckets 1 and 32) and
            an odd shape, in bf16 and fp32, with device times of the
            kernel, the plain version and the library call, and the
            bytes/operations bound
  kernel_bwd the LRN backward kernel against the plain backward, at both
            sites' shapes at batch 32 and the training batch 1024 and at
            odd shapes, in bf16 and fp32, timed the same way (library:
            the autograd backward of F.local_response_norm)
  profile   torch.profiler over served forwards at buckets 1 and 32:
            device time by kernel, LRN share, device idle share
  model     full-width VGG-F (224 px, 1000 classes, bf16 compute, seeded
            init) through build_engine on the flagship's bucket ladder:
            every bucket warmed, 2 LRN launches per forward, probabilities
            finite and summing to 1, fp32 and bf16 logits held against the
            CPU forward of the same weights
  serve     the served path: serve_from_params on port 0, concurrent and
            sequential u8 POSTs, a bad-size POST; kernel launch counts are
            zeroed just before and read just after
  train_parity one train step of full-width VGG-F (fp32, TF32 off,
            dropout and augment off, batch 2) on the card and on the CPU
            from the same weights and batch: every parameter's gradient,
            conv1's included, and the updated parameters agree
  train     the training path: Trainer.fit on vggf_imagenet_dp at full
            width and batch 1024 (bf16, dropout, flip, mixup, the
            non-finite skip) for 20 steps on one fixed seeded u8 batch;
            launch counts zeroed before fit and read after (2 forward and
            2 backward LRN launches a step), every loss finite and the
            loss falling; then step ms, images/s, peak device memory and
            a torch.profiler breakdown of 3 more steps
  isolation no jax, flax or JAX-package module was imported
then the kernels summary line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero without the last line; without a CUDA device it exits 2
before doing anything.
"""

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

#: Published H100 SXM peaks (NVIDIA data sheet): device-memory bytes/s
#: and fp32 (non-tensor-core) FLOP/s. The SXM board names itself
#: "NVIDIA H100 80GB HBM3"; another board needs its own measured pair.
_BOARD = "H100 80GB HBM3"
_PEAKS = (3.35e12, 67e12)
#: cycles of GPU sleep per second of host enqueue time to hide (a clock
#: above any H100's, so the sleep never ends early)
_SLEEP_HZ = 2.2e9
#: bytes written to evict the 50 MB L2 before a timing window
_FLUSH_BYTES = 256 * 1024 * 1024


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


# ------------------------------------------------------------------ timing
def device_ms(fn, inputs, windows=5):
    """Median device milliseconds of one fn(x) call. Each window evicts
    L2, parks the stream behind a GPU sleep while the host enqueues one
    call per distinct input (each read once, cold), and times the calls
    between two events — host dispatch is hidden behind the sleep."""
    flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    out = []
    for _ in range(windows):
        flush.zero_()
        torch.cuda._sleep(int((2.0 * host_s + 0.02) * _SLEEP_HZ))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in inputs:
            fn(x)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / len(inputs))
    del flush
    return statistics.median(out)


def lrn_bound_ms(shape, itemsize, depth_radius, peaks):
    """Least time for LRN on `shape`: each input byte read once and each
    output byte written once, against fp32 operations (per element:
    w squares + w-1 adds of its clipped window of w, a*S + bias,
    rsqrt/sqrt/multiply for the power, the final multiply)."""
    bw, flops = peaks
    c = shape[-1]
    numel = math.prod(shape)
    windows = sum(min(ch + depth_radius, c - 1) - max(ch - depth_radius, 0)
                  + 1 for ch in range(c))
    ops = (numel // c) * (2 * windows + 5 * c)
    bytes_ms = 2 * numel * itemsize / bw * 1e3
    ops_ms = ops / flops * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def lrn_bwd_bound_ms(shape, itemsize, depth_radius, peaks):
    """Least time for the LRN backward on `shape`: x and g read once and
    dx written once, against fp32 operations (per element: the window
    sum of squares of its own normalizer, d, the power, t = g*x*p/d, its
    share of the window sum of t, and g*p - coef*x*u)."""
    bw, flops = peaks
    c = shape[-1]
    numel = math.prod(shape)
    windows = sum(min(ch + depth_radius, c - 1) - max(ch - depth_radius, 0)
                  + 1 for ch in range(c))
    ops = (numel // c) * (3 * windows + 12 * c)
    bytes_ms = 3 * numel * itemsize / bw * 1e3
    ops_ms = ops / flops * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


# ------------------------------------------------------------------ phases
def phase_kernel(peaks):
    """LRN kernel vs plain on the card; returns per-case records."""
    import torch.nn.functional as F

    from distributed_vgg_f_tpu_torch.ops.lrn import local_response_norm
    from distributed_vgg_f_tpu_torch.ops.lrn_cuda import \
        local_response_norm_cuda
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    shapes = [((32, 54, 54, 64), "conv1", 32),
              ((32, 27, 27, 256), "conv2", 32),
              ((1, 54, 54, 64), "conv1", 1), ((1, 27, 27, 256), "conv2", 1),
              ((3, 7, 9, 5), "odd", None)]
    for dtype, rtol in ((torch.bfloat16, 8e-3), (torch.float32, 1e-5)):
        for shape, site, bucket in shapes:
            x = (torch.randn(shape, generator=gen, device="cuda")
                 * 3.0).to(dtype)
            got = local_response_norm_cuda(x)
            want = local_response_norm(x)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=1e-6)
            err = float((got.float() - want.float()).abs().max())
            rec = {"site": site, "bucket": bucket, "shape": list(shape),
                   "dtype": str(dtype).replace("torch.", ""),
                   "rtol": rtol, "max_abs_err": err}
            if bucket is not None:
                inputs = [(torch.randn(shape, generator=gen, device="cuda")
                           * 3.0).to(dtype) for _ in range(40)]
                rec["ms"] = device_ms(local_response_norm_cuda, inputs)
                rec["plain_ms"] = device_ms(local_response_norm, inputs)
                # the library yardstick: torch's LRN over dim 1 on the
                # NCHW view of the same tensor, alpha scaled back by n
                rec["library_ms"] = device_ms(
                    lambda t: F.local_response_norm(
                        t.permute(0, 3, 1, 2), 5, alpha=5e-4, beta=0.75,
                        k=2.0), inputs)
                bound, by = lrn_bound_ms(shape, x.element_size(), 2, peaks)
                rec["bound_ms"], rec["bound_by"] = bound, by
                del inputs
            records.append(rec)
            emit("kernel", name="lrn_fwd", **rec)
    torch.cuda.synchronize()
    return records


def _trace_breakdown(prof, count, top):
    """From a torch.profiler run over `count` passes: device time by
    kernel name, the device's busy time (the union of its kernels' and
    copies' spans), the traced window and the idle share, each per pass."""
    events = list(prof.events())
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) if events else 0
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_events": len(device), "window_us": window / count,
            "busy_us": busy / count,
            "idle_share": (1.0 - busy / window) if window else None,
            "lrn_fwd_us": sum(v for k, v in by_name.items()
                              if "lrn_fwd" in k) / count,
            "lrn_bwd_us": sum(v for k, v in by_name.items()
                              if "lrn_bwd" in k) / count,
            "top_us": [[k[:80], v / count] for k, v in ranked]}


def phase_profile(engine, imgs):
    """Where a served forward's time goes: torch.profiler over 5 engine
    runs per bucket, device kernels and copies summed by name, and the
    device's busy and idle share of the traced window."""
    from torch.profiler import ProfilerActivity, profile
    forwards = 5
    for b in (1, 32):
        for _ in range(3):
            engine.run(imgs[:b])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                engine.run(imgs[:b])
            torch.cuda.synchronize()
        t = _trace_breakdown(prof, forwards, top=12)
        emit("profile", bucket=b, forwards=forwards,
             device_events=t["device_events"],
             window_us_per_forward=t["window_us"],
             device_busy_us_per_forward=t["busy_us"],
             device_idle_share=t["idle_share"],
             lrn_us_per_forward=t["lrn_fwd_us"],
             top_device_us_per_forward=t["top_us"])


def phase_model(tree):
    """Full-width VGG-F through build_engine on the flagship ladder, and
    logits held against the CPU forward of the same weights."""
    from distributed_vgg_f_tpu_torch.config import ModelConfig, get_config
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.serving.engine import build_engine
    from distributed_vgg_f_tpu_torch.weights import load_params
    cfg = get_config("vggf_imagenet_dp")
    size, classes = cfg.data.image_size, cfg.model.num_classes
    # seed 0: the same weights as `tree` (init_params with seed 0)
    engine = build_engine("vggf", size, classes, cfg.serving.buckets,
                          cfg.serving.max_batch, device="cuda",
                          compute_dtype=cfg.model.compute_dtype, seed=0)
    check(engine.buckets == (1, 2, 4, 8, 16, 32),
          f"flagship ladder is {engine.buckets}")
    lrn_cuda.LAUNCHES = 0
    engine.warmup()
    torch.cuda.synchronize()
    check(lrn_cuda.LAUNCHES == 2 * len(engine.buckets),
          f"warmup of {len(engine.buckets)} buckets launched the LRN "
          f"kernel {lrn_cuda.LAUNCHES} times, expected 2 per forward")
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (32, size, size, 3)).astype(np.uint8)
    before = lrn_cuda.LAUNCHES
    probs, bucket = engine.run(imgs)
    check(lrn_cuda.LAUNCHES == before + 2, "one forward, not 2 launches")
    check(probs.shape == (32, classes) and bucket == 32,
          f"probs {probs.shape} bucket {bucket}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    sums_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    check(sums_err <= 1e-3, f"probabilities sum off 1 by {sums_err}")
    # steady-state forward time per bucket (host clock around work that
    # ends in a device sync: u8 upload, forward, probs download)
    forward_ms = {}
    for b in engine.buckets:
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine.run(imgs[:b])
            ts.append((time.perf_counter() - t0) * 1e3)
        forward_ms[str(b)] = statistics.median(ts)

    # reference: the CPU forward (plain LRN, fp32) of the same weights
    x = torch.from_numpy(((imgs[:2].astype(np.float32)
                           - np.asarray(cfg.data.mean_rgb, np.float32))
                          * (np.float32(1.0) / np.asarray(
                              cfg.data.stddev_rgb, np.float32))))
    fp32 = ModelConfig(num_classes=classes, compute_dtype="float32")
    ref_model = load_params(build_model(fp32, image_size=size), tree).eval()
    with torch.no_grad():
        ref = ref_model(x).numpy()
    card32 = load_params(build_model(fp32, image_size=size), tree).cuda()
    card16 = load_params(build_model(cfg.model, image_size=size),
                         tree).cuda()
    with torch.no_grad():
        got32 = card32.eval()(x.cuda()).cpu().numpy()
        got16 = card16.eval()(x.cuda()).cpu().numpy()
    err32 = float(np.abs(got32 - ref).max())
    err16 = float(np.abs(got16 - ref).max())
    scale = float(np.abs(ref).max())
    # fp32 with TF32 off: sums in another order than the CPU (1e-3, the
    # CPU parity bound at 224 px); bf16: every activation rounded to 8
    # mantissa bits through 8 layers (2e-2 of the largest logit)
    check(np.allclose(got32, ref, rtol=1e-3, atol=1e-3),
          f"fp32 card logits off the CPU by {err32}")
    check(np.allclose(got16, ref, rtol=2e-2, atol=2e-2 * scale),
          f"bf16 card logits off the CPU fp32 by {err16}")
    phase_profile(engine, imgs)
    emit("model", model="vggf", image_size=size, num_classes=classes,
         compute_dtype=cfg.model.compute_dtype,
         buckets=list(engine.buckets),
         warmup_s={str(b): s for b, s in sorted(engine.compile_log.items())},
         lrn_launches_per_forward=2, probs_sum_max_err=sums_err,
         forward_ms=forward_ms,
         images_per_s={b: int(b) / (ms / 1e3)
                       for b, ms in forward_ms.items()},
         ref_max_abs_logit=scale, fp32_max_abs_err=err32,
         bf16_max_abs_err=err16,
         hbm_estimate_bytes=engine.hbm_estimate_bytes,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del engine, card32, card16
    torch.cuda.empty_cache()


def _post(port, image, k=5, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict/vggf?k={k}",
        data=image.tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def phase_serve(tree):
    """The main path: the server a user starts, driven over HTTP."""
    from distributed_vgg_f_tpu_torch import telemetry
    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.serving.server import serve_from_params
    cfg = get_config("vggf_imagenet_dp")
    size = cfg.data.image_size
    reg = telemetry.get_registry()
    reg.reset()
    rng = np.random.default_rng(1)
    burst = rng.integers(0, 256, (64, size, size, 3)).astype(np.uint8)
    singles = rng.integers(0, 256, (4, size, size, 3)).astype(np.uint8)

    lrn_cuda.LAUNCHES = 0
    t_start = time.perf_counter()
    server = serve_from_params(cfg, tree, device="cuda")
    start_s = time.perf_counter() - t_start
    engine = server.engine("vggf")
    try:
        results = [None] * len(burst)

        def post(i):
            try:
                results[i] = _post(server.port, burst[i])
            except urllib.error.HTTPError as e:
                results[i] = (e.code, json.loads(e.read()))

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(burst))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        burst_s = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "burst POSTs hung")
        statuses = [r[0] if r else None for r in results]
        check(statuses == [200] * len(burst),
              f"burst statuses {sorted(set(map(str, statuses)))}")
        batches = reg.counter_value("serving/batches")
        check(batches < len(burst),
              f"{batches} batches for {len(burst)} requests: no batching")
        burst_lat = [r[1]["latency_ms"] for r in results]

        seq_bodies = []
        for img in singles:
            status, body = _post(server.port, img)
            check(status == 200 and body["bucket"] == 1,
                  f"sequential POST {status} bucket {body.get('bucket')}")
            seq_bodies.append(body)

        try:
            _post(server.port, np.zeros((8, 8, 3), np.uint8))
            bad_status = 200
        except urllib.error.HTTPError as e:
            bad_status = e.code
        check(bad_status == 400, f"bad-size POST answered {bad_status}")
    finally:
        server.close()
    # the main path's counts, read before any direct engine.run below
    torch.cuda.synchronize()
    launches = lrn_cuda.LAUNCHES
    batches = reg.counter_value("serving/batches")
    forwards = len(engine.compile_log) + batches
    check(launches > 0, "the main path never launched the LRN kernel")
    check(launches == 2 * forwards,
          f"{launches} LRN launches for {len(engine.compile_log)} warmup "
          f"and {batches} served forwards, expected 2 per forward")

    seq_lat, seq_err = [], 0.0
    for img, body in zip(singles, seq_bodies):
        seq_lat.append(body["latency_ms"])
        probs, _ = engine.run(img[None])
        order = np.argsort(probs[0])[::-1][:5]
        check([r["class"] for r in body["top_k"]] == order.tolist(),
              "served top-5 classes differ from engine.run")
        for rec in body["top_k"]:
            seq_err = max(seq_err,
                          abs(rec["prob"] - float(probs[0][rec["class"]])))
    # same image, same bucket, same card: equal up to cuDNN's choice of
    # algorithm between calls
    check(seq_err <= 1e-6, f"served probs off engine.run by {seq_err}")
    emit("serve", requests=len(burst) + len(singles) + 1,
         burst=len(burst), burst_all_200=True,
         batches=batches,
         batch_images=reg.counter_value("serving/batch_images"),
         padded_images=reg.counter_value("serving/padded_images"),
         burst_wall_s=burst_s, burst_rps=len(burst) / burst_s,
         burst_latency_ms={"p50": float(np.percentile(burst_lat, 50)),
                           "p99": float(np.percentile(burst_lat, 99))},
         sequential_latency_ms=seq_lat, sequential_max_prob_err=seq_err,
         bad_size_status=bad_status, server_start_s=start_s,
         warmup_forwards=len(engine.compile_log), forwards=forwards,
         lrn_launches=launches)
    return launches


def phase_kernel_bwd(peaks):
    """LRN backward kernel vs the plain backward on the card; returns the
    timed records."""
    import torch.nn.functional as F

    from distributed_vgg_f_tpu_torch.ops.lrn import local_response_norm_bwd
    from distributed_vgg_f_tpu_torch.ops.lrn_cuda import \
        local_response_norm_bwd_cuda
    gen = torch.Generator(device="cuda").manual_seed(1)

    def pair(shape, dtype):
        x = (torch.randn(shape, generator=gen, device="cuda") * 3.0).to(dtype)
        return x, torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def library(xg):
        # the library yardstick: autograd of torch's LRN over dim 1 of the
        # NCHW view, alpha scaled back by n; the forward graph is built
        # outside the timed window, so only the backward is timed
        x, g = xg
        xr = x.detach().requires_grad_()
        y = F.local_response_norm(xr.permute(0, 3, 1, 2), 5, alpha=5e-4,
                                  beta=0.75, k=2.0)
        return lambda: torch.autograd.grad(y, xr, g.permute(0, 3, 1, 2),
                                           retain_graph=True)

    records = []
    shapes = [((1024, 54, 54, 64), "conv1", 1024),
              ((1024, 27, 27, 256), "conv2", 1024),
              ((32, 54, 54, 64), "conv1", 32),
              ((32, 27, 27, 256), "conv2", 32),
              ((3, 7, 9, 5), "odd", None), ((2, 5, 7, 100), "odd", None)]
    for dtype, rtol, atol in ((torch.bfloat16, 8e-3, 1e-6),
                              (torch.float32, 1e-5, 1e-5)):
        for shape, site, batch in shapes:
            x, g = pair(shape, dtype)
            got = local_response_norm_bwd_cuda(x, g)
            want = local_response_norm_bwd(x, g)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
            err = float((got.float() - want.float()).abs().max())
            rec = {"site": site, "batch": batch, "shape": list(shape),
                   "dtype": str(dtype).replace("torch.", ""), "rtol": rtol,
                   "atol": atol, "max_abs_err": err}
            del got, want
            if batch is not None:
                # cold inputs: 40 distinct pairs at batch 32; at batch 1024
                # one pair is 7-14x the L2, so 3 pairs suffice
                inputs = [pair(shape, dtype)
                          for _ in range(40 if batch == 32 else 3)]
                rec["ms"] = device_ms(
                    lambda xg: local_response_norm_bwd_cuda(*xg), inputs)
                rec["plain_ms"] = device_ms(
                    lambda xg: local_response_norm_bwd(*xg), inputs)
                calls = [library(xg) for xg in inputs]
                rec["library_ms"] = device_ms(lambda call: call(), calls)
                bound, by = lrn_bwd_bound_ms(shape, x.element_size(), 2,
                                             peaks)
                rec["bound_ms"], rec["bound_by"] = bound, by
                del inputs, calls
            records.append(rec)
            emit("kernel_bwd", name="lrn_bwd", **rec)
            del x, g
            torch.cuda.empty_cache()
    return records


def _rel_l2(a, b):
    return float((a - b).double().norm() / max(float(b.double().norm()),
                                                1e-30))


def phase_train_parity(tree):
    """One train step of full-width VGG-F on the card and on the CPU from
    the same weights and batch (fp32, TF32 off, dropout and augment off,
    batch 2): the card's gradients, conv1's included (the LRN backward
    through the autograd Function), and its updated parameters against
    the CPU's."""
    from distributed_vgg_f_tpu_torch.config import ModelConfig, get_config
    from distributed_vgg_f_tpu_torch.data.device_ingest import \
        make_device_finish
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
    from distributed_vgg_f_tpu_torch.train.state import TrainState
    from distributed_vgg_f_tpu_torch.train.step import build_train_step
    from distributed_vgg_f_tpu_torch.weights import load_params
    cfg = get_config("vggf_imagenet_dp")
    size = cfg.data.image_size
    model_cfg = ModelConfig(num_classes=cfg.model.num_classes,
                            compute_dtype="float32", dropout_rate=0.0)
    rng = np.random.default_rng(2)
    batch = {"image": rng.integers(0, 256, (2, size, size, 3), np.uint8),
             "label": rng.integers(0, cfg.model.num_classes, (2,))}
    finish = make_device_finish(cfg.data.mean_rgb, cfg.data.stddev_rgb)
    out = {}
    for dev in ("cpu", "cuda"):
        model = load_params(build_model(model_cfg, image_size=size),
                            tree).to(dev)
        p0 = {k: p.detach().cpu().clone()
              for k, p in model.named_parameters()}
        opt, schedule = build_optimizer(cfg, model.parameters())
        state = TrainState.create(model, opt)
        step = build_train_step(schedule, cfg.optim.weight_decay,
                                skip_nonfinite=True, device_finish=finish,
                                device=dev)
        lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        out[dev] = {
            "loss": float(metrics["loss"]),
            "grads": {k: None if p.grad is None else p.grad.cpu()
                      for k, p in model.named_parameters()},
            "updates": {k: p.detach().cpu() - p0[k]
                        for k, p in model.named_parameters()},
            "launches": (lrn_cuda.LAUNCHES, lrn_cuda.BWD_LAUNCHES)}
        del model, opt, state
    torch.cuda.empty_cache()
    cpu, card = out["cpu"], out["cuda"]
    check(card["launches"] == (2, 2) and cpu["launches"] == (0, 0),
          f"LRN launches card {card['launches']} cpu {cpu['launches']}")
    check(all(g is not None for g in card["grads"].values()),
          "a parameter got no gradient on the card")
    check(float(card["grads"]["conv1.weight"].abs().max()) > 0,
          "conv1 got a zero gradient on the card")
    grad_err = {k: _rel_l2(card["grads"][k], cpu["grads"][k])
                for k in cpu["grads"]}
    update_err = {k: _rel_l2(card["updates"][k], cpu["updates"][k])
                  for k in cpu["updates"]}
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    # fp32 on both sides, sums in another order: this batch reads ~2e-6
    # relative L2 for gradients and ~4e-6 for updates (H100 80GB HBM3,
    # 700 W). 1e-4 leaves room for another conv algorithm and still fails
    # a wrong scale or a wrong term in the LRN backward
    tol = 1e-4
    check(loss_err <= 1e-4, f"loss card {card['loss']} cpu {cpu['loss']}")
    check(max(grad_err.values()) <= tol, f"gradients off: {grad_err}")
    check(max(update_err.values()) <= tol, f"updates off: {update_err}")
    emit("train_parity", batch=2, image_size=size, dtype="float32",
         tf32=False, loss_card=card["loss"], loss_cpu=cpu["loss"],
         loss_rel_err=loss_err, tolerance_rel_l2=tol,
         grad_rel_l2=grad_err, update_rel_l2=update_err,
         card_lrn_launches={"fwd": card["launches"][0],
                            "bwd": card["launches"][1]})


def _profile_train(trainer, state, batch, steps=3):
    """Where a train step's time goes: torch.profiler over `steps` more
    steps on the same batch."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch,
                                          trainer.cfg.train.seed)
        torch.cuda.synchronize()
    t = _trace_breakdown(prof, steps, top=15)
    return {"steps": steps, "device_events": t["device_events"],
            "window_us_per_step": t["window_us"],
            "device_busy_us_per_step": t["busy_us"],
            "device_idle_share": t["idle_share"],
            "lrn_fwd_us_per_step": t["lrn_fwd_us"],
            "lrn_bwd_us_per_step": t["lrn_bwd_us"],
            "top_device_us_per_step": t["top_us"]}


def phase_train():
    """The training path: Trainer.fit on the flagship at full width and
    batch 1024 for 20 steps on one fixed seeded u8 batch."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = get_config("vggf_imagenet_dp")
    steps = 20
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=1, seed=0))
    b, size = cfg.data.global_batch_size, cfg.data.image_size
    data = SyntheticU8(b, size, cfg.model.num_classes, seed=0, pin=True)
    stamps = []
    trainer = Trainer(cfg, log=lambda event, rec: stamps.append(
        time.perf_counter()))
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    state = trainer.fit(state, data, num_steps=steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fwd": lrn_cuda.LAUNCHES, "bwd": lrn_cuda.BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    recs = [r for r in trainer.records if r["event"] == "train"]
    losses = [r["loss"] for r in recs]
    stamps.insert(0, t0)
    step_ms = [(t1 - t0_) * 1e3 for t0_, t1 in zip(stamps, stamps[1:])]
    median_ms = statistics.median(step_ms[4:])
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    profile = _profile_train(trainer, state, next(iter(data)))
    # the record first, the checks after: a failed check still shows the
    # run it judged
    emit("train", config=cfg.name, image_size=size, batch=b,
         num_classes=cfg.model.num_classes,
         compute_dtype=cfg.model.compute_dtype,
         dropout_rate=cfg.model.dropout_rate,
         augment={"hflip": cfg.data.augment.hflip,
                  "mixup_alpha": cfg.data.augment.mixup_alpha},
         skip_nonfinite=cfg.train.skip_nonfinite, steps=steps,
         wall_s=wall_s, first_step_ms=step_ms[0],
         step_ms_median=median_ms, step_ms=step_ms,
         images_per_s=b / (median_ms / 1e3),
         meter_images_per_sec=recs[-1]["images_per_sec"],
         peak_memory_bytes=peak, losses=losses,
         grad_norms=[r["grad_norm"] for r in recs],
         loss_first5_mean=first, loss_last5_mean=last,
         lrn_launches=launches, profile=profile)
    check(state.step == steps + profile["steps"] and len(recs) == steps,
          f"{state.step} steps, {len(recs)} records")
    check(launches == {"fwd": 2 * steps, "bwd": 2 * steps},
          f"LRN launches {launches} over {steps} steps, expected 2 forward "
          "and 2 backward a step")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(all(r["bad_step"] == 0.0 for r in recs), "a step was skipped")
    check(last < first, f"loss did not fall on a fixed batch: mean of the "
          f"first 5 steps {first}, of the last 5 {last}")
    del trainer, state, data
    torch.cuda.empty_cache()
    return launches


def phase_isolation():
    bad = sorted(m for m in sys.modules
                 if any(m == r or m.startswith(r + ".")
                        for r in ("jax", "jaxlib", "flax",
                                  "distributed_vgg_f_tpu")))
    check(bad == [], f"JAX-side modules imported: {bad}")
    emit("isolation", forbidden_modules=bad)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script measures "
              "the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    # fails here, before any output, outside a checkout of the repo
    from distributed_vgg_f_tpu_torch.kernels import build
    from distributed_vgg_f_tpu_torch.weights import init_params

    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    check(_BOARD in name, f"peaks are tabled for the {_BOARD} only, "
          f"not {name!r}")
    peaks = _PEAKS
    # fp32 matmuls and convs in full fp32 (the reference checks); the
    # flagship computes in bf16, where TF32 plays no part
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("card", nvidia_smi=smi, name=name,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         peaks={"board": _BOARD, "bytes_per_s": peaks[0],
                "fp32_flops": peaks[1]},
         tf32={"matmul": False, "cudnn": False})

    t0 = time.perf_counter()
    libs = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels=sorted(libs), flags=build.NVCC_FLAGS)

    records = phase_kernel(peaks)
    bwd_records = phase_kernel_bwd(peaks)

    from distributed_vgg_f_tpu_torch.config import get_config
    cfg = get_config("vggf_imagenet_dp")
    t0 = time.perf_counter()
    tree = init_params(cfg.model, 0, image_size=cfg.data.image_size)
    emit("init", seconds=time.perf_counter() - t0, seed=0,
         params=int(sum(a.size for layer in tree.values()
                        for a in layer.values())))
    phase_model(tree)
    serve_launches = phase_serve(tree)
    phase_train_parity(tree)
    del tree
    train_launches = phase_train()
    phase_isolation()

    def summary(name, source, replaces, recs, key, value, launches,
                by_path, work):
        # two sites per pass: the line sums both sites' bf16 records
        main = [r for r in recs if r[key] == value
                and r["dtype"] == "bfloat16"]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in main) else "operations"),
            "library_ms": sum(r["library_ms"] for r in main),
            "work": work + ": " + ", ".join(str(tuple(r["shape"]))
                                           for r in main)}

    print(json.dumps({"kernels": [
        summary("lrn_fwd", "distributed_vgg_f_tpu_torch/csrc/lrn_fwd.cu",
                "distributed_vgg_f_tpu/ops/lrn_pallas.py:67", records,
                "bucket", 32, serve_launches + train_launches["fwd"],
                {"serve": serve_launches, "train": train_launches["fwd"]},
                "both LRN sites of one bf16 forward at bucket 32"),
        summary("lrn_bwd", "distributed_vgg_f_tpu_torch/csrc/lrn_bwd.cu",
                "distributed_vgg_f_tpu/ops/lrn_pallas.py:74", bwd_records,
                "batch", 1024, train_launches["bwd"],
                {"serve": 0, "train": train_launches["bwd"]},
                "both LRN sites of one bf16 training step at batch 1024"),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

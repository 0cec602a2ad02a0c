#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (distributed_vgg_f_tpu_torch) on one
NVIDIA GPU — the quickest proof that the port builds, is right, and
serves on the card.

    python3 chip_smoke.py

Phases, one JSON line each:
  card      name and power limit (nvidia-smi), torch and CUDA versions
  build     nvcc build of every kernel under distributed_vgg_f_tpu_torch/
            csrc/ for sm_90a, with its seconds
  kernel    each kernel against its plain PyTorch version on the card, at
            the main path's shapes (buckets 1 and 32) and an odd shape, in
            bf16 and fp32, with device times of the kernel, the plain
            version and the library call, and the bytes/operations bound
  profile   torch.profiler over served forwards at buckets 1 and 32:
            device time by kernel, LRN share, device idle share
  model     full-width VGG-F (224 px, 1000 classes, bf16 compute, seeded
            init) through build_engine on the flagship's bucket ladder:
            every bucket warmed, 2 LRN launches per forward, probabilities
            finite and summing to 1, fp32 and bf16 logits held against the
            CPU forward of the same weights
  serve     the main path: serve_from_params on port 0, concurrent and
            sequential u8 POSTs, a bad-size POST; kernel launch counts are
            zeroed just before and read just after
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
        events = list(prof.events())
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in device:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in device)
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
        lrn_us = sum(v for k, v in by_name.items() if "lrn_fwd" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        emit("profile", bucket=b, forwards=forwards,
             device_events=len(device),
             window_us_per_forward=window / forwards,
             device_busy_us_per_forward=busy / forwards,
             device_idle_share=(1.0 - busy / window) if window else None,
             lrn_us_per_forward=lrn_us / forwards,
             top_device_us_per_forward=[[k[:80], v / forwards]
                                        for k, v in top])


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

    from distributed_vgg_f_tpu_torch.config import get_config
    cfg = get_config("vggf_imagenet_dp")
    t0 = time.perf_counter()
    tree = init_params(cfg.model, 0, image_size=cfg.data.image_size)
    emit("init", seconds=time.perf_counter() - t0, seed=0,
         params=int(sum(a.size for layer in tree.values()
                        for a in layer.values())))
    phase_model(tree)
    launches = phase_serve(tree)
    phase_isolation()

    # one kernel, two sites per forward: the summary line is the LRN work
    # of one bf16 forward at bucket 32 (both sites summed)
    main = [r for r in records if r["bucket"] == 32
            and r["dtype"] == "bfloat16"]
    bound = sum(r["bound_ms"] for r in main)
    print(json.dumps({"kernels": [{
        "name": "lrn_fwd", "route": "cuda",
        "source": "distributed_vgg_f_tpu_torch/csrc/lrn_fwd.cu",
        "replaces": "distributed_vgg_f_tpu/ops/lrn_pallas.py:67",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": bound,
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in main)
                     else "operations"),
        "library_ms": sum(r["library_ms"] for r in main),
        "work": "both LRN sites of one bf16 forward at bucket 32: "
                + ", ".join(str(tuple(r["shape"])) for r in main),
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

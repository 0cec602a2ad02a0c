#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (distributed_vgg_f_tpu_torch) on one
NVIDIA GPU — the quickest proof that the port builds, is right, serves
and trains on the card.

    python3 chip_smoke.py

Phases, one JSON line each:
  card      name and power limit (nvidia-smi), torch and CUDA versions
  build     nvcc build of every kernel under distributed_vgg_f_tpu_torch/
            csrc/ for sm_90a (each nvcc given 600 s), with its seconds, the
            script's wall seconds so far, and ptxas's registers, shared
            memory and spills for each warp-specialised (wgmma) kernel and
            each LRN kernel at radius 2; the three ring block kernels
            must show 168 registers and no note of serialised wgmma at
            64, 128 and 256
  kernel    the LRN forward kernel, unfused and with the ReLU fused,
            against its plain PyTorch versions on the card, in bf16 and
            fp32: the vector variant at the served path's shapes (buckets
            1 and 32), the training batch 1024 (bf16) and C = 8 … 256 at
            radius 0–4, the general variant at odd shapes; each record
            names its variant and shows that the fused kernel gives the
            unfused kernel's bits on F.relu(z) (z with exact zeros) and
            that two launches give the same bits. At buckets 1, 32 and
            1024: device times of the fused kernel, the unfused kernel,
            the ReLU pass, the plain version and the library call, and the
            bytes/operations bound
  kernel_bwd the LRN backward kernel the same way (the fused kernel's bits
            against the unfused kernel's on F.relu(z) then the ReLU's
            threshold_backward), timed at both sites' shapes at batch 32
            and the training batch 1024 (library: the autograd backward of
            F.local_response_norm)
  profile   torch.profiler over served forwards at buckets 1 and 32:
            device time by kernel, LRN share, device idle share
  model     full-width VGG-F (224 px, 1000 classes, bf16 compute, seeded
            init) through build_engine on the flagship's bucket ladder:
            every bucket warmed, 2 LRN launches per forward (the vector
            variant, ReLU fused), probabilities
            finite and summing to 1, fp32 and bf16 logits held against the
            CPU forward of the same weights
  serve     the served path: serve_from_params on port 0, concurrent and
            sequential u8 POSTs, a bad-size POST; kernel launch counts are
            zeroed just before and read just after (every LRN launch of
            the vector variant)
  train_parity one train step of full-width VGG-F (fp32, TF32 off,
            dropout and augment off, batch 2) on the card and on the CPU
            from the same weights and batch: every parameter's gradient,
            conv1's included, and the updated parameters agree
  train     the training path: Trainer.fit on vggf_imagenet_dp at full
            width and batch 1024 (bf16, dropout, flip, mixup, the
            non-finite skip) for 20 steps on one fixed seeded u8 batch;
            launch counts zeroed before fit and read after (2 forward and
            2 backward LRN launches a step, all of the vector variant),
            every loss finite and the
            loss falling; then step ms, images/s, peak device memory and
            a torch.profiler breakdown of 3 more steps
  flash_kernel the flash attention forward, dQ and dK/dV kernels against
            their plain versions on the card, at ViT-S/16's shapes
            (T = 197, 6 heads of 64) at batch 32 and 1024, at a ragged
            shape with a kv_len mask and at a causal one, at head dims 8,
            16, 32, 100, 128 and 256 (JAX's (1, 128, 1, 256) causal among
            them), at B*H = 65600, and (the forward) at T = 1, 63, 64,
            65, 129, 197 and 2048 with kv_len masks (around the tiles and
            the K/V ring's stages), dQ and dK/dV at T = 2 … 2048 with the
            same masks at head dims 64 and 256, in bf16 and fp32, with
            device times of the kernel, the plain version and the library
            call (SDPA, its autograd backward for dQ and dK/dV together) at
            ViT's shapes and at ViT's T with heads of 128 and 256, the
            bytes/operations bound and the kernel's TFLOP/s; and dQ, dK and
            dV of two launches on the same inputs bit-equal at ViT's layer
  vit_model full-width ViT-S/16 (flash layout, bf16, seeded init) through
            build_engine on the bucket ladder: 12 forward launches per
            forward, probabilities finite and summing to 1, fp32 and bf16
            logits held against the CPU forward of the same weights and
            against the port's head_major layout on the card; forward ms
            per bucket and a torch.profiler breakdown
  vit_serve serve_from_params for vit_s16 (flash), concurrent and
            sequential u8 POSTs and a bad-size POST; launch counts zeroed
            just before and read just after
  vit_train_parity one fp32 train step of full-width ViT-S/16 (flash, TF32
            off, dropout and augment off, batch 2) on the card and on the
            CPU from the same weights and batch: every gradient and update
            within 1e-4 relative L2, 12 launches of each flash kernel
  vit_train Trainer.fit on vit_s16_imagenet with flash at full width and
            batch 1024 (bf16, dropout, flip, mixup, the non-finite skip;
            the 5 warmup epochs cut, so the LR is not ~0) for 20 steps on
            one fixed seeded u8 batch; launch counts zeroed before fit and
            read after (12 of each flash kernel a step), every loss finite
            and the loss falling; step ms, images/s, peak device memory
            and a torch.profiler breakdown of 3 more steps
  flash_causal the flash forward, dQ and dK/dV kernels with causal=True
            at (4, T, 6, 64), T = 2048 and 8192 (ViT-S/16's heads at the
            long lengths of benchmarks/flash_attention_bench.py), in bf16
            and fp32, against their plain versions, with device times of
            the kernel, the plain version and causal SDPA, and the bound
            over the causal live pairs: the counterpart of the JAX
            package's jagged causal kernels is the kernels' causal loop
            bound; the stress lengths of flash_kernel, causal; and the
            backward's bit-equal repeat at T = 2048
  ring_kernel the three ring block kernels (fold, dQ step, dK/dV step)
            against their plain versions at the offsets the ranks of a
            4-rank ring see at the local shape (4, 2048, 6, 64) — a past
            block, the diagonal, a block wholly in the future (every bit
            left as it was) — and at the ragged local length 197 with a
            block-local kv_len (padded keys keep their bits) and a
            partly masked block, at head dims 128 and 256 and at
            B*H = 65600, in bf16 and fp32; device times and TFLOP/s
            against the bound for a past and a diagonal block, and for a
            past block at head dim 128, with PyTorch's flash attention
            forward and backward as the fold's and the backward's
            library yardsticks (each checked against the plain version
            first); the three kernels at stress lengths T = 2 … 2048
            (Tq != Tk among them) and diagonal shifts 0, 37 and -37,
            causal, at head dims 64 and 256 (rows they do not reach keep
            their bits); and their bit-equal repeat
  ring_flash (a) initialize_distributed on a one-rank NCCL group, then
            ring_flash_attention, ring_self_attention and
            ulysses_self_attention (flash) at (4, 8192, 6, 64) bf16, causal
            and not, forward and backward, each held against
            flash_self_attention, launch counts zeroed just before each
            path and read just after; (b) the 4-rank ring's kernel work
            chained on the one card exactly as the ring chains it: each
            rank's folds in ring order with its offsets, then the backward
            steps with the dK/dV accumulators travelling with their block,
            held against flash_self_attention at T = 8192 (bf16 and fp32),
            with each rank's kernel ms. (a) runs the real exchange at n = 1
            because NCCL puts no two ranks on one card and gloo sends no
            CUDA tensors; (b) is what puts n > 1 offsets through the
            kernels
  isolation no jax, flax or JAX-package module was imported
  wall      the script's wall seconds
then the kernels summary line (each flash row with the head dims its
kernel was checked at), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero without the last line; without a CUDA device it exits 2
before doing anything.
"""

import json
import math
import re
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
#: dense bf16 tensor-core FLOP/s of the H100 SXM (NVIDIA data sheet)
_BF16_TENSOR_FLOPS = 989.4e12
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


def _ptxas_report(logs):
    """From nvcc's -Xptxas -v output of each source: the registers a
    thread, static shared memory and spill bytes of each warp-specialised
    (wgmma) kernel instantiation (the flash forward, dQ and dK/dV, and
    the ring block fold, dQ and dK/dV) and of each LRN kernel
    instantiation at the main path's radius 2 (the general variant at
    every radius), and the codes of ptxas's performance notes on it
    (C7515-C7520: wgmma it serialised), as {"kernel<params>": {...}}."""
    def entry_of(line):
        k = re.search(r"((?:flash|block)_[a-z]+_wgmma_kernel)ILi(\d+)E",
                      line)
        if k:
            return f"{k.group(1)}<{k.group(2)}>"
        k = re.search(r"(lrn_(?:fwd|bwd)(?:_vec)?_kernel)I(13__nv_bfloat16|f)"
                      r"(?:Li(\d+)ELi(\d+)E)?Lb([01])E", line)
        if not k or (k.group(4) is not None and k.group(4) != "2"):
            return None
        params = ["bf16" if k.group(2) != "f" else "f32"]
        if k.group(3) is not None:
            params += [f"E={k.group(3)}", f"R={k.group(4)}"]
        params.append("relu" if k.group(5) == "1" else "no_relu")
        return f"{k.group(1)}<{','.join(params)}>"

    report = {}
    for text in logs.values():
        entry = None
        for line in text.splitlines():
            note = re.search(r"\((C75\d\d)\)", line)
            if note and entry_of(line):
                codes = report.setdefault(entry_of(line), {}).setdefault(
                    "ptxas_notes", [])
                if note.group(1) not in codes:
                    codes.append(note.group(1))
                continue
            if "Compiling entry function" in line:
                entry = entry_of(line)
                if entry:
                    report.setdefault(entry, {}).setdefault("ptxas_notes",
                                                            [])
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                report[entry]["spill_stores"] = int(m.group(1))
                report[entry]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[entry]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                report[entry]["static_smem"] = int(m.group(1)) if m else 0
    return report


# ------------------------------------------------------------------ phases
#: LRN variant checks: the vector variant at every lane-group width the
#: main path's rule gives (C = 8 … 256) and every radius it is built for,
#: the general variant at odd shapes (C = 5 and 100: no whole 16-byte
#: vectors; 24: 3 lanes; radius 5: wider than the vector variant's)
_LRN_VEC_CASES = [((2, 5, 7, c), r) for c in (8, 16, 64, 128, 256)
                  for r in range(5)]
_LRN_GENERAL_CASES = [((3, 7, 9, 5), 2), ((2, 5, 7, 100), 2),
                      ((2, 5, 7, 24), 2), ((2, 5, 7, 64), 5)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _lrn_pre(shape, dtype, gen):
    """Pre-activations (z, as the conv hands them to the fused ReLU + LRN)
    with negatives and exact zeros (every fifth)."""
    z = torch.randn(shape, generator=gen, device="cuda") * 3.0
    z.view(-1)[::5] = 0.0
    return z.to(dtype)


def _lrn_cases(main):
    """(shape, site, batch, radius, expected variant) for the LRN phases:
    the main path's shapes, then the variant sweeps."""
    return ([(shape, site, batch, 2, "vector") for shape, site, batch in main]
            + [(shape, "vector_sweep", None, r, "vector")
               for shape, r in _LRN_VEC_CASES]
            + [(shape, "odd", None, r, "general")
               for shape, r in _LRN_GENERAL_CASES])


def phase_kernel(peaks):
    """LRN forward kernel, both variants, unfused and with the ReLU fused,
    vs the plain versions on the card; returns per-case records."""
    import torch.nn.functional as F

    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.ops.lrn import (local_response_norm,
                                                     relu_local_response_norm)
    fwd = lrn_cuda.local_response_norm_cuda
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    main = [((32, 54, 54, 64), "conv1", 32), ((32, 27, 27, 256), "conv2", 32),
            ((1, 54, 54, 64), "conv1", 1), ((1, 27, 27, 256), "conv2", 1),
            ((1024, 54, 54, 64), "conv1", 1024),
            ((1024, 27, 27, 256), "conv2", 1024)]
    for dtype, rtol in ((torch.bfloat16, 8e-3), (torch.float32, 1e-5)):
        for shape, site, bucket, r, want in _lrn_cases(main):
            if bucket == 1024 and dtype != torch.bfloat16:
                continue  # the training batch runs in bf16
            variant = lrn_cuda.variant(shape, dtype, r)
            check(variant == want, f"{shape} {dtype} r={r} takes the "
                  f"{variant} variant, expected {want}")
            z = _lrn_pre(shape, dtype, gen)
            err = 0.0
            for got, want_t in ((fwd(z, r), local_response_norm(z, r)),
                                (fwd(z, r, relu=True),
                                 relu_local_response_norm(z, r))):
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want_t.float(),
                                           rtol=rtol, atol=1e-6)
                err = max(err, float((got.float() - want_t.float())
                                     .abs().max()))
                del got, want_t
            # ReLU is exact: the fused kernel's bits are the unfused
            # kernel's on F.relu(z), and a second launch repeats them
            fused = fwd(z, r, relu=True)
            bit_equal = torch.equal(_bits(fused), _bits(fwd(F.relu(z), r)))
            repeat = torch.equal(_bits(fused), _bits(fwd(z, r, relu=True)))
            check(bit_equal, f"fused LRN forward at {shape} {dtype} r={r} "
                  "is not the unfused kernel's bits on F.relu(z)")
            check(repeat, f"two LRN forward launches at {shape} {dtype} "
                  f"r={r} differ")
            rec = {"site": site, "bucket": bucket, "shape": list(shape),
                   "radius": r, "variant": variant,
                   "dtype": str(dtype).replace("torch.", ""),
                   "rtol": rtol, "max_abs_err": err,
                   "fused_bit_equal": bit_equal, "repeat_bit_equal": repeat}
            del z, fused
            if bucket is not None:
                # cold inputs: 40 distinct tensors at buckets 1 and 32; at
                # batch 1024 one is 7.6x the L2, so 3 suffice
                inputs = [_lrn_pre(shape, dtype, gen)
                          for _ in range(3 if bucket == 1024 else 40)]
                relu_in = [F.relu(t) for t in inputs]
                # the main path's kernel: ReLU fused
                rec["ms"] = device_ms(lambda t: fwd(t, relu=True), inputs)
                rec["unfused_ms"] = device_ms(fwd, relu_in)
                rec["relu_ms"] = device_ms(F.relu, inputs)
                rec["plain_ms"] = device_ms(relu_local_response_norm, inputs)
                # the library yardstick: torch's LRN over dim 1 on the
                # NCHW view of the ReLU's output, alpha scaled back by n
                rec["library_ms"] = device_ms(
                    lambda t: F.local_response_norm(
                        t.permute(0, 3, 1, 2), 5, alpha=5e-4, beta=0.75,
                        k=2.0), relu_in)
                bound, by = lrn_bound_ms(shape, torch.finfo(dtype).bits // 8, 2,
                                         peaks)
                rec["bound_ms"], rec["bound_by"] = bound, by
                del inputs, relu_in
                torch.cuda.empty_cache()
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
            # every ReLU pass outside the LRN kernels: torch's relu is a
            # clamp_min kernel, its backward threshold_backward
            "relu_us": {d: sum(v for k, v in by_name.items() if n in k)
                        / count for d, n in (("fwd", "clamp"),
                                             ("bwd", "threshold"))},
            # the port's (anonymous namespace)::flash_{fwd,dq,dkv}_kernel
            # (fp32) and flash_{fwd,dq,dkv}_wgmma_kernel (bf16), not
            # PyTorch's own flash kernels
            "flash_us": {n: sum(v for k, v in by_name.items() if re.search(
                                rf"namespace\)::{n}(_wgmma)?_kernel", k))
                         / count
                         for n in ("flash_fwd", "flash_dq", "flash_dkv")},
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
    lrn_cuda.LAUNCHES = lrn_cuda.VEC_LAUNCHES = 0
    engine.warmup()
    torch.cuda.synchronize()
    check(lrn_cuda.LAUNCHES == 2 * len(engine.buckets),
          f"warmup of {len(engine.buckets)} buckets launched the LRN "
          f"kernel {lrn_cuda.LAUNCHES} times, expected 2 per forward")
    check(lrn_cuda.VEC_LAUNCHES == lrn_cuda.LAUNCHES,
          f"{lrn_cuda.LAUNCHES - lrn_cuda.VEC_LAUNCHES} warmup LRN launches "
          "took the general variant")
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


def _post(port, image, k=5, timeout=120, model="vggf"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict/{model}?k={k}",
        data=image.tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _drive_server(server, model, burst, singles, reg):
    """Concurrent POSTs of `burst`, then sequential POSTs of `singles`
    (each must run at bucket 1), then a bad-size POST (must be 400); the
    server is closed on the way out."""
    try:
        results = [None] * len(burst)

        def post(i):
            try:
                results[i] = _post(server.port, burst[i], model=model)
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

        seq_bodies = []
        for img in singles:
            status, body = _post(server.port, img, model=model)
            check(status == 200 and body["bucket"] == 1,
                  f"sequential POST {status} bucket {body.get('bucket')}")
            seq_bodies.append(body)

        try:
            _post(server.port, np.zeros((8, 8, 3), np.uint8), model=model)
            bad_status = 200
        except urllib.error.HTTPError as e:
            bad_status = e.code
        check(bad_status == 400, f"bad-size POST answered {bad_status}")
    finally:
        server.close()
    return {"burst_lat": [r[1]["latency_ms"] for r in results],
            "burst_s": burst_s, "seq_bodies": seq_bodies,
            "bad_status": bad_status}


def _check_served_probs(engine, singles, seq_bodies):
    """Each sequential answer against engine.run of the same image: the
    same top-5 classes and probabilities within 1e-6 (same image, same
    bucket, same card: equal up to cuDNN's choice of algorithm between
    calls). Returns (latencies, max error)."""
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
    check(seq_err <= 1e-6, f"served probs off engine.run by {seq_err}")
    return seq_lat, seq_err


def _serve_record(reg, burst, singles, drive, seq_lat, seq_err, start_s,
                  engine, forwards):
    batches = reg.counter_value("serving/batches")
    return dict(
        requests=len(burst) + len(singles) + 1, burst=len(burst),
        burst_all_200=True, batches=batches,
        batch_images=reg.counter_value("serving/batch_images"),
        padded_images=reg.counter_value("serving/padded_images"),
        burst_wall_s=drive["burst_s"],
        burst_rps=len(burst) / drive["burst_s"],
        burst_latency_ms={"p50": float(np.percentile(drive["burst_lat"], 50)),
                          "p99": float(np.percentile(drive["burst_lat"],
                                                     99))},
        sequential_latency_ms=seq_lat, sequential_max_prob_err=seq_err,
        bad_size_status=drive["bad_status"], server_start_s=start_s,
        warmup_forwards=len(engine.compile_log), forwards=forwards)


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

    lrn_cuda.LAUNCHES = lrn_cuda.VEC_LAUNCHES = 0
    t_start = time.perf_counter()
    server = serve_from_params(cfg, tree, device="cuda")
    start_s = time.perf_counter() - t_start
    engine = server.engine("vggf")
    drive = _drive_server(server, "vggf", burst, singles, reg)
    # the main path's counts, read before any direct engine.run below
    torch.cuda.synchronize()
    launches = lrn_cuda.LAUNCHES
    vec_launches = lrn_cuda.VEC_LAUNCHES
    batches = reg.counter_value("serving/batches")
    forwards = len(engine.compile_log) + batches
    check(launches > 0, "the main path never launched the LRN kernel")
    check(launches == 2 * forwards,
          f"{launches} LRN launches for {len(engine.compile_log)} warmup "
          f"and {batches} served forwards, expected 2 per forward")
    check(vec_launches == launches,
          f"{launches - vec_launches} of {launches} served LRN launches "
          "took the general variant")
    seq_lat, seq_err = _check_served_probs(engine, singles,
                                           drive["seq_bodies"])
    emit("serve", **_serve_record(reg, burst, singles, drive, seq_lat,
                                  seq_err, start_s, engine, forwards),
         lrn_launches=launches, lrn_vec_launches=vec_launches)
    return launches


def phase_kernel_bwd(peaks):
    """LRN backward kernel, both variants, unfused and with the ReLU's
    backward fused, vs the plain backward on the card; returns the
    records."""
    import torch.nn.functional as F

    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.ops.lrn import (
        local_response_norm_bwd, relu_local_response_norm_bwd)
    bwd = lrn_cuda.local_response_norm_bwd_cuda
    gen = torch.Generator(device="cuda").manual_seed(1)

    def pair(shape, dtype):
        z = _lrn_pre(shape, dtype, gen)
        return z, torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def unfused(zg, r=2):
        # what the unfused path runs: the LRN backward at F.relu(z), then
        # the ReLU's own backward (autograd's threshold_backward)
        x = F.relu(zg[0])
        return torch.ops.aten.threshold_backward(bwd(x, zg[1], r), x, 0.0)

    def library(zg):
        # the library yardstick: autograd of torch's LRN over dim 1 of the
        # NCHW view of the ReLU's output, alpha scaled back by n; the
        # forward graph is built outside the timed window, so only the
        # backward is timed
        z, g = zg
        xr = F.relu(z).detach().requires_grad_()
        y = F.local_response_norm(xr.permute(0, 3, 1, 2), 5, alpha=5e-4,
                                  beta=0.75, k=2.0)
        return lambda: torch.autograd.grad(y, xr, g.permute(0, 3, 1, 2),
                                           retain_graph=True)

    records = []
    main = [((1024, 54, 54, 64), "conv1", 1024),
            ((1024, 27, 27, 256), "conv2", 1024),
            ((32, 54, 54, 64), "conv1", 32),
            ((32, 27, 27, 256), "conv2", 32)]
    for dtype, rtol, atol in ((torch.bfloat16, 8e-3, 1e-6),
                              (torch.float32, 1e-5, 1e-5)):
        for shape, site, batch, r, want in _lrn_cases(main):
            variant = lrn_cuda.variant(shape, dtype, r)
            check(variant == want, f"{shape} {dtype} r={r} takes the "
                  f"{variant} variant, expected {want}")
            z, g = pair(shape, dtype)
            err = 0.0
            for got, want_t in ((bwd(z, g, r), local_response_norm_bwd(z, g,
                                                                       r)),
                                (bwd(z, g, r, relu=True),
                                 relu_local_response_norm_bwd(z, g, r))):
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want_t.float(),
                                           rtol=rtol, atol=atol)
                err = max(err, float((got.float() - want_t.float())
                                     .abs().max()))
                del got, want_t
            fused = bwd(z, g, r, relu=True)
            bit_equal = torch.equal(_bits(fused), _bits(unfused((z, g), r)))
            repeat = torch.equal(_bits(fused),
                                 _bits(bwd(z, g, r, relu=True)))
            check(bit_equal, f"fused LRN backward at {shape} {dtype} r={r} "
                  "is not the unfused kernel's bits on F.relu(z), masked")
            check(repeat, f"two LRN backward launches at {shape} {dtype} "
                  f"r={r} differ")
            rec = {"site": site, "batch": batch, "shape": list(shape),
                   "radius": r, "variant": variant,
                   "dtype": str(dtype).replace("torch.", ""), "rtol": rtol,
                   "atol": atol, "max_abs_err": err,
                   "fused_bit_equal": bit_equal, "repeat_bit_equal": repeat}
            del z, g, fused
            if batch is not None:
                # cold inputs: 40 distinct pairs at batch 32; at batch 1024
                # one pair is 7-14x the L2, so 3 pairs suffice
                inputs = [pair(shape, dtype)
                          for _ in range(40 if batch == 32 else 3)]
                relu_in = [(F.relu(z), g) for z, g in inputs]
                # the main path's kernel: the ReLU's backward fused
                rec["ms"] = device_ms(lambda zg: bwd(*zg, relu=True), inputs)
                rec["unfused_ms"] = device_ms(lambda xg: bwd(*xg), relu_in)
                rec["relu_bwd_ms"] = device_ms(
                    lambda xg: torch.ops.aten.threshold_backward(
                        xg[1], xg[0], 0.0), relu_in)
                rec["plain_ms"] = device_ms(
                    lambda zg: relu_local_response_norm_bwd(*zg), inputs)
                calls = [library(zg) for zg in inputs]
                rec["library_ms"] = device_ms(lambda call: call(), calls)
                bound, by = lrn_bwd_bound_ms(shape, torch.finfo(dtype).bits // 8,
                                             2, peaks)
                rec["bound_ms"], rec["bound_by"] = bound, by
                del inputs, relu_in, calls
            records.append(rec)
            emit("kernel_bwd", name="lrn_bwd", **rec)
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
        lrn_cuda.VEC_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        out[dev] = {
            "loss": float(metrics["loss"]),
            "grads": {k: None if p.grad is None else p.grad.cpu()
                      for k, p in model.named_parameters()},
            "updates": {k: p.detach().cpu() - p0[k]
                        for k, p in model.named_parameters()},
            "launches": (lrn_cuda.LAUNCHES, lrn_cuda.BWD_LAUNCHES),
            "vec_launches": (lrn_cuda.VEC_LAUNCHES,
                             lrn_cuda.VEC_BWD_LAUNCHES)}
        del model, opt, state
    torch.cuda.empty_cache()
    cpu, card = out["cpu"], out["cuda"]
    check(card["launches"] == (2, 2) and cpu["launches"] == (0, 0),
          f"LRN launches card {card['launches']} cpu {cpu['launches']}")
    check(card["vec_launches"] == (2, 2),
          f"vector LRN launches on the card {card['vec_launches']}")
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
            "relu_us_per_step": t["relu_us"],
            "flash_us_per_step": t["flash_us"],
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
    lrn_cuda.VEC_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    state = trainer.fit(state, data, num_steps=steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fwd": lrn_cuda.LAUNCHES, "bwd": lrn_cuda.BWD_LAUNCHES}
    vec_launches = {"fwd": lrn_cuda.VEC_LAUNCHES,
                    "bwd": lrn_cuda.VEC_BWD_LAUNCHES}
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
         lrn_launches=launches, lrn_vec_launches=vec_launches,
         profile=profile)
    check(state.step == steps + profile["steps"] and len(recs) == steps,
          f"{state.step} steps, {len(recs)} records")
    check(launches == {"fwd": 2 * steps, "bwd": 2 * steps},
          f"LRN launches {launches} over {steps} steps, expected 2 forward "
          "and 2 backward a step")
    check(vec_launches == launches,
          f"vector LRN launches {vec_launches} of {launches}: every "
          "training launch takes the vector variant")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(all(r["bad_step"] == 0.0 for r in recs), "a step was skipped")
    check(last < first, f"loss did not fall on a fixed batch: mean of the "
          f"first 5 steps {first}, of the last 5 {last}")
    del trainer, state, data
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- ViT phases
#: ViT-S/16's attention on the card: T = 197 tokens, 6 heads of 64
_VIT_T, _VIT_H, _VIT_D = 197, 6, 64
_FLASH = {"attention_layout": "flash"}
_FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def _flash_counts():
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    return {"fwd": flash_cuda.FWD_LAUNCHES, "dq": flash_cuda.DQ_LAUNCHES,
            "dkv": flash_cuda.DKV_LAUNCHES}


def _zero_flash_counts():
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    flash_cuda.FWD_LAUNCHES = flash_cuda.DQ_LAUNCHES = 0
    flash_cuda.DKV_LAUNCHES = 0


def flash_flops(kind, b, t, h, d, causal, kv_len):
    """The products' FLOPs of one flash kernel on (B, T, H, D) over this
    run's live (query, key) pairs: 2 products in the forward, 3 in dQ, 4 in
    dK/dV, each 2*D a pair."""
    live = sum(min(i + 1, kv_len) if causal else kv_len for i in range(t))
    products = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}[kind]
    return products * 2 * d * b * h * live


def flash_bound_ms(kind, b, t, h, d, itemsize, causal, kv_len, peaks):
    """Least time for one flash kernel on (B, T, H, D): each input read
    once and each output written once (lse and delta as one fp32 a row)
    at the memory rate, against the products' FLOPs (flash_flops) at the
    peak for the inputs' type (bf16 tensor cores; fp32 off them)."""
    bw, fp32_flops = peaks
    n = b * t * h * d * itemsize
    rows = b * h * t * 4
    moved = {"flash_fwd": 4 * n + rows, "flash_dq": 5 * n + 2 * rows,
             "flash_dkv": 6 * n + 2 * rows}[kind]
    flops = flash_flops(kind, b, t, h, d, causal, kv_len)
    peak = _BF16_TENSOR_FLOPS if itemsize == 2 else fp32_flops
    bytes_ms, ops_ms = moved / bw * 1e3, flops / peak * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def _flash_phase(phase, cases, peaks, seed):
    """The flash forward, dQ and dK/dV kernels against their plain
    versions on the card, in bf16 and fp32, for `cases` of (site,
    (B, T, H, D), causal, kv_len, input sets to time over; 0: check
    only); timed cases also get the device times of the plain version
    and the library call (SDPA, its autograd backward for dQ and dK/dV
    together) and the bytes/operations bound. Returns the records."""
    import torch.nn.functional as F

    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        attention_delta, attention_dkv, attention_dq, attention_fwd)
    from distributed_vgg_f_tpu_torch.ops.flash_cuda import (flash_dkv_cuda,
                                                            flash_dq_cuda,
                                                            flash_fwd_cuda)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def inputs(b, t, h, d, dtype, kw):
        # q, k and v as the model passes them: slices of one QKV output
        q, k, v = torch.randn(b, t, 3, h, d, generator=gen,
                              device="cuda").to(dtype).unbind(2)
        do = torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
        o, lse = flash_fwd_cuda(q, k, v, **kw)
        return q, k, v, do, lse, attention_delta(do, o)

    def sdpa(x, causal):
        return F.scaled_dot_product_attention(
            *(y.transpose(1, 2) for y in x[:3]), is_causal=causal)

    def sdpa_bwd(x, causal):
        # the library yardstick of both backward kernels: autograd of
        # SDPA, its forward graph built outside the timed window
        qr, kr, vr = (y.detach().transpose(1, 2).requires_grad_()
                      for y in x[:3])
        o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        return lambda: torch.autograd.grad(o, (qr, kr, vr),
                                           x[3].transpose(1, 2),
                                           retain_graph=True)

    records = []
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        for site, (b, t, h, d), causal, kv_len, n_sets in cases:
            kw = {"causal": causal, "kv_len": kv_len}
            q, k, v, do, _, _ = inputs(b, t, h, d, dtype, kw)
            o, lse = flash_fwd_cuda(q, k, v, **kw)
            o_ref, lse_ref = attention_fwd(q, k, v, **kw)
            delta = attention_delta(do, o_ref)
            got = {"flash_fwd": (o, lse),
                   "flash_dq": (flash_dq_cuda(q, k, v, do, lse_ref, delta,
                                              **kw),),
                   "flash_dkv": flash_dkv_cuda(q, k, v, do, lse_ref, delta,
                                               **kw)}
            want = {"flash_fwd": (o_ref, lse_ref),
                    "flash_dq": (attention_dq(q, k, v, do, lse_ref, delta,
                                              **kw),),
                    "flash_dkv": attention_dkv(q, k, v, do, lse_ref, delta,
                                               **kw)}
            torch.cuda.synchronize()
            if kv_len is not None:
                dk, dv = got["flash_dkv"]
                check(bool((dk[:, kv_len:] == 0).all()
                           and (dv[:, kv_len:] == 0).all()),
                      f"padding keys got a gradient at {site}")
            recs = {}
            for name in _FLASH_KERNELS:
                err = rel = 0.0
                for i, (g, w) in enumerate(zip(got[name], want[name])):
                    g, w = g.float(), w.float()
                    e = float((g - w).abs().max())
                    scale = float(w.abs().max())
                    # lse (the forward's second output) is fp32 in both
                    bound = (1e-5 if i == 1 and name == "flash_fwd"
                             else tol) * scale
                    check(bool(torch.isfinite(g).all()) and e <= bound,
                          f"{name} off its plain version by {e} at {site} "
                          f"{dtype} (allowed {bound})")
                    err, rel = max(err, e), max(rel, e / scale)
                recs[name] = {"name": name, "site": site,
                              "shape": [b, t, h, d],
                              "dtype": str(dtype).replace("torch.", ""),
                              "causal": causal, "kv_len": kv_len,
                              "tol_of_max": tol, "max_abs_err": err,
                              "max_rel_err": rel}
            del q, k, v, do, o, lse, o_ref, lse_ref, delta, got, want
            torch.cuda.empty_cache()
            if n_sets:
                sets = [inputs(b, t, h, d, dtype, kw) for _ in range(n_sets)]
                calls = [sdpa_bwd(x, causal) for x in sets]
                lib_bwd = device_ms(lambda c: c(), calls)
                del calls
                timed = {
                    "flash_fwd": (lambda x: flash_fwd_cuda(*x[:3], **kw),
                                  lambda x: attention_fwd(*x[:3], **kw),
                                  lambda x: sdpa(x, causal)),
                    "flash_dq": (lambda x: flash_dq_cuda(*x, **kw),
                                 lambda x: attention_dq(*x, **kw), None),
                    "flash_dkv": (lambda x: flash_dkv_cuda(*x, **kw),
                                  lambda x: attention_dkv(*x, **kw), None)}
                sdpa_name = ("F.scaled_dot_product_attention"
                             + ("(is_causal=True)" if causal else ""))
                for name, (kern, plain, lib) in timed.items():
                    rec = recs[name]
                    rec["ms"] = device_ms(kern, sets)
                    rec["plain_ms"] = device_ms(plain, sets)
                    rec["library_ms"] = (device_ms(lib, sets) if lib
                                         else lib_bwd)
                    rec["library"] = (sdpa_name if lib else
                                      f"autograd backward of {sdpa_name} "
                                      "(dQ, dK and dV together)")
                    live_len = t if kv_len is None else kv_len
                    rec["bound_ms"], rec["bound_by"] = flash_bound_ms(
                        name, b, t, h, d, dtype.itemsize, causal, live_len,
                        peaks)
                    # the kernel's issued rate over the live pairs
                    rec["tflops"] = flash_flops(
                        name, b, t, h, d, causal, live_len) / (
                            rec["ms"] * 1e-3) / 1e12
                del sets
            for rec in recs.values():
                records.append(rec)
                emit(phase, **rec)
            torch.cuda.empty_cache()
    return records


#: head dims the flash kernels are checked at beyond ViT's 64: the padded
#: widths, a head dim that runs padded (8, as the JAX ring tests use) and
#: one whose rows a tensor map cannot read in place (100: the bf16
#: forward's wrapper copies it)
_HEAD_DIMS = (8, 16, 32, 100, 128, 256)
#: sequence lengths around the 64- and 128-row tiles and the K/V ring's
#: two stages, each with a kv_len mask: (T, kv_len)
_RING_STRESS = ((1, 1), (63, 50), (64, 64), (65, 33), (129, 100),
                (197, 180), (2048, 1500))


def _ring_stress(phase, causal, seed):
    """The forward kernel, whose K/V ring and tiles the lengths of
    _RING_STRESS stress, against its plain version at (2, T, 3, 64) in
    bf16 and fp32 (a stage-count or phase-parity fault shows as a wrong
    row or a trap). The forward alone: at T = 1 the exact dQ and dK are
    zero (one key: dS = p (dO.v - dO.o) with o = v), so both sides of
    their check would be rounding noise. Returns the records."""
    from distributed_vgg_f_tpu_torch.ops.flash_attention import \
        attention_fwd
    from distributed_vgg_f_tpu_torch.ops.flash_cuda import flash_fwd_cuda
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        for t, kv_len in _RING_STRESS:
            shape = (2, t, 3, _VIT_D)
            q, k, v = torch.randn(shape[0], t, 3, *shape[2:], generator=gen,
                                  device="cuda").to(dtype).unbind(2)
            kw = {"causal": causal, "kv_len": kv_len}
            got = flash_fwd_cuda(q, k, v, **kw)
            want = attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            err = rel = 0.0
            for i, (g, w) in enumerate(zip(got, want)):
                g, w = g.float(), w.float()
                e, scale = float((g - w).abs().max()), float(w.abs().max())
                bound = (1e-5 if i == 1 else tol) * scale  # lse: fp32
                check(bool(torch.isfinite(g).all()) and e <= bound,
                      f"flash_fwd off its plain version by {e} at ring "
                      f"stress T = {t} causal={causal} {dtype} (allowed "
                      f"{bound})")
                err, rel = max(err, e), max(rel, e / scale)
            rec = {"name": "flash_fwd", "site": f"ring_stress_{t}",
                   "shape": list(shape),
                   "dtype": str(dtype).replace("torch.", ""),
                   "causal": causal, "kv_len": kv_len, "tol_of_max": tol,
                   "max_abs_err": err, "max_rel_err": rel}
            records.append(rec)
            emit(phase, **rec)
    return records


#: the backward's stress lengths: those of _RING_STRESS but T = 1, whose
#: exact dQ and dK are zero, and T = 2 in its place, with their kv_len masks
_BWD_STRESS = ((2, 2),) + _RING_STRESS[1:]
#: head dims of the backward stress: ViT's, and the widest, whose dK/dV
#: splits its columns between the two consumer warpgroups
_BWD_STRESS_DIMS = (_VIT_D, 256)


def _bwd_stress(phase, causal, seed):
    """dQ and dK/dV against their plain versions at (2, T, 3, D) for the
    lengths of _BWD_STRESS, which sit around the kernels' 64- and 128-row
    tiles and the stages of their rings, at the head dims of
    _BWD_STRESS_DIMS, in bf16 and fp32 (1e-2 / 1e-5 of the largest value);
    keys at or past kv_len must get exactly zero dK and dV. Returns the
    records."""
    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        attention_delta, attention_dkv, attention_dq, attention_fwd)
    from distributed_vgg_f_tpu_torch.ops.flash_cuda import (flash_dkv_cuda,
                                                            flash_dq_cuda)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        for d in _BWD_STRESS_DIMS:
            for t, kv_len in _BWD_STRESS:
                q, k, v = torch.randn(2, t, 3, 3, d, generator=gen,
                                      device="cuda").to(dtype).unbind(2)
                do = torch.randn(2, t, 3, d, generator=gen,
                                 device="cuda").to(dtype)
                kw = {"causal": causal, "kv_len": kv_len}
                o, lse = attention_fwd(q, k, v, **kw)
                delta = attention_delta(do, o)
                args = (q, k, v, do, lse, delta)
                got = {"flash_dq": (flash_dq_cuda(*args, **kw),),
                       "flash_dkv": flash_dkv_cuda(*args, **kw)}
                want = {"flash_dq": (attention_dq(*args, **kw),),
                        "flash_dkv": attention_dkv(*args, **kw)}
                torch.cuda.synchronize()
                dk, dv = got["flash_dkv"]
                check(bool((dk[:, kv_len:] == 0).all()
                           and (dv[:, kv_len:] == 0).all()),
                      f"padding keys got a gradient at backward stress "
                      f"T = {t} D = {d} causal={causal} {dtype}")
                for name in ("flash_dq", "flash_dkv"):
                    err = rel = 0.0
                    for g, w in zip(got[name], want[name]):
                        g, w = g.float(), w.float()
                        e = float((g - w).abs().max())
                        scale = float(w.abs().max())
                        check(bool(torch.isfinite(g).all())
                              and e <= tol * scale,
                              f"{name} off its plain version by {e} at "
                              f"backward stress T = {t} D = {d} "
                              f"causal={causal} {dtype} (allowed "
                              f"{tol * scale})")
                        err, rel = max(err, e), max(rel, e / scale)
                    rec = {"name": name, "site": f"bwd_stress_{t}",
                           "shape": [2, t, 3, d],
                           "dtype": str(dtype).replace("torch.", ""),
                           "causal": causal, "kv_len": kv_len,
                           "tol_of_max": tol, "max_abs_err": err,
                           "max_rel_err": rel}
                    records.append(rec)
                    emit(phase, **rec)
    return records


def _bwd_repeat(phase, shape, causal, seed):
    """dQ, dK and dV of two launches on the same bf16 inputs must be the
    same bits: no kernel sums with atomics."""
    from distributed_vgg_f_tpu_torch.ops.flash_attention import \
        attention_delta
    from distributed_vgg_f_tpu_torch.ops.flash_cuda import (flash_dkv_cuda,
                                                            flash_dq_cuda,
                                                            flash_fwd_cuda)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, t, h, d = shape
    q, k, v = torch.randn(b, t, 3, h, d, generator=gen,
                          device="cuda").to(torch.bfloat16).unbind(2)
    do = torch.randn(b, t, h, d, generator=gen,
                     device="cuda").to(torch.bfloat16)
    o, lse = flash_fwd_cuda(q, k, v, causal=causal)
    args = (q, k, v, do, lse, attention_delta(do, o))
    first = (flash_dq_cuda(*args, causal=causal),
             *flash_dkv_cuda(*args, causal=causal))
    second = (flash_dq_cuda(*args, causal=causal),
              *flash_dkv_cuda(*args, causal=causal))
    torch.cuda.synchronize()
    same = [bool(torch.equal(x, y)) for x, y in zip(first, second)]
    check(all(same), f"dQ, dK, dV of two launches differ at {shape} "
          f"causal={causal}: bit-equal {same}")
    emit(phase, name="flash_bwd_repeat", shape=list(shape), causal=causal,
         dtype="bfloat16", bit_equal={"dq": same[0], "dk": same[1],
                                      "dv": same[2]})


def phase_flash_kernel(peaks):
    """Flash forward, dQ and dK/dV kernels vs their plain versions on the
    card at ViT-S/16's shapes, a ragged and a causal one, at head dims 8
    to 256 (JAX's test_wide_head_dim shape (1, 128, 1, 256) causal among
    them), at B*H = 65600 (above the 65535 of a grid's y axis), and at the
    ring stress lengths (the forward) and the backward stress lengths
    (dQ, dK/dV); then the backward's bit-equal repeat at ViT's layer;
    returns the records."""
    records = _flash_phase("flash_kernel", [
        ("vit_train", (1024, _VIT_T, _VIT_H, _VIT_D), False, None, 3),
        ("vit_serve", (32, _VIT_T, _VIT_H, _VIT_D), False, None, 40),
        ("ragged", (3, 77, 2, 32), False, 50, 0),
        ("causal", (2, 300, 3, 64), True, 250, 0),
        *((f"head_dim_{d}", (2, _VIT_T, 3, d), i % 2 == 1, 150, 0)
          for i, d in enumerate(_HEAD_DIMS)),
        ("wide_head", (1, 128, 1, 256), True, None, 0),
        # timed at the wide head dims, where the bf16 backward kernels
        # (mma.sync) spill registers: ViT's T with heads of 128 and 256
        ("wide_128", (256, _VIT_T, _VIT_H, 128), False, None, 2),
        ("wide_256", (128, _VIT_T, _VIT_H, 256), False, None, 2),
        ("bh_65600", (65600, 8, 1, 64), False, None, 0)], peaks,
        seed=3)
    records += _ring_stress("flash_kernel", False, seed=4)
    records += _bwd_stress("flash_kernel", False, seed=5)
    _bwd_repeat("flash_kernel", (1024, _VIT_T, _VIT_H, _VIT_D), False,
                seed=6)
    return records


def _tree_size(tree):
    """Number of values in a nested param tree."""
    return int(sum(_tree_size(v) if isinstance(v, dict) else v.size
                   for v in tree.values()))


def _vit_cfg():
    """vit_s16_imagenet with the flash layout."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.config import get_config
    cfg = get_config("vit_s16_imagenet")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, extra=dict(_FLASH)))


def phase_vit_model(tree):
    """Full-width ViT-S/16 through build_engine with the flash layout on
    the ladder; logits against the CPU forward of the same weights and
    against the head_major layout on the card."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.serving.engine import build_engine
    from distributed_vgg_f_tpu_torch.weights import load_params
    cfg = _vit_cfg()
    size, classes = cfg.data.image_size, cfg.model.num_classes
    depth = 12
    # seed 0: the same weights as `tree` (init_params with seed 0)
    engine = build_engine("vit_s16", size, classes, cfg.serving.buckets,
                          cfg.serving.max_batch, device="cuda",
                          compute_dtype=cfg.model.compute_dtype, seed=0,
                          extra=_FLASH)
    _zero_flash_counts()
    engine.warmup()
    torch.cuda.synchronize()
    check(_flash_counts() == {"fwd": depth * len(engine.buckets), "dq": 0,
                              "dkv": 0},
          f"warmup of {len(engine.buckets)} buckets: flash launches "
          f"{_flash_counts()}, expected {depth} forward per forward")
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (32, size, size, 3)).astype(np.uint8)
    before = _flash_counts()["fwd"]
    probs, bucket = engine.run(imgs)
    check(_flash_counts()["fwd"] == before + depth,
          f"one forward, not {depth} flash launches")
    check(probs.shape == (32, classes) and bucket == 32,
          f"probs {probs.shape} bucket {bucket}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    sums_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    check(sums_err <= 1e-3, f"probabilities sum off 1 by {sums_err}")
    forward_ms = {}
    for b in engine.buckets:
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine.run(imgs[:b])
            ts.append((time.perf_counter() - t0) * 1e3)
        forward_ms[str(b)] = statistics.median(ts)

    x = torch.from_numpy(((imgs[:2].astype(np.float32)
                           - np.asarray(cfg.data.mean_rgb, np.float32))
                          * (np.float32(1.0) / np.asarray(
                              cfg.data.stddev_rgb, np.float32))))

    def logits(dtype, layout, dev):
        model_cfg = dataclasses.replace(cfg.model, compute_dtype=dtype,
                                        extra={"attention_layout": layout})
        model = load_params(build_model(model_cfg, image_size=size),
                            tree).to(dev).eval()
        with torch.no_grad():
            return model(x.to(dev)).cpu().numpy()

    ref = logits("float32", "flash", "cpu")
    got32 = logits("float32", "flash", "cuda")
    got16 = logits("bfloat16", "flash", "cuda")
    head32 = logits("float32", "head_major", "cuda")
    head16 = logits("bfloat16", "head_major", "cuda")
    scale = float(np.abs(ref).max())
    errs = {"fp32_vs_cpu": float(np.abs(got32 - ref).max()),
            "bf16_vs_cpu": float(np.abs(got16 - ref).max()),
            "fp32_vs_head_major": float(np.abs(got32 - head32).max()),
            "bf16_vs_head_major": float(np.abs(got16 - head16).max())}
    # fp32 with TF32 off: sums in another order than the CPU (1e-3, the
    # VGG-F bound); bf16: every activation rounded to 8 mantissa bits
    # through 12 blocks (2e-2 of the largest logit). Flash against
    # head_major on the card in fp32: the same function summed in another
    # order (1e-4); in bf16 the two round at different points (head_major
    # scales q and keeps its scores in bf16)
    check(np.allclose(got32, ref, rtol=1e-3, atol=1e-3),
          f"fp32 card logits off the CPU by {errs['fp32_vs_cpu']}")
    check(np.allclose(got16, ref, rtol=2e-2, atol=2e-2 * scale),
          f"bf16 card logits off the CPU fp32 by {errs['bf16_vs_cpu']}")
    check(np.allclose(got32, head32, rtol=1e-4, atol=1e-4),
          f"fp32 flash off head_major by {errs['fp32_vs_head_major']}")
    check(np.allclose(got16, head16, rtol=2e-2, atol=2e-2 * scale),
          f"bf16 flash off head_major by {errs['bf16_vs_head_major']}")
    profile = {}
    from torch.profiler import ProfilerActivity, profile as tprofile
    for b in (1, 32):
        for _ in range(3):
            engine.run(imgs[:b])
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                engine.run(imgs[:b])
            torch.cuda.synchronize()
        t = _trace_breakdown(prof, 5, top=12)
        profile[str(b)] = {
            "window_us_per_forward": t["window_us"],
            "device_busy_us_per_forward": t["busy_us"],
            "device_idle_share": t["idle_share"],
            "flash_fwd_us_per_forward": t["flash_us"]["flash_fwd"],
            "top_device_us_per_forward": t["top_us"]}
    emit("vit_model", model="vit_s16", attention_layout="flash",
         image_size=size, num_classes=classes, depth=depth,
         compute_dtype=cfg.model.compute_dtype,
         buckets=list(engine.buckets),
         warmup_s={str(b): s for b, s in sorted(engine.compile_log.items())},
         flash_fwd_launches_per_forward=depth, probs_sum_max_err=sums_err,
         forward_ms=forward_ms,
         images_per_s={b: int(b) / (ms / 1e3)
                       for b, ms in forward_ms.items()},
         ref_max_abs_logit=scale, max_abs_err=errs, profile=profile,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del engine
    torch.cuda.empty_cache()


def phase_vit_serve(tree):
    """The ViT serving path: serve_from_params with the flash layout,
    driven over HTTP."""
    from distributed_vgg_f_tpu_torch import telemetry
    from distributed_vgg_f_tpu_torch.serving.server import serve_from_params
    cfg = _vit_cfg()
    size = cfg.data.image_size
    reg = telemetry.get_registry()
    reg.reset()
    rng = np.random.default_rng(5)
    burst = rng.integers(0, 256, (32, size, size, 3)).astype(np.uint8)
    singles = rng.integers(0, 256, (4, size, size, 3)).astype(np.uint8)
    _zero_flash_counts()
    t_start = time.perf_counter()
    server = serve_from_params(cfg, tree, device="cuda")
    start_s = time.perf_counter() - t_start
    engine = server.engine("vit_s16")
    drive = _drive_server(server, "vit_s16", burst, singles, reg)
    torch.cuda.synchronize()
    launches = _flash_counts()
    forwards = len(engine.compile_log) + reg.counter_value("serving/batches")
    check(launches["fwd"] > 0, "the ViT serving path never launched the "
          "flash forward kernel")
    check(launches == {"fwd": 12 * forwards, "dq": 0, "dkv": 0},
          f"flash launches {launches} for {forwards} forwards, expected 12 "
          "forward launches per forward and no backward")
    seq_lat, seq_err = _check_served_probs(engine, singles,
                                           drive["seq_bodies"])
    emit("vit_serve", model="vit_s16", attention_layout="flash",
         **_serve_record(reg, burst, singles, drive, seq_lat, seq_err,
                         start_s, engine, forwards),
         flash_launches=launches)
    del server, engine
    torch.cuda.empty_cache()
    return launches["fwd"]


def phase_vit_train_parity(tree):
    """One fp32 train step of full-width ViT-S/16 (flash) on the card and
    on the CPU from the same weights and batch."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.data.device_ingest import \
        make_device_finish
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
    from distributed_vgg_f_tpu_torch.train.state import TrainState
    from distributed_vgg_f_tpu_torch.train.step import build_train_step
    from distributed_vgg_f_tpu_torch.weights import load_params
    cfg = _vit_cfg()
    size = cfg.data.image_size
    model_cfg = dataclasses.replace(cfg.model, compute_dtype="float32",
                                    dropout_rate=0.0)
    rng = np.random.default_rng(6)
    batch = {"image": rng.integers(0, 256, (2, size, size, 3), np.uint8),
             "label": rng.integers(0, cfg.model.num_classes, (2,))}
    finish = make_device_finish(cfg.data.mean_rgb, cfg.data.stddev_rgb)
    # the update runs at the schedule's peak (past the 5 warmup epochs,
    # whose first update has LR 0), scaled from 1e-3 to 1.0: at 1e-3 the
    # updates of the LayerNorm scales (parameters of 1.0) fall to the
    # fp32 resolution of the parameters, so p1 - p0 would measure rounding
    warmup = int(cfg.optim.warmup_epochs * cfg.steps_per_epoch)
    lr_scale = 1e3
    out = {}
    for dev in ("cpu", "cuda"):
        model = load_params(build_model(model_cfg, image_size=size),
                            tree).to(dev)
        p0 = {k: p.detach().cpu().clone()
              for k, p in model.named_parameters()}
        opt, schedule = build_optimizer(cfg, model.parameters(),
                                        lr_scale=lr_scale)
        state = TrainState.create(model, opt)
        state.opt_count = warmup
        step = build_train_step(schedule, cfg.optim.weight_decay,
                                skip_nonfinite=True, device_finish=finish,
                                device=dev)
        _zero_flash_counts()
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        out[dev] = {
            "loss": float(metrics["loss"]), "lr": schedule(warmup),
            "grads": {k: None if p.grad is None else p.grad.cpu()
                      for k, p in model.named_parameters()},
            "updates": {k: p.detach().cpu() - p0[k]
                        for k, p in model.named_parameters()},
            "launches": _flash_counts()}
        del model, opt, state
    torch.cuda.empty_cache()
    cpu, card = out["cpu"], out["cuda"]
    check(card["launches"] == {"fwd": 12, "dq": 12, "dkv": 12}
          and cpu["launches"] == {"fwd": 0, "dq": 0, "dkv": 0},
          f"flash launches card {card['launches']} cpu {cpu['launches']}")
    check(all(g is not None for g in card["grads"].values()),
          "a parameter got no gradient on the card")
    for k in ("cls", "pos_embed", "patch_embed.weight",
              "block0.attn.qkv.weight"):
        check(float(card["grads"][k].abs().max()) > 0,
              f"{k} got a zero gradient on the card")
    grad_err = {k: _rel_l2(card["grads"][k], cpu["grads"][k])
                for k in cpu["grads"]}
    update_err = {k: _rel_l2(card["updates"][k], cpu["updates"][k])
                  for k in cpu["updates"]}
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    # fp32 on both sides with TF32 off, sums in another order; 1e-4 fails
    # a wrong scale, mask or term in any of the three kernels
    tol = 1e-4
    worst = lambda errs: max(errs.items(), key=lambda kv: kv[1])  # noqa
    emit("vit_train_parity", batch=2, image_size=size, dtype="float32",
         tf32=False, lr=card["lr"], loss_card=card["loss"],
         loss_cpu=cpu["loss"], loss_rel_err=loss_err, tolerance_rel_l2=tol,
         grad_rel_l2_max=worst(grad_err), update_rel_l2_max=worst(update_err),
         grad_rel_l2=grad_err, update_rel_l2=update_err,
         card_flash_launches=card["launches"])
    check(card["lr"] > 0, f"the step ran at LR {card['lr']}")
    check(loss_err <= 1e-4, f"loss card {card['loss']} cpu {cpu['loss']}")
    check(max(grad_err.values()) <= tol, f"gradients off: {worst(grad_err)}")
    check(max(update_err.values()) <= tol,
          f"updates off: {worst(update_err)}")


def phase_vit_train():
    """The ViT training path: Trainer.fit on vit_s16_imagenet with the
    flash layout at full width and batch 1024 for 20 steps on one fixed
    seeded u8 batch."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = _vit_cfg()
    steps = 20
    # cut: the preset's 5 warmup epochs start the LR at 0 and keep it
    # below 4e-6 for 20 steps; without them the cosine starts at its peak
    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, warmup_epochs=0.0),
        train=dataclasses.replace(cfg.train, log_every=1, seed=0))
    b, size = cfg.data.global_batch_size, cfg.data.image_size
    data = SyntheticU8(b, size, cfg.model.num_classes, seed=0, pin=True)
    stamps = []
    trainer = Trainer(cfg, log=lambda event, rec: stamps.append(
        time.perf_counter()))
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    t0 = time.perf_counter()
    state = trainer.fit(state, data, num_steps=steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    recs = [r for r in trainer.records if r["event"] == "train"]
    losses = [r["loss"] for r in recs]
    stamps.insert(0, t0)
    step_ms = [(t1 - t0_) * 1e3 for t0_, t1 in zip(stamps, stamps[1:])]
    median_ms = statistics.median(step_ms[4:])
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    profile = _profile_train(trainer, state, next(iter(data)))
    emit("vit_train", config=cfg.name, attention_layout="flash",
         image_size=size, batch=b, num_classes=cfg.model.num_classes,
         compute_dtype=cfg.model.compute_dtype,
         dropout_rate=cfg.model.dropout_rate,
         augment={"hflip": cfg.data.augment.hflip,
                  "mixup_alpha": cfg.data.augment.mixup_alpha},
         schedule=cfg.optim.schedule, warmup_epochs=cfg.optim.warmup_epochs,
         skip_nonfinite=cfg.train.skip_nonfinite, steps=steps,
         wall_s=wall_s, first_step_ms=step_ms[0],
         step_ms_median=median_ms, step_ms=step_ms,
         images_per_s=b / (median_ms / 1e3),
         meter_images_per_sec=recs[-1]["images_per_sec"],
         peak_memory_bytes=peak, losses=losses,
         grad_norms=[r["grad_norm"] for r in recs],
         loss_first5_mean=first, loss_last5_mean=last,
         flash_launches=launches, profile=profile)
    check(state.step == steps + profile["steps"] and len(recs) == steps,
          f"{state.step} steps, {len(recs)} records")
    check(launches == {"fwd": 12 * steps, "dq": 12 * steps,
                       "dkv": 12 * steps},
          f"flash launches {launches} over {steps} steps, expected 12 of "
          "each kernel a step")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(all(r["bad_step"] == 0.0 for r in recs), "a step was skipped")
    check(last < first, f"loss did not fall on a fixed batch: mean of the "
          f"first 5 steps {first}, of the last 5 {last}")
    del trainer, state, data
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------- causal flash at long T
#: ViT-S/16's heads at the long-context lengths of the repo's flash
#: benchmark (benchmarks/flash_attention_bench.py): batch 4, T to 8192
_LONG_B, _LONG_TS = 4, (2048, 8192)


def phase_flash_causal(peaks):
    """The flash kernels with causal=True at T = 2048 and 8192 (where the
    JAX package's "auto" picks its jagged grids on the TPU), against
    their plain versions, timed against causal SDPA and the bound over
    the causal live pairs, then the stress lengths of the forward and the
    backward, causal, and the backward's bit-equal repeat at T = 2048;
    returns the records (rows 4, 7 and 8 of PERF.md's kernel table)."""
    records = _flash_phase("flash_causal", [
        (f"causal_{t}", (_LONG_B, t, _VIT_H, _VIT_D), True, None, 2)
        for t in _LONG_TS], peaks, seed=11)
    records += _ring_stress("flash_causal", True, seed=12)
    records += _bwd_stress("flash_causal", True, seed=13)
    _bwd_repeat("flash_causal", (_LONG_B, 2048, _VIT_H, _VIT_D), True,
                seed=14)
    return records


# ------------------------------------------------------ ring block kernels
_BLOCK_KERNELS = ("flash_block_fwd", "flash_block_dq", "flash_block_dkv")


def _block_counts():
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    return {"block_fwd": flash_cuda.BLOCK_FWD_LAUNCHES,
            "block_dq": flash_cuda.BLOCK_DQ_LAUNCHES,
            "block_dkv": flash_cuda.BLOCK_DKV_LAUNCHES}


def _zero_block_counts():
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    flash_cuda.BLOCK_FWD_LAUNCHES = flash_cuda.BLOCK_DQ_LAUNCHES = 0
    flash_cuda.BLOCK_DKV_LAUNCHES = 0


def block_flops(kind, bh, tq, d, q_off, k_off, causal, kv_len):
    """The products' FLOPs of one ring block step over its live (query,
    key) pairs: 2 products in the fold, 3 in dQ, 4 in dK/dV, each 2*D a
    pair."""
    live = sum(min(kv_len, max(0, q_off + i - k_off + 1)) if causal
               else kv_len for i in range(tq))
    products = {"flash_block_fwd": 2, "flash_block_dq": 3,
                "flash_block_dkv": 4}[kind]
    return products * 2 * d * bh * live


def block_bound_ms(kind, bh, tq, tk, d, itemsize, q_off, k_off, causal,
                   kv_len, peaks):
    """Least time for one ring block step: each input read once (q, k, v,
    and dO, lse and delta in the backward), the fp32 state or accumulators
    read and written once, at the memory rate, against the products' FLOPs
    over this step's live (query, key) pairs (block_flops) at the peak
    for the inputs' type."""
    bw, fp32_flops = peaks
    q_bytes, kv_bytes = bh * tq * d * itemsize, bh * tk * d * itemsize
    rows = bh * tq * 4
    moved = {
        # q, k, v; acc (fp32) and m, l in and out
        "flash_block_fwd": (q_bytes + 2 * kv_bytes + 2 * bh * tq * d * 4
                            + 4 * rows),
        # q, k, v, dO, lse, delta; dq (fp32) in and out
        "flash_block_dq": (2 * q_bytes + 2 * kv_bytes + 2 * rows
                           + 2 * bh * tq * d * 4),
        # q, k, v, dO, lse, delta; dk and dv (fp32) in and out
        "flash_block_dkv": (2 * q_bytes + 2 * kv_bytes + 2 * rows
                            + 4 * bh * tk * d * 4)}[kind]
    flops = block_flops(kind, bh, tq, d, q_off, k_off, causal, kv_len)
    peak = _BF16_TENSOR_FLOPS if itemsize == 2 else fp32_flops
    bytes_ms, ops_ms = moved / bw * 1e3, flops / peak * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def _sdpa_block_bwd(x, b, h, causal):
    """The library yardstick of the block dQ and dK/dV: PyTorch's flash
    attention backward on this block alone, given the out and lse of its
    own flash forward (built here, outside any timed window). Returns
    (call, out, lse): call() gives the block's dQ, dK and dV contributions
    from zero as (B, H, T, D); out (B*H, T, D) and lse (B*H, T, 1) are
    what it was given. It recomputes delta = rowsum(dO * out) itself, adds
    into no carried state and takes no kv_len."""
    bh, t, d = x["q"].shape
    q4, k4, v4, do4 = (x[key].view(b, h, -1, d)
                       for key in ("q", "k", "v", "do"))
    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, causal,
                                                 False)

    def call():
        return aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, out, lse, cq, ck, mq, mk, 0.0, causal, seed,
            offset)
    return call, out.reshape(bh, t, d), lse.reshape(bh, t, 1)


_SDPA_BWD = "torch.ops.aten._scaled_dot_product_flash_attention_backward"
_SDPA_FWD = "torch.ops.aten._scaled_dot_product_flash_attention"


def _sdpa_block_fwd(x, b, h, causal):
    """The library yardstick of the block fold: PyTorch's flash attention
    forward on this block alone, as (out (B, H, T, D), lse (B, H, T)). It
    starts from an empty state: it reads no carried (acc, m, l), merges
    into none and takes no kv_len."""
    bh, t, d = x["q"].shape
    q4, k4, v4 = (x[key].view(b, h, -1, d) for key in ("q", "k", "v"))
    return torch.ops.aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, causal)[:2]


def _library_block_fwd(x, b, h, kw):
    """Whether the library yardstick (_sdpa_block_fwd) computes this
    block's fold: its out against acc / l of block_update_plain from a
    state that has seen nothing, within bf16's 1e-2 of the largest value.
    Returns (ok, description)."""
    from distributed_vgg_f_tpu_torch.ops.flash_attention import \
        block_update_plain
    name = _SDPA_FWD + ("(is_causal=True)" if kw["causal"] else "")
    try:
        out, lse = _sdpa_block_fwd(x, b, h, kw["causal"])
    except (RuntimeError, TypeError, ValueError) as e:
        return False, f"none: {name} refused the block: {e}"[:300]
    bh, t, d = x["q"].shape
    acc, m, l = block_update_plain(
        x["q"], x["k"], x["v"], torch.zeros(bh, t, d, device="cuda"),
        torch.full((bh, t, 1), -math.inf, device="cuda"),
        torch.zeros(bh, t, 1, device="cuda"), **kw)
    want = acc / l
    got = out.float().reshape(want.shape)
    e, bound = float((got - want).abs().max()), 1e-2 * float(
        want.abs().max())
    if not (bool(torch.isfinite(got).all()) and e <= bound):
        return False, (f"none: {name}'s out is off acc / l of "
                       f"block_update_plain by {e} (allowed {bound})")
    lse_err = float((lse.reshape(m.shape) - (m + torch.log(l))).abs().max())
    return True, (f"{name}: the block's out and lse from an empty state "
                  f"(lse off m + log l by {lse_err}); no carried state, no "
                  "merge, no kv_len")


def _library_block_bwd(x, b, h, kw):
    """Whether the library yardstick (_sdpa_block_bwd) computes this
    block's function: its dQ, dK and dV against block_grads_plain from
    zero accumulators on its own out and lse (delta = rowsum(dO * out)),
    within bf16's 1e-2 of the largest value. Returns (ok, description)."""
    from distributed_vgg_f_tpu_torch.ops.flash_attention import \
        block_grads_plain
    name = _SDPA_BWD + ("(is_causal=True)" if kw["causal"] else "")
    try:
        call, out, lse = _sdpa_block_bwd(x, b, h, kw["causal"])
        got = call()
    except (RuntimeError, TypeError, ValueError) as e:
        return False, f"none: {name} refused the block: {e}"[:300]
    delta = (x["do"].float() * out.float()).sum(-1, keepdim=True)
    zeros = [torch.zeros(x[key].shape, device="cuda")
             for key in ("q", "k", "v")]
    want = block_grads_plain(x["q"], x["k"], x["v"], x["do"], lse, delta,
                             *zeros, **kw)
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float().reshape(w.shape)
        e, bound = float((g - w).abs().max()), 1e-2 * float(w.abs().max())
        if not (bool(torch.isfinite(g).all()) and e <= bound):
            return False, (f"none: {name}'s {what} is off block_grads_plain "
                           f"by {e} (allowed {bound})")
    return True, (f"{name}: the block's dQ, dK and dV from zero, given its "
                  "out and lse (delta recomputed); no carried "
                  "accumulators, no kv_len")


#: the block steps' stress: (Tq, Tk, kv_len) around the 64- and 128-row
#: tiles and the rings' stages, Tq != Tk among them, each causal at the
#: diagonal shifts q_off - k_off of _BLOCK_SHIFTS (zero, ragged, negative)
_BLOCK_STRESS = ((2, 2, 2), (63, 65, 50), (65, 63, 63), (129, 100, 100),
                 (197, 197, 180), (2048, 2048, 1500))
_BLOCK_SHIFTS = (0, 37, -37)


def _fold_errors(got, want, tol, what):
    """The fold's (acc, m, l) against block_update_plain's: acc and l
    within tol of their largest value, m within 1e-5 with the same -inf
    rows (where nothing was ever live). Returns (max abs error, max error
    relative to the largest value), m's held absolutely and left out of
    the relative one."""
    err = rel = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 1:
            check(torch.equal(torch.isneginf(g), torch.isneginf(w)),
                  f"m's -inf rows differ at {what}")
            g, w = g.clamp_min(-1e30), w.clamp_min(-1e30)
            bound = 1e-5
        else:
            bound = tol * float(w.abs().max())
        e = float((g - w).abs().max())
        check(bool(torch.isfinite(g).all()) and e <= bound,
              f"flash_block_fwd off its plain version by {e} at {what} "
              f"(allowed {bound})")
        err = max(err, e)
        if i != 1 and float(w.abs().max()) > 0:
            rel = max(rel, e / float(w.abs().max()))
    return err, rel


def _block_stress(seed):
    """The three block kernels at the lengths and shifts of _BLOCK_STRESS
    and _BLOCK_SHIFTS, at the head dims of _BWD_STRESS_DIMS, in bf16 and
    fp32: the fold from a state that has seen nothing and the dQ and
    dK/dV from zero accumulators within 1e-2 / 1e-5 of the largest value
    of block_update_plain / block_grads_plain (exactly equal where the
    block lies wholly in the rows' future); from a random state (with
    -0.0 entries in bf16), the fold's rows and the dq rows that see no key
    and the dk/dv rows that no query sees must keep their bits. Returns
    the records."""
    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        block_grads_plain, block_update_plain)
    from distributed_vgg_f_tpu_torch.ops.flash_cuda import (
        flash_block_dkv_cuda, flash_block_dq_cuda, flash_block_fwd_cuda)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                               device="cuda")
    b, h = 2, 3
    records = []
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        for d in _BWD_STRESS_DIMS:
            for tq, tk, kv_len in _BLOCK_STRESS:
                for shift in _BLOCK_SHIFTS:
                    q_off = 512 + max(shift, 0)
                    kw = {"q_off": q_off, "k_off": q_off - shift,
                          "causal": True, "kv_len": kv_len}
                    site = f"block_stress_{tq}_{tk}_shift{shift}"
                    args = (f(b * h, tq, d).to(dtype),
                            f(b * h, tk, d).to(dtype),
                            f(b * h, tk, d).to(dtype),
                            f(b * h, tq, d).to(dtype),
                            f(b * h, tq, 1) + 3.0, f(b * h, tq, 1))
                    # the fold from a state that has seen nothing
                    fold = [torch.zeros(b * h, tq, d, device="cuda"),
                            torch.full((b * h, tq, 1), -math.inf,
                                       device="cuda"),
                            torch.zeros(b * h, tq, 1, device="cuda")]
                    want_f = block_update_plain(*args[:3], *fold, **kw)
                    flash_block_fwd_cuda(*args[:3], *fold, **kw)
                    lens = (tq, tk, tk)
                    got = [torch.zeros(b * h, n, d, device="cuda")
                           for n in lens]
                    want = block_grads_plain(*args, *got, **kw)
                    flash_block_dq_cuda(*args, got[0], **kw)
                    flash_block_dkv_cuda(*args, *got[1:], **kw)
                    # from a random state
                    state = [f(b * h, tq, d), f(b * h, tq, 1),
                             f(b * h, tq, 1).abs() + 0.5]
                    acc = [f(b * h, n, d) for n in lens]
                    if dtype == torch.bfloat16:   # the fp32 kernels add
                        for x in (state[0], *acc):  # +0.0 to -0.0 there
                            x[:, ::3, ::5] = -0.0
                    kept_f = [x.clone() for x in state]
                    kept = [a.clone() for a in acc]
                    flash_block_fwd_cuda(*args[:3], *kept_f, **kw)
                    flash_block_dq_cuda(*args, kept[0], **kw)
                    flash_block_dkv_cuda(*args, *kept[1:], **kw)
                    torch.cuda.synchronize()
                    rows_q = torch.arange(tq, device="cuda")
                    rows_k = torch.arange(tk, device="cuda")
                    dead_q = rows_q + shift < 0
                    dead_k = (rows_k >= kv_len) | (rows_k - shift >= tq)
                    kept_fold = all(
                        torch.equal(_bits(y[:, dead_q]),
                                    _bits(x[:, dead_q]))
                        for y, x in zip(kept_f, state))
                    kept_grads = all(
                        torch.equal(_bits(y[:, rows]), _bits(a[:, rows]))
                        for y, a, rows in zip(kept, acc, (
                            dead_q, dead_k, dead_k)))
                    check(kept_fold and kept_grads,
                          f"block fold/dQ/dK/dV changed rows they do not "
                          f"reach at {site} D = {d} {dtype}")
                    errs = {"flash_block_fwd": _fold_errors(
                        fold, want_f, tol, f"{site} D = {d} {dtype}")}
                    for name, gs, ws in (("flash_block_dq", got[:1],
                                          want[:1]),
                                         ("flash_block_dkv", got[1:],
                                          want[1:])):
                        err = rel = 0.0
                        for g, w in zip(gs, ws):
                            e = float((g - w).abs().max())
                            scale = float(w.abs().max())
                            check(bool(torch.isfinite(g).all())
                                  and e <= tol * scale,
                                  f"{name} off its plain version by {e} at "
                                  f"{site} D = {d} {dtype} (allowed "
                                  f"{tol * scale})")
                            err = max(err, e)
                            rel = max(rel, e / scale if scale else 0.0)
                        errs[name] = (err, rel)
                    for name, (err, rel) in errs.items():
                        rec = {"name": name, "site": site,
                               "shape": [b, tq, h, d], "bh": b * h,
                               "tk": tk, "q_off": kw["q_off"],
                               "k_off": kw["k_off"], "causal": True,
                               "kv_len": kv_len,
                               "dtype": str(dtype).replace("torch.", ""),
                               "tol_of_max": tol, "max_abs_err": err,
                               "max_rel_err": rel,
                               "untouched_bit_equal": (
                                   kept_fold if name == "flash_block_fwd"
                                   else kept_grads)}
                        records.append(rec)
                        emit("ring_kernel", **rec)
                    del args, fold, want_f, got, want, state, acc, kept_f
                    del kept
    return records


def _block_repeat(seed):
    """The fold's acc, m and l and the backward's dq, dk and dv of two
    launches of the bf16 block kernels from the same inputs and state
    must be the same bits (no atomics): a past and a diagonal block of
    the 4-rank ring's local shape, and a ragged partly masked block at
    D = 256 with Tq != Tk."""
    from distributed_vgg_f_tpu_torch.ops.flash_cuda import (
        flash_block_dkv_cuda, flash_block_dq_cuda, flash_block_fwd_cuda)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                               device="cuda")
    t_loc = _LONG_TS[-1] // 4
    bh = _LONG_B * _VIT_H
    for site, tq, tk, d, q_off, k_off, causal in (
            ("past", t_loc, t_loc, _VIT_D, 2 * t_loc, 0, False),
            ("diagonal", t_loc, t_loc, _VIT_D, 2 * t_loc, 2 * t_loc, True),
            ("ragged_partial_256", 197, 150, 256, 197, 147, True)):
        kw = {"q_off": q_off, "k_off": k_off, "causal": causal,
              "kv_len": tk}
        args = (f(bh, tq, d).bfloat16(), f(bh, tk, d).bfloat16(),
                f(bh, tk, d).bfloat16(), f(bh, tq, d).bfloat16(),
                f(bh, tq, 1) + 3.0, f(bh, tq, 1))
        state = [f(bh, tq, d), f(bh, tq, 1), f(bh, tq, 1).abs() + 0.5]
        acc = [f(bh, n, d) for n in (tq, tk, tk)]
        runs = []
        for _ in range(2):
            y = [a.clone() for a in state + acc]
            flash_block_fwd_cuda(*args[:3], *y[:3], **kw)
            flash_block_dq_cuda(*args, y[3], **kw)
            flash_block_dkv_cuda(*args, *y[4:], **kw)
            runs.append(y)
        torch.cuda.synchronize()
        same = dict(zip(("acc", "m", "l", "dq", "dk", "dv"),
                        (bool(torch.equal(_bits(a), _bits(c)))
                         for a, c in zip(*runs))))
        check(all(same.values()), f"block fold, dQ, dK, dV of two launches "
              f"differ at {site}: bit-equal {same}")
        emit("ring_kernel", name="flash_block_repeat", site=site,
             shape=[_LONG_B, tq, _VIT_H, d], tk=tk, q_off=q_off,
             k_off=k_off, causal=causal, dtype="bfloat16", bit_equal=same)
        del args, state, acc, runs


def phase_ring_kernel(peaks):
    """The three ring block kernels against their plain versions at the
    offsets the ranks of a 4-rank ring see (a past block, the diagonal, a
    block wholly in the future, which must leave every bit of the state
    as it was) at the local shape (4, 2048, 6, 64) of (4, 8192, 6, 64),
    at the ragged local length 197 with a block-local kv_len (padded keys
    keep their accumulators' bits) and a partly masked block, at head
    dims 128 and 256, and at B*H = 65600; timed sites with TFLOP/s and,
    in bf16, PyTorch's flash attention forward (for the fold) and
    backward (for dQ and dK/dV) as the library yardsticks; then the three
    kernels' stress (_block_stress) and their bit-equal repeat
    (_block_repeat); returns the records."""
    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        block_grads_plain, block_update_plain)
    from distributed_vgg_f_tpu_torch.ops.flash_cuda import (
        flash_block_dkv_cuda, flash_block_dq_cuda, flash_block_fwd_cuda)
    gen = torch.Generator(device="cuda").manual_seed(12)
    t_loc = _LONG_TS[-1] // 4
    # (site, (B, T_loc, H, D), q_off, k_off, causal, kv_len, timed)
    cases = [("past", (_LONG_B, t_loc, _VIT_H, _VIT_D), 2 * t_loc, 0, False,
              None, True),
             ("past_causal", (_LONG_B, t_loc, _VIT_H, _VIT_D), 2 * t_loc, 0,
              True, None, False),
             ("diagonal", (_LONG_B, t_loc, _VIT_H, _VIT_D), 2 * t_loc,
              2 * t_loc, True, None, True),
             ("future", (_LONG_B, t_loc, _VIT_H, _VIT_D), t_loc, 2 * t_loc,
              True, None, False),
             ("ragged_diagonal", (2, 197, _VIT_H, _VIT_D), 394, 394, True,
              180, False),
             ("ragged_partial", (2, 197, _VIT_H, _VIT_D), 197, 147, True,
              180, False),
             ("ragged_past", (2, 197, _VIT_H, _VIT_D), 394, 0, False, 180,
              False),
             # head dims past the 64 of ViT, and B*H = 65600
             ("wide_head_diagonal", (2, 197, 2, 128), 197, 197, True, 150,
              False),
             ("wide_head_past", (_LONG_B, t_loc, _VIT_H, 128), 2 * t_loc, 0,
              False, None, True),
             ("widest_head_past", (1, 130, 2, 256), 130, 0, False, None,
              False),
             ("bh_65600", (16400, 16, 4, _VIT_D), 8, 0, True, 12, False)]

    def inputs(bh, t, d, dtype, kv_len):
        f = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                   device="cuda")
        x = {"q": f(bh, t, d).to(dtype), "k": f(bh, t, d).to(dtype),
             "v": f(bh, t, d).to(dtype), "do": f(bh, t, d).to(dtype),
             "acc": f(bh, t, d), "m": f(bh, t, 1),
             "l": f(bh, t, 1).abs() + 0.5, "lse": f(bh, t, 1) + 3.0,
             "delta": f(bh, t, 1), "dq": f(bh, t, d), "dk": f(bh, t, d),
             "dv": f(bh, t, d)}
        # rows that have seen nothing yet; padded keys' accumulators at 0
        x["acc"][:, :5], x["m"][:, :5], x["l"][:, :5] = 0.0, -math.inf, 0.0
        x["dk"][:, kv_len:], x["dv"][:, kv_len:] = 0.0, 0.0
        return x

    records = []
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        for site, (b, t, h, d), q_off, k_off, causal, kv_len, timed \
                in cases:
            bh, kv_len = b * h, t if kv_len is None else kv_len
            kw = {"q_off": q_off, "k_off": k_off, "causal": causal,
                  "kv_len": kv_len}
            x = inputs(bh, t, d, dtype, kv_len)
            args_f = [x[k] for k in ("q", "k", "v", "acc", "m", "l")]
            args_g = [x[k] for k in ("q", "k", "v", "do", "lse", "delta",
                                     "dq", "dk", "dv")]
            want_f = block_update_plain(*args_f, **kw)
            want_g = block_grads_plain(*args_g, **kw)
            got_f = [y.clone() for y in args_f[3:]]
            got_g = [y.clone() for y in args_g[6:]]
            flash_block_fwd_cuda(*args_f[:3], *got_f, **kw)
            flash_block_dq_cuda(*args_g[:6], got_g[0], **kw)
            flash_block_dkv_cuda(*args_g[:6], *got_g[1:], **kw)
            torch.cuda.synchronize()
            errs = {"flash_block_fwd": _fold_errors(got_f, want_f, tol,
                                                    f"{site} {dtype}")}
            for name, got, want in (("flash_block_dq", got_g[:1],
                                     want_g[:1]),
                                    ("flash_block_dkv", got_g[1:],
                                     want_g[1:])):
                err = rel = 0.0
                for g, w in zip(got, want):
                    bound = tol * float(w.abs().max())
                    e = float((g - w).abs().max())
                    check(bool(torch.isfinite(g).all()) and e <= bound,
                          f"{name} off its plain version by {e} at {site} "
                          f"{dtype} (allowed {bound})")
                    err = max(err, e)
                    rel = max(rel, e / float(w.abs().max()))
                errs[name] = (err, rel)
            check(all(torch.equal(_bits(g[:, kv_len:]), _bits(y[:, kv_len:]))
                      for g, y in zip(got_g[1:], args_g[7:])),
                  f"padded keys' accumulators changed at {site}")
            if site == "future":
                check(all(torch.equal(_bits(g), _bits(y)) for g, y in
                          zip(got_f + got_g, args_f[3:] + args_g[6:])),
                      "a block wholly in the future changed the state")
            del got_f, got_g, want_f, want_g
            recs = {name: {"name": name, "site": site,
                           "shape": [b, t, h, d], "bh": bh,
                           "q_off": q_off, "k_off": k_off, "causal": causal,
                           "kv_len": kv_len,
                           "dtype": str(dtype).replace("torch.", ""),
                           "tol_of_max": tol, "max_abs_err": errs[name][0],
                           "max_rel_err": errs[name][1]}
                    for name in _BLOCK_KERNELS}
            if timed:
                sets = [inputs(bh, t, d, dtype, kv_len) for _ in range(8)]
                fns = {
                    "flash_block_fwd": (
                        lambda y: flash_block_fwd_cuda(
                            y["q"], y["k"], y["v"], y["acc"], y["m"],
                            y["l"], **kw),
                        lambda y: block_update_plain(
                            y["q"], y["k"], y["v"], y["acc"], y["m"],
                            y["l"], **kw)),
                    "flash_block_dq": (
                        lambda y: flash_block_dq_cuda(
                            *(y[k] for k in ("q", "k", "v", "do", "lse",
                                             "delta", "dq")), **kw),
                        lambda y: block_grads_plain(
                            *(y[k] for k in ("q", "k", "v", "do", "lse",
                                             "delta", "dq", "dk", "dv")),
                            **kw)),
                    "flash_block_dkv": (
                        lambda y: flash_block_dkv_cuda(
                            *(y[k] for k in ("q", "k", "v", "do", "lse",
                                             "delta", "dk", "dv")), **kw),
                        None)}
                lib = {name: (None, "none: PyTorch's flash attention "
                                    "takes fp16 and bf16 only")
                       for name in ("fwd", "bwd")}
                if dtype == torch.bfloat16:
                    ok, what = _library_block_fwd(x, b, h, kw)
                    lib["fwd"] = (device_ms(
                        lambda y: _sdpa_block_fwd(y, b, h, causal), sets)
                        if ok else None, what)
                    ok, what = _library_block_bwd(x, b, h, kw)
                    if ok:
                        calls = [_sdpa_block_bwd(y, b, h, causal)[0]
                                 for y in sets]
                        lib["bwd"] = (device_ms(lambda c: c(), calls), what)
                        del calls
                    else:
                        lib["bwd"] = (None, what)
                plain_grads = None
                for name, (kern, plain) in fns.items():
                    rec = recs[name]
                    rec["ms"] = device_ms(kern, sets)
                    if plain is not None:
                        plain_grads = device_ms(plain, sets[:2], windows=3)
                        rec["plain_ms"] = plain_grads
                    else:
                        rec["plain_ms"] = plain_grads
                    rec["plain"] = ("block_update_plain"
                                    if name == "flash_block_fwd" else
                                    "block_grads_plain (dq, dk and dv "
                                    "together)")
                    rec["library_ms"], rec["library"] = lib[
                        "fwd" if name == "flash_block_fwd" else "bwd"]
                    rec["bound_ms"], rec["bound_by"] = block_bound_ms(
                        name, bh, t, t, d, dtype.itemsize, q_off, k_off,
                        causal, kv_len, peaks)
                    # the kernel's issued rate over the live pairs
                    rec["tflops"] = block_flops(
                        name, bh, t, d, q_off, k_off, causal, kv_len) / (
                            rec["ms"] * 1e-3) / 1e12
                del sets
            for rec in recs.values():
                records.append(rec)
                emit("ring_kernel", **rec)
            del x, args_f, args_g
            torch.cuda.empty_cache()
    records += _block_stress(seed=15)
    _block_repeat(seed=16)
    return records


# ------------------------------------------------- sequence-parallel paths
def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _all_counts():
    return {**_flash_counts(), **_block_counts()}


def _zero_all_counts():
    _zero_flash_counts()
    _zero_block_counts()


def _held(got, want, tol, what):
    """|got - want| <= tol + tol * |want| elementwise (the JAX ring tests'
    assert_allclose with rtol = atol = tol); returns the max error."""
    got, want = got.float(), want.float()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: shape {tuple(got.shape)} or non-finite values")
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= tol + tol * want.abs()).all())
    check(ok, f"{what} off flash_self_attention by {err} (rtol = atol = "
          f"{tol})")
    return err


def phase_ring_flash():
    """(a) The port's own entry points over a one-rank NCCL group:
    ring_flash_attention, ring_self_attention and ulysses_self_attention
    (flash) at (4, 8192, 6, 64) bf16, causal and not, forward and
    backward, each held against flash_self_attention, with the launches of
    each path alone. (b) The 4-rank ring's kernel work chained on the one
    card in ring order: each rank's folds with its offsets, then the
    backward steps with the dK/dV accumulators travelling with their
    block, held against flash_self_attention at T = 8192, with each
    rank's kernel ms. Returns the launches by path."""
    import torch.distributed as dist

    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        flash_block_grads, flash_block_update, flash_self_attention)
    from distributed_vgg_f_tpu_torch.parallel.distributed import \
        initialize_distributed
    from distributed_vgg_f_tpu_torch.parallel.ring_attention import \
        ring_self_attention
    from distributed_vgg_f_tpu_torch.parallel.ring_flash import \
        ring_flash_attention
    from distributed_vgg_f_tpu_torch.parallel.ulysses import \
        ulysses_self_attention
    b, t, h, d = _LONG_B, _LONG_TS[-1], _VIT_H, _VIT_D
    gen = torch.Generator(device="cuda").manual_seed(13)

    def draw(dtype):
        return [torch.randn(b, t, h, d, generator=gen, device="cuda").to(
            dtype) for _ in range(4)]   # q, k, v and the output cotangent

    def fwd_bwd(fn, q, k, v, w, causal):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*xs, causal=causal)
        out.backward(w)
        torch.cuda.synchronize()
        return [out.detach(), *(x.grad for x in xs)]

    # (a) a one-rank NCCL group: NCCL puts no two ranks on one card
    t0 = time.perf_counter()
    up = initialize_distributed(f"localhost:{_free_port()}", 1, 0,
                                device="cuda")
    check(up and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "initialize_distributed did not start a one-rank NCCL group")
    init_s = time.perf_counter() - t0
    entries = {"ring_flash": ring_flash_attention,
               "ring_einsum": ring_self_attention,
               "ulysses_flash": lambda *a, **kw: ulysses_self_attention(
                   *a, kernel="flash", **kw)}
    # the launches each path must make at n = 1
    expect = {"ring_flash": {"block_fwd": 1, "block_dq": 1, "block_dkv": 1},
              "ring_einsum": {},
              "ulysses_flash": {"fwd": 1, "dq": 1, "dkv": 1}}
    tol = 3e-2
    by_path = {}
    q, k, v, w = draw(torch.bfloat16)
    try:
        for causal in (False, True):
            want = fwd_bwd(flash_self_attention, q, k, v, w, causal)
            for path, fn in entries.items():
                key = f"{path}_causal" if causal else path
                torch.cuda.synchronize()
                _zero_all_counts()
                t1 = time.perf_counter()
                got = fwd_bwd(fn, q, k, v, w, causal)
                wall_ms = (time.perf_counter() - t1) * 1e3
                counts = _all_counts()
                by_path[key] = counts
                errs = [_held(g, r, tol, f"{key} {name}") for g, r, name
                        in zip(got, want, ("out", "dq", "dk", "dv"))]
                emit("ring_flash", part="a", path=key, world=1,
                     backend="nccl", shape=[b, t, h, d], dtype="bfloat16",
                     causal=causal, launches=counts,
                     max_abs_err=dict(zip(("out", "dq", "dk", "dv"), errs)),
                     rtol_atol=tol, fwd_bwd_wall_ms=wall_ms,
                     init_s=init_s)
                check(counts == {**{c: 0 for c in counts}, **expect[path]},
                      f"{key} launches {counts}, expected {expect[path]}")
                del got
                torch.cuda.empty_cache()
            del want
    finally:
        dist.destroy_process_group()

    # (b) the 4-rank ring's kernel work, chained on the one card
    n, t_loc = 4, t // 4
    for dtype, (fwd_tol, grad_tol) in ((torch.bfloat16, (3e-2, 3e-2)),
                                       (torch.float32, (2e-5, 5e-5))):
        q, k, v, w = draw(dtype)
        rows = lambda x, r: x[:, r * t_loc:(r + 1) * t_loc].permute(  # noqa
            0, 2, 1, 3).reshape(b * h, t_loc, d).contiguous()
        for causal in (False, True):
            want = fwd_bwd(flash_self_attention, q, k, v, w, causal)
            qs, ks, vs, ws = ([rows(x, r) for r in range(n)]
                              for x in (q, k, v, w))
            live = lambda r, s: not (causal and ((r - s) % n) * t_loc  # noqa
                                     > r * t_loc + t_loc - 1)
            torch.cuda.synchronize()
            _zero_block_counts()
            fwd_ms, outs, lses = [], [], []
            for r in range(n):
                acc = torch.zeros(b * h, t_loc, d, device="cuda")
                m = torch.full((b * h, t_loc, 1), -math.inf, device="cuda")
                l = torch.zeros(b * h, t_loc, 1, device="cuda")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for s in range(n):
                    src = (r - s) % n
                    if live(r, s):
                        flash_block_update(qs[r], ks[src], vs[src], acc, m, l,
                                           q_off=r * t_loc,
                                           k_off=src * t_loc, causal=causal)
                end.record()
                end.synchronize()
                fwd_ms.append(start.elapsed_time(end))
                outs.append((acc / l).to(dtype))
                lses.append(m + torch.log(l))
            deltas = [(ws[r].float() * outs[r].float()).sum(-1, keepdim=True)
                      for r in range(n)]
            dq = [torch.zeros(b * h, t_loc, d, device="cuda")
                  for _ in range(n)]
            dk = [torch.zeros_like(x) for x in dq]   # by block owner
            dv = [torch.zeros_like(x) for x in dq]
            bwd_ms = [0.0] * n
            for s in range(n):
                for r in range(n):
                    src = (r - s) % n
                    if not live(r, s):
                        continue
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    flash_block_grads(qs[r], ks[src], vs[src], ws[r],
                                      lses[r], deltas[r], dq[r], dk[src],
                                      dv[src], q_off=r * t_loc,
                                      k_off=src * t_loc, causal=causal)
                    end.record()
                    end.synchronize()
                    bwd_ms[r] += start.elapsed_time(end)
            counts = _block_counts()
            join = lambda xs: torch.cat(  # noqa: E731
                [x.reshape(b, h, t_loc, d).permute(0, 2, 1, 3) for x in xs],
                dim=1)
            got = [join(outs), join(dq).to(dtype), join(dk).to(dtype),
                   join(dv).to(dtype)]
            errs = [_held(g, r_, fwd_tol if i == 0 else grad_tol,
                          f"4-rank chain {dtype} causal={causal} {name}")
                    for i, (g, r_, name) in enumerate(
                        zip(got, want, ("out", "dq", "dk", "dv")))]
            steps = sum(live(r, s) for r in range(n) for s in range(n))
            key = "ring4_chained_causal" if causal else "ring4_chained"
            if dtype == torch.bfloat16:
                by_path[key] = counts
            emit("ring_flash", part="b", path=key, world=n,
                 shape=[b, t, h, d], local_shape=[b, t_loc, h, d],
                 dtype=str(dtype).replace("torch.", ""), causal=causal,
                 launches=counts, live_steps=steps,
                 rank_fwd_ms=fwd_ms, rank_bwd_ms=bwd_ms,
                 max_abs_err=dict(zip(("out", "dq", "dk", "dv"), errs)),
                 rtol_atol=[fwd_tol, grad_tol])
            check(counts == {"block_fwd": steps, "block_dq": steps,
                             "block_dkv": steps},
                  f"4-rank chain launches {counts}, expected {steps} each")
            del want, got, qs, ks, vs, ws, outs, lses, deltas, dq, dk, dv
            torch.cuda.empty_cache()
        del q, k, v, w
    return by_path


def phase_isolation():
    bad = sorted(m for m in sys.modules
                 if any(m == r or m.startswith(r + ".")
                        for r in ("jax", "jaxlib", "flax",
                                  "distributed_vgg_f_tpu")))
    check(bad == [], f"JAX-side modules imported: {bad}")
    emit("isolation", forbidden_modules=bad)


def main() -> int:
    t_script = time.perf_counter()
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
                "fp32_flops": peaks[1],
                "bf16_tensor_flops": _BF16_TENSOR_FLOPS},
         tf32={"matmul": False, "cudnn": False})

    t0 = time.perf_counter()
    logs = {}
    libs = build.build_all(logs=logs)
    ptxas = _ptxas_report(logs)
    emit("build", seconds=time.perf_counter() - t0,
         wall_s=time.perf_counter() - t_script, kernels=sorted(libs),
         flags=build.NVCC_FLAGS, nvcc_timeout_s=build.NVCC_TIMEOUT_S,
         ptxas=ptxas)
    # the ring block kernels compiled here: 168 registers at each width
    # and no note that ptxas serialised their wgmma
    for source in sorted(set(logs) & set(_BLOCK_KERNELS)):
        for dp in (64, 128, 256):
            kernel = f"{source.replace('flash_', '')}_wgmma_kernel<{dp}>"
            rep = ptxas.get(kernel, {})
            check(rep.get("registers") == 168 and rep["ptxas_notes"] == [],
                  f"ptxas reports {kernel} as {rep}")

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

    flash_records = phase_flash_kernel(peaks)
    t0 = time.perf_counter()
    vit_tree = init_params(_vit_cfg().model, 0, image_size=224)
    emit("init", model="vit_s16", seconds=time.perf_counter() - t0, seed=0,
         params=_tree_size(vit_tree))
    phase_vit_model(vit_tree)
    vit_serve_launches = phase_vit_serve(vit_tree)
    phase_vit_train_parity(vit_tree)
    del vit_tree
    vit_train_launches = phase_vit_train()
    causal_records = phase_flash_causal(peaks)
    ring_records = phase_ring_kernel(peaks)
    sp = phase_ring_flash()
    phase_isolation()

    def lrn_sites(recs, key, value):
        # the main path's two sites at one batch, in bf16
        main = [r for r in recs if r[key] == value
                and r["dtype"] == "bfloat16"]
        check(len(main) == 2 and all(r["variant"] == "vector"
                                     for r in main),
              f"LRN sites at {key} {value}: {len(main)} bf16 records")
        return main

    def lrn_times(main, relu_key):
        # both sites summed: the fused kernel (the main path's), the
        # unfused kernel with the ReLU pass it no longer needs, and
        # the yardsticks
        return {k: sum(r[k] for r in main)
                for k in ("ms", "unfused_ms", relu_key, "plain_ms",
                          "library_ms", "bound_ms")}

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
            "head_dims": None,
            "work": work + ": " + ", ".join(str(tuple(r["shape"]))
                                           for r in main)}

    def head_dims(recs, name):
        # the head dims a kernel was held against its plain version at
        return sorted({r["shape"][3] for r in recs if r["name"] == name})

    def flash_summary(name, line, by_path):
        # one layer's launch in bf16 at the training batch
        main = [r for r in flash_records if r["name"] == name
                and r["site"] == "vit_train" and r["dtype"] == "bfloat16"]
        check(len(main) == 1, f"{name}: {len(main)} timed records")
        rec = main[0]
        return {
            "name": name, "route": "cuda",
            "source": f"distributed_vgg_f_tpu_torch/csrc/{name}.cu",
            "replaces": f"distributed_vgg_f_tpu/ops/flash_attention.py{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in flash_records
                               if r["name"] == name),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "tflops": rec["tflops"],
            "head_dims": head_dims(flash_records + causal_records, name),
            "work": "one attention layer of ViT-S/16 in bf16 at batch 1024: "
                    f"(B, T, H, D) = {tuple(rec['shape'])}"}

    def jagged_summary(kernel, line, key):
        # the causal loop bound of the flash kernel, in bf16 at T = 8192
        main = [r for r in causal_records if r["name"] == kernel
                and r["site"] == f"causal_{_LONG_TS[-1]}"
                and r["dtype"] == "bfloat16"]
        check(len(main) == 1, f"{kernel} causal: {len(main)} records")
        rec = main[0]
        by_path = {"ulysses_flash_causal": sp["ulysses_flash_causal"][key]}
        return {
            "name": f"{kernel}_jagged",
            "route": "cuda",
            "source": f"distributed_vgg_f_tpu_torch/csrc/{kernel}.cu",
            "replaces": f"distributed_vgg_f_tpu/ops/flash_attention.py{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in causal_records
                               if r["name"] == kernel),
            "max_rel_err": max(r["max_rel_err"] for r in causal_records
                               if r["name"] == kernel),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "tflops": rec["tflops"],
            "head_dims": head_dims(flash_records + causal_records, kernel),
            "work": "causal attention over ViT-S/16's heads in bf16 at "
                    f"(B, T, H, D) = {tuple(rec['shape'])}: the causal loop "
                    "bound of the rectangular kernel"}

    def block_summary(name, line, key):
        # a fully live (past) block of the 4-rank ring's local shape, bf16
        main = [r for r in ring_records if r["name"] == name
                and r["site"] == "past" and r["dtype"] == "bfloat16"]
        check(len(main) == 1, f"{name}: {len(main)} timed records")
        rec = main[0]
        by_path = {p: sp[p][key] for p in ("ring_flash", "ring_flash_causal")}
        return {
            "name": name, "route": "cuda",
            "source": f"distributed_vgg_f_tpu_torch/csrc/{name}.cu",
            "replaces": f"distributed_vgg_f_tpu/ops/flash_attention.py{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_chained_4rank": {
                p: sp[p][key] for p in ("ring4_chained",
                                        "ring4_chained_causal")},
            "max_abs_err": max(r["max_abs_err"] for r in ring_records
                               if r["name"] == name),
            "max_rel_err": max(r["max_rel_err"] for r in ring_records
                               if r["name"] == name),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "library": rec["library"],
            "tflops": rec["tflops"],
            "head_dims": head_dims(ring_records, name),
            "work": "one ring step over a fully live block in bf16 at the "
                    "4-rank ring's local (B, T_loc, H, D) = "
                    f"{tuple(rec['shape'])}"}

    emit("wall", seconds=time.perf_counter() - t_script)
    lrn_fwd_row = summary(
        "lrn_fwd", "distributed_vgg_f_tpu_torch/csrc/lrn_fwd.cu",
        "distributed_vgg_f_tpu/ops/lrn_pallas.py:67", records, "bucket", 32,
        serve_launches + train_launches["fwd"],
        {"serve": serve_launches, "train": train_launches["fwd"]},
        "both LRN sites of one bf16 forward at bucket 32, ReLU fused")
    at32 = lrn_times(lrn_sites(records, "bucket", 32), "relu_ms")
    lrn_fwd_row.update(
        variant="vector", fused_relu=True, unfused_ms=at32["unfused_ms"],
        relu_ms=at32["relu_ms"],
        batch1024=lrn_times(lrn_sites(records, "bucket", 1024), "relu_ms"))
    lrn_bwd_row = summary(
        "lrn_bwd", "distributed_vgg_f_tpu_torch/csrc/lrn_bwd.cu",
        "distributed_vgg_f_tpu/ops/lrn_pallas.py:74", bwd_records, "batch",
        1024, train_launches["bwd"],
        {"serve": 0, "train": train_launches["bwd"]},
        "both LRN sites of one bf16 training step at batch 1024, the ReLU's "
        "backward fused")
    at1024 = lrn_times(lrn_sites(bwd_records, "batch", 1024), "relu_bwd_ms")
    lrn_bwd_row.update(
        variant="vector", fused_relu=True, unfused_ms=at1024["unfused_ms"],
        relu_bwd_ms=at1024["relu_bwd_ms"])
    print(json.dumps({"kernels": [
        lrn_fwd_row,
        lrn_bwd_row,
        flash_summary("flash_fwd", ":211",
                      {"vit_serve": vit_serve_launches,
                       "vit_train": vit_train_launches["fwd"],
                       "ulysses_flash": sp["ulysses_flash"]["fwd"]}),
        flash_summary("flash_dq", ":292",
                      {"vit_serve": 0, "vit_train": vit_train_launches["dq"],
                       "ulysses_flash": sp["ulysses_flash"]["dq"]}),
        flash_summary("flash_dkv", ":365",
                      {"vit_serve": 0,
                       "vit_train": vit_train_launches["dkv"],
                       "ulysses_flash": sp["ulysses_flash"]["dkv"]}),
        jagged_summary("flash_fwd", ":240", "fwd"),
        jagged_summary("flash_dq", ":319", "dq"),
        jagged_summary("flash_dkv", ":396", "dkv"),
        block_summary("flash_block_fwd", ":639", "block_fwd"),
        block_summary("flash_block_dq", ":724", "block_dq"),
        block_summary("flash_block_dkv", ":761", "block_dkv"),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

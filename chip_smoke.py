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
            1 and 32; the student tier's 32 and 128 channels too), the
            training batch 1024 (bf16), the distillation tool's shapes
            and C = 8 … 256 at radius 0–4, the general variant at odd
            shapes; each record
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
            F.local_response_norm), checked at the distillation tool's
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
  serve_tiers the tier ladder on the flagship (bf16 compute): the base
            route ("fp32": the model at its compute dtype), bf16 (params
            cast once), int8 (the default calibration of 4 x 8) and a
            seeded vggf_student behind one server; every bucket warmed,
            4 POSTs a tier each bit-equal to the tier's engine.run (cuDNN
            deterministic); relative logit gaps: the route and the
            student against the CPU forward of their weights, bf16 and
            int8 against the route, int8 compacted against the dense
            heads with and without its elision (with both paths' int8
            codes); forward ms at buckets 1 and 32, resident bytes
            beside hbm_estimate_bytes, LRN launches by tier (all
            vector); then the admission controller under 3 s of 96
            closed-loop clients (windows of 0.1 s, queue of 32): its
            windows, verdicts and moves, each replayed through a fresh
            controller, and the window back at its baseline once quiet;
            and, recorded only, 160 clients for 6 windows at the
            preset's queue of 128 and 2 s windows
  serve_cli `python -m distributed_vgg_f_tpu_torch.cli --mode serve` (tiers
            on) as a subprocess over the checkpoint of a 2-step fit (batch
            64), its answers against --mode predict's within the bf16
            gate, SIGINT ending it with 0, its own LRN counts
  distill   the distillation tool (vggf_student, 32 px, fp32): 3 steps
            on the card against the CPU from one start (losses within
            1e-4 relative), then its `main` for 20 steps and an eval:
            the npz written, 2 forward and 2 backward LRN launches a
            step (all vector)
  train_parity one train step of full-width VGG-F (fp32, TF32 off,
            dropout and augment off, batch 2) on the card and on the CPU
            from the same weights and batch: every parameter's gradient,
            conv1's included, and the updated parameters agree
  stem      VGG-F's packed stem (the 3x3x48 stride-1 conv over the 4x4-
            packed batch) against the plain 11x11/4 conv at batch 1024,
            224 px, with the seeded conv1 weights, in bf16 and fp32 (TF32
            off): outputs and conv1's weight gradient within 1e-2 / 1e-4
            relative L2, the packed batch reaching cuDNN as a view,
            forward and weight-gradient device ms of each path, the
            pack's ms, the kernels each runs (the packed path runs no
            NHWC padding kernel)
  train     the training path: Trainer.fit on vggf_imagenet_dp at full
            width and batch 1024 (bf16, dropout, flip, mixup, the
            non-finite skip) for 20 steps on one fixed seeded u8 batch;
            launch counts zeroed before fit and read after (2 forward and
            2 backward LRN launches a step, all of the vector variant),
            every loss finite and the
            loss falling; then step ms, images/s, peak device memory and
            a torch.profiler breakdown of 3 more steps (cuDNN's padding
            and convolution kernels listed apart)
  train_augment every op of the augment stage on the flagship (batch
            1024, 224 px, bf16 compute): the preset's flip and mixup 0.2
            with crop jitter 8, cutmix 1.0 and two rounds of
            RandAugment-lite at magnitude 0.5. (a) one step's draws
            applied op by op on the card and on the CPU: flip, jitter and
            cutmix bit-equal, mixup within 1e-6, RandAugment within 2e-6
            but for posterize flips (counted, under 30% of the
            posterized images' elements); the stage as the step calls
            it equal to its ops; its device µs a batch (profiler). (b)
            Trainer.fit for 20 steps on phase train's seeded u8 batch:
            finite losses, step ms beside phase train's, 40 + 40 LRN
            launches (all vector), the record's augment block
  train_zero2 the flagship's gradient exchange on the card, through a
            one-rank NCCL group that the script keeps to its end: (a)
            build_train_step with the preset's ZeRO-2 over 4 MB buckets
            (zero1, shard_gradients, comm_bucket_mb=4.0; the trainer
            would downgrade them at one rank, so the phase calls the step
            itself), full width in fp32 with TF32 off, dropout and
            augment off, batch 2, 3 steps, held against the replicated
            step from the same weights (losses, parameters and the
            momentum: the same bits expected, within 1e-6 relative L2
            held), and the (T,) flat momentum against `to_global` of the
            replicated step's per-leaf momentum; (b) the same path in
            bf16 at batch 1024 with dropout, flip and mixup for 20 steps
            on phase train's seeded u8 batch: step ms and images/s beside
            phase train's, peak memory, 40 + 40 LRN launches (all of the
            vector variant), the bucket count and wire bytes of
            `comm_meta`, and a torch.profiler breakdown of 3 more steps
            with the device µs of the NCCL kernels and of the copy
            kernels (phase train's copy µs beside them), and the memory
            the state holds between steps
  train_zero3 the flagship's ZeRO-3 (mesh.shard_params) in the same
            one-rank NCCL group: (a) build_train_step with ZeRO-3 over
            the preset's 4 MB buckets against ZeRO-2, both with the EMA
            (0.99), full width in fp32, TF32 off, cuDNN's deterministic
            algorithms, batch 2, 3 steps: losses, the gathered params,
            the (T,) momentum and the gathered EMA bit-equal; between
            steps every nn.Parameter holds no storage and
            torch.cuda.memory_allocated() is below ZeRO-2's by the
            parameters' fp32 bytes (a state that keeps only the shards);
            comm_meta's gathers equal its buckets; 6 + 6 LRN launches;
            (b) the same path in bf16 at batch 1024 with dropout, flip and
            mixup for 20 steps: step ms beside train_zero2 (b)'s, peak
            memory and the memory held between steps beside ZeRO-2's,
            40 + 40 LRN launches, and a profile of 3 more steps
  train_feed the flagship's host-to-card feed: the 16 fixture JPEGs
            (tests/data/jpeg_fixture, 500x375) packed by
            tools/tfrecord_write.py into 4 TFRecord shards of 1024
            records in a temp dir, then Trainer.fit(state, num_steps=20)
            with data.data_dir there and no dataset passed: the native
            index, the native decode on the u8 wire into the pinned ring,
            the H2D copy on the prefetcher's side stream, the device
            finish, augment and step; step ms and images/s beside phase
            train's, host_wait_fraction, prefetch/wait_ns a step, 40 + 40
            LRN launches (all vector), finite losses, zero decode errors;
            the decoder alone (8 batches into a pinned buffer, images/s,
            os.cpu_count() and its thread count) and the libjpeg it
            linked; 4 batches pulled through the prefetcher (its side
            stream stalled 2 s first, the consumer's slowed after each)
            byte-equal to a CPU-only decode of the same cursors; a
            torch.profiler breakdown of 3 steps through a live feed with
            the pinned H2D copy µs a step and the share of it that
            overlaps kernels; and the same feed with data.name="synthetic" (phase train's
            seeded batch through the prefetcher's pinned ring and side
            stream, where the host keeps up): step ms and the copy's
            overlap share
  train_ckpt checkpoint and resume of the flagship on train_feed's
            shards, cuDNN deterministic for this phase only:
            Trainer.fit(num_steps=10) with a checkpoint directory in a
            temp dir and checkpoint_every_steps=5 (saves at 1, the first
            save, at 5 and the forced 10 with its wait()): step ms with
            and without a save, each save's dispatch ms on the training
            thread, the writer's and the manifests' seconds, the bytes a
            step holds; the D2H copy of a save timed with CUDA events
            (allocating the pinned buffers and reusing them) and the
            seconds until its manifest is on disk and intact, no wait()
            called; a fresh
            Trainer's restore_or_init() bit-equal to the live state at
            the save and its iterator blob equal to the saved one, its
            seconds; one byte of step 10's largest file flipped and a
            fresh Trainer falling back to step 5 (the fallback logged);
            the restored Trainer's fit to 15 through the blob (no batch
            replayed), bit-equal to an uninterrupted run of 15 without
            checkpoints; 2 + 2 LRN launches a step over the 15 steps,
            all of the vector variant; then 20 steps on phase train's
            fixed batch with a save every 10 (at 1, 10, 20), their step
            ms beside phase train's; the card's name and power limit
  zoo_model the zoo's VGG-16 and ResNet-50 (vgg16_imagenet,
            resnet50_imagenet) at full width (224 px, 1000 classes, bf16)
            through build_engine from an npz of seeded weights (ResNet's
            with non-trivial running statistics and bn3 scales at
            0.05-0.15) on the flagship's ladder: every bucket warmed, the
            served statistics the npz's, probabilities finite and summing
            to 1, fp32 and bf16 logits held against the CPU forward of the
            same weights at phase model's tolerances, forward ms per
            bucket, parameter and statistic counts; no hand kernel
  zoo_train_parity one fp32 train step of each (TF32 off, dropout and
            augment off, batch 2) on the card in fp32 and fp64 and on the
            CPU in fp32 and fp64 from the seeded init: the card's fp64
            step the CPU's within 1e-6 relative L2 on every gradient,
            update and running statistic, its fp32 step within 1e-2 of the
            fp64 step (VGG-16's fp32 gradients at batch 2 are no better
            defined: the phase's docstring)
  zoo_train Trainer.fit on each preset at full width (bf16, the preset's
            dropout, flip, mixup, the non-finite skip and LR schedule) for
            20 steps on one seeded u8 batch of 256 (the presets' 1024 over
            four cards): losses finite, every statistic moved, no hand
            kernel; step ms, images/s, peak memory, the LR and a
            torch.profiler breakdown of 3 more steps
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
  ring_flash (a) initialize_distributed finds phase train_zero2's
            one-rank NCCL group up and keeps it, then
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
  train_e2e the flagship end to end through cli.main(argv) in this
            process, on train_feed's shards plus 1200 validation records
            (1024 + 176), base_lr 0.001: 30 steps with an eval every 10,
            a record every 5 and a checkpoint every 10, SIGTERM from a
            thread once step 12 is logged and the next step dispatched (a
            preempt record at the next step, its forced save), a second
            main() resuming through the iterator blob to 30, --mode eval
            (equal to the eval at 30),
            --mode eval from the best slot (equal to its recorded score),
            --mode predict on the 16 JPEGs (top-1 equal to the eval
            forward's, or tied with it in bf16; full probability rows sum
            to 1), metrics.jsonl
            valid; train step ms beside train_feed's, eval pass seconds
            and images/s, the float32 eval batch's H2D ms, steps from the
            signal to the stop, the forced save's dispatch ms, seconds to
            the resumed first step, predict images/s; LRN launches 2 + 2
            a step, 2 an eval or predict batch, all vector
  train_autotune the flagship's ingest autotuner on train_feed's shards,
            a record every 5 steps, base_lr 0.001, after a 5-step warm-up
            fit: (a) 60 steps with the preset's
            autotuner on, each window's verdict, infeed fraction,
            actuations, `blocked`, knob values and `settled`; every
            window after the first infeed_bound at >= 0.25, the first
            move not before window k_windows, every record equal to what
            a fresh controller's rules make of the recorded verdicts, a
            thread knob at its rail (the host's vCPUs) never moved; (b)
            the same under DVGGF_AUTOTUNE=0: no host stage, no autotune
            record or block, no autotune/* counter moved; (c) the seeded
            feed (data.name="synthetic") with the autotuner on for 30
            steps: every window compute_bound, no move. Step ms medians
            of (a) and (b), the pinned host bytes, peak device memory;
            2 + 2 LRN launches a step, all vector
  train_snapshot the flagship's decoded-crop snapshot cache on
            train_feed's shards, base_lr 0.001, a record every 4 steps,
            the store in a fresh temp dir: (a) one fit of 4 cold steps
            (capturing the 4096 items) then 20 warm: cold and warm step
            medians, each window's verdict and host_wait_fraction, the
            warm assembly ms a batch and one warm batch's reads and crc
            checks alone at 1, 2, 4 and 8 threads, the idle share of 3
            profiled warm steps, prefetch/snapshot_{hits,misses,bytes},
            the store's bytes (616,562,688), peak device memory; (b) a
            fresh Trainer on the complete store: warm from batch 0, no
            miss, no image decoded; (c) checks: the labels at every
            position those of the uncached native stream, the cold
            batches its images, the warm images the epoch-0 crops of the
            same items, one flipped payload byte one miss repaired to its
            cold crop; (d) decode-only images/s with DCT-scaled decode
            and the SIMD resample each on and off, and of the fixture
            re-encoded with restart markers at fan-out 1 and 4 and
            sequential, each run's decode_stats, libjpeg/resample split
            and dispatched kinds, every run's batch 1 equal to its
            reference; 2 + 2 LRN launches a step, all vector
  isolation no jax, flax or JAX-package module was imported (the CLI,
            preempt, logging, predict, serving tiers and controller,
            teacher and distillation modules imported first)
  wall      the script's wall seconds
then the kernels summary line (each flash row with the head dims its
kernel was checked at), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero without the last line; without a CUDA device it exits 2
before doing anything.
"""

import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
#: main path's rule gives (C = 8 … 256: 32 is the student's conv1) and
#: every radius it is built for,
#: the general variant at odd shapes (C = 5 and 100: no whole 16-byte
#: vectors; 24: 3 lanes; radius 5: wider than the vector variant's)
_LRN_VEC_CASES = [((2, 5, 7, c), r) for c in (8, 16, 32, 64, 128, 256)
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
            ((1024, 27, 27, 256), "conv2", 1024),
            # the student tier's two sites (vggf_student: 32 and 128
            # channels) at buckets 1 and 32, and the distillation tool's
            # (32 px, batch 64)
            ((32, 54, 54, 32), "student_conv1", 32),
            ((32, 27, 27, 128), "student_conv2", 32),
            ((1, 54, 54, 32), "student_conv1", 1),
            ((1, 27, 27, 128), "student_conv2", 1),
            ((64, 6, 6, 32), "distill_conv1", None),
            ((64, 3, 3, 128), "distill_conv2", None)]
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
            # the exchange: NCCL's kernels, and every copy on the device
            # (the bucket packing and the gather's unpacking among them)
            "nccl_us": sum(v for k, v in by_name.items()
                           if "nccl" in k.lower()) / count,
            "copy_us": sum(v for k, v in by_name.items()
                           if "copy" in k.lower() or "memcpy" in k.lower())
            / count,
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
            # cuDNN's layout passes (nhwcAddPaddingKernel pads a
            # 3-channel NHWC input) and its convolution kernels
            "padding_us": {k[:80]: v / count for k, v in by_name.items()
                           if "padding" in k.lower()},
            "conv_us": [[k[:80], v / count] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])
                if re.search(r"fprop|dgrad|wgrad|conv", k, re.I)][:8],
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


def _forward_ms(engines, imgs, buckets=(1, 32), reps=10):
    """Median host ms of engine.run at each bucket (the u8 upload, the
    forward and the probabilities' download, which waits for the card)
    for each engine of the mapping, timed in turns: each repetition runs
    every engine once at each bucket, in the order given and then
    reversed, so no engine always runs first. Returns engine name ->
    bucket -> ms."""
    ts = {name: {str(b): [] for b in buckets} for name in engines}
    order = list(engines)
    for rep in range(reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            for b in buckets:
                t0 = time.perf_counter()
                engines[name].run(imgs[:b])
                ts[name][str(b)].append((time.perf_counter() - t0) * 1e3)
    return {name: {b: statistics.median(v) for b, v in by.items()}
            for name, by in ts.items()}


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
    forward_ms = _forward_ms({"e": engine}, imgs, engine.buckets)["e"]

    # reference: the CPU forward (plain LRN, fp32) of the same weights
    x = _normalized(imgs[:2], cfg.data)
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


def _logit_gap(got, ref):
    """The relative logit gap of two (N, classes) arrays of logits or
    log-probabilities: each row less its mean (which removes the per-row
    constant softmax drops), then max |got - ref| over the largest
    |ref|. A scale error of x % in the logits reads as about x %."""
    g = np.asarray(got, np.float64)
    r = np.asarray(ref, np.float64)
    g = g - g.mean(axis=1, keepdims=True)
    r = r - r.mean(axis=1, keepdims=True)
    return float(np.abs(g - r).max() / np.abs(r).max())


def _normalized(imgs, data):
    """u8 NHWC images as the CPU reference forward takes them: the fp32
    finish (mean and stddev of the preset)."""
    return torch.from_numpy(
        (imgs.astype(np.float32) - np.asarray(data.mean_rgb, np.float32))
        * (np.float32(1.0) / np.asarray(data.stddev_rgb, np.float32)))


def _int8_paths(base, calib, images):
    """The int8 heads three ways on one trunk output of `images` (8 at a
    time, the engine's bucket 8): `mirror`, the tier's own arithmetic
    (its folded constants, `_quantized_heads`), as probabilities; and two
    references built apart from it (`quantize_dense` and the
    calibration's scales, full-width GEMMs), as logits: `elided`, the
    dense heads with the codes of the channels the tier drops set to 0
    (what the compacted GEMMs compute, summed in another order), and
    `dense`, `dense_int8_reference`'s arithmetic (nothing dropped). Per
    head input: `flips`, the kept codes where mirror and `elided` part (a
    rounding boundary crossed by a sum in another order) and `flip_step`,
    the largest such difference; `elided_nonzero`, the codes `dense`
    holds on dropped channels (inputs above the calibrated range: the
    elision's cost), and `dense_differ`, the kept codes where `dense`
    parts from `elided` downstream of them."""
    from distributed_vgg_f_tpu_torch.data.device_ingest import \
        make_device_finish
    from distributed_vgg_f_tpu_torch.serving import tiers as tiers_mod
    params = tiers_mod._head_tree(base._model)
    folded, _ = tiers_mod._quantized_heads(params, calib)
    _, heads = tiers_mod._split_params(params)
    trunk = tiers_mod._make_trunk(base._model,
                                  make_device_finish(base._mean, base._std))
    layers = ("fc6", "fc7", "fc8")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def q(h, layer):
        return torch.clamp(torch.round(h / calib.scales[layer]), -127, 127)

    dense_w, folded_w, keep, dropped = {}, {}, {}, {}
    for layer in layers:
        wq, sc = tiers_mod.quantize_dense(heads[layer]["kernel"])
        dense_w[layer] = (dev(wq.astype(np.float32)
                              * (calib.scales[layer] * sc)),
                          dev(np.asarray(heads[layer]["bias"], np.float32)))
        folded_w[layer] = (dev(folded[layer]["w"]), dev(folded[layer]["b"]))
        keep[layer] = dev(calib.keep[layer].astype(np.int64))
        dropped[layer] = torch.ones(calib.widths[layer], dtype=torch.bool,
                                    device="cuda")
        dropped[layer][keep[layer]] = False
    counts = {layer: {"codes": 0, "elided_channels": int(
        dropped[layer].sum()), "flips": 0, "flip_step": 0.0,
        "elided_nonzero": 0, "dense_differ": 0} for layer in layers}
    out = {"mirror": [], "elided": [], "dense": []}
    with torch.inference_mode():
        for i in range(0, len(images), 8):
            x = trunk(torch.from_numpy(images[i:i + 8]).cuda())
            hm = he = hd = x
            for layer in layers:
                qm, qe, qd = q(hm, layer), q(he, layer), q(hd, layer)
                if layer == "fc6":  # the tier selects fc6's kept inputs
                    qm = torch.index_select(qm, 1, keep[layer])
                qe[:, dropped[layer]] = 0.0
                kept_e = torch.index_select(qe, 1, keep[layer])
                step = (qm - kept_e).abs()
                c = counts[layer]
                c["codes"] += int(qd.numel())
                c["flips"] += int((step != 0).sum())
                c["flip_step"] = max(c["flip_step"], float(step.max()))
                c["elided_nonzero"] += int((qd[:, dropped[layer]] != 0)
                                           .sum())
                c["dense_differ"] += int((torch.index_select(
                    qd, 1, keep[layer]) != kept_e).sum())
                hm = qm @ folded_w[layer][0] + folded_w[layer][1]
                he = qe @ dense_w[layer][0] + dense_w[layer][1]
                hd = qd @ dense_w[layer][0] + dense_w[layer][1]
                if layer != "fc8":
                    hm, he, hd = torch.relu(hm), torch.relu(he), \
                        torch.relu(hd)
            out["mirror"].append(torch.softmax(hm.float(), dim=-1))
            out["elided"].append(he)
            out["dense"].append(hd)
    return counts, {k: torch.cat(v).float().cpu().numpy()
                    for k, v in out.items()}


#: The int8 tier's gates in phase serve_tiers, at about 3-10x the
#: readings PERF.md records for it (seeded weights and images, so a
#: rerun reads the same up to cuDNN's choice of algorithms). Relative
#: logit gaps (`_logit_gap`): against the base route, the noise of three
#: int8 heads (read 3.7e-2); against the dense heads with the tier's
#: elision, the same function summed in another order, where one code
#: crossing a rounding boundary reads 5e-4 (none: 1e-6), so a scale off
#: by 1 % fails; against the dense reference, the elision's cost, by
#: stream (read 5.2e-3 on the calibration stream, 2.4e-2 past it).
#: Codes: at most this share of them cross a boundary (read 1 of
#: 557,056), by one step; on the calibration stream no fc6 input is
#: nonzero on a dropped channel (the trunk that set the ranges) and at
#: most this share of the fc7 and fc8 inputs is (read 14 of 262,144:
#: their ranges came from unquantized inputs, as in the JAX package)
_INT8_ROUTE_GAP = 0.1
_INT8_ELIDED_GAP = 5e-3
_INT8_DENSE_GAP = {"calibration": 2e-2, "seed99": 0.1}
_INT8_FLIPS = 1e-4
_INT8_CALIBRATION_ELIDED = 1e-3


class _KnobOnly:
    """The admission-window surface of a batcher, for replaying a
    controller's recorded windows."""

    def __init__(self, window_ms, queue_limit):
        self.window_ms = int(window_ms)
        self.queue_limit = int(queue_limit)

    def set_window_ms(self, ms):
        self.window_ms = max(1, int(ms))
        return self.window_ms


def _controller_burst(base, serving, *, queue_limit, interval_s, seconds,
                      clients, checked):
    """Part (c) of phase serve_tiers: a server over the warm base engine
    with the admission controller on (windows of `interval_s`, a queue of
    `queue_limit`, the serving defaults' hysteresis), `clients`
    closed-loop clients POSTing for `seconds`, then quiet until the
    window is back at its baseline (30 s at most). Every window's
    verdict, stats and move are recorded, and replayed through a fresh
    controller, which must make the same verdicts and moves. `checked`:
    the burst must also have widened the window and the quiet brought it
    back (else the windows are only recorded). Returns (record, LRN
    launches, flushes)."""
    import dataclasses

    from distributed_vgg_f_tpu_torch import telemetry
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.serving.controller import \
        AdmissionController
    from distributed_vgg_f_tpu_torch.serving.server import PredictServer
    cfg = dataclasses.replace(serving, controller=True, warmup=False,
                              queue_limit=queue_limit,
                              controller_interval_s=interval_s)
    server = PredictServer(cfg)
    server.add_engine(base)
    key = (base.model_name, base.tier)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (base.image_size, base.image_size, 3)
                       ).astype(np.uint8)
    statuses, stop = [], threading.Event()
    lock = threading.Lock()
    before = lrn_cuda.LAUNCHES, lrn_cuda.VEC_LAUNCHES
    port = server.start()

    def client():
        while not stop.is_set():
            try:
                code = _post(port, img)[0]
            except urllib.error.HTTPError as e:
                e.read()
                code = e.code
            with lock:
                statuses.append(code)

    try:
        threads = [threading.Thread(target=client) for _ in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads), "burst clients hung")
        burst_s = time.perf_counter() - t0
        widest = max(r["records"][key]["window_ms"]
                     for r in list(server.window_log))
        deadline = time.perf_counter() + 30
        while server.batcher(*key).window_ms != int(cfg.max_latency_ms) \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        quiet_s = time.perf_counter() - t0 - burst_s
        window_now = server.batcher(*key).window_ms
        flushes = sum(server.batcher(*key).describe()[
            "bucket_occupancy"].values())
    finally:
        server.close()
    torch.cuda.synchronize()
    launches = lrn_cuda.LAUNCHES - before[0]
    vec = lrn_cuda.VEC_LAUNCHES - before[1]
    windows = [r["records"][key] for r in list(server.window_log)]
    check(windows and list(server.window_log)[0]["window"] == 1,
          "the controller's window log lost its first windows")
    # the replay: the same verdicts and moves from the recorded evidence
    fake = _KnobOnly(cfg.max_latency_ms, cfg.queue_limit)
    fresh = AdmissionController(cfg, fake,
                                registry=telemetry.TelemetryRegistry())
    moves = []
    for i, rec in enumerate(windows):
        again = fresh.observe_window(dict(rec["stats"]))
        got = [(a["from"], a["to"]) for a in again.get("actuations", [])]
        want = [(a["from"], a["to"]) for a in rec.get("actuations", [])]
        check(again["serving_verdict"] == rec["serving_verdict"]
              and got == want and fake.window_ms == rec["window_ms"],
              f"window {i + 1}: replay {again['serving_verdict']} {got} "
              f"-> {fake.window_ms}, recorded {rec['serving_verdict']} "
              f"{want} -> {rec['window_ms']}")
        moves += [(i + 1, *m) for m in want]
    ups = [m for m in moves if m[2] > m[1]]
    seen = "".join(w["serving_verdict"][0] for w in windows)
    if checked:
        check(ups, f"no window was widened under the burst ({len(windows)} "
              f"windows, verdicts {seen}: q pressure, s steady)")
        check(window_now == int(cfg.max_latency_ms),
              f"window {window_now} ms, not back at its baseline "
              f"{cfg.max_latency_ms} ms 30 s after the burst")
    check(launches == 2 * flushes and vec == launches,
          f"burst: {launches} LRN launches ({vec} vector) for {flushes} "
          "forwards")
    return {"checked": checked, "clients": clients, "burst_s": burst_s,
            "quiet_s": quiet_s, "window_at_end_ms": window_now,
            "pressure_at_queue": cfg.queue_pressure_fraction
            * cfg.queue_limit,
            "requests": len(statuses),
            "statuses": {str(c): statuses.count(c) for c in set(statuses)},
            "queue_limit": cfg.queue_limit,
            "interval_s": cfg.controller_interval_s,
            "k_windows": cfg.controller_k_windows,
            "cooldown_windows": cfg.controller_cooldown_windows,
            "relax_after_windows": cfg.controller_relax_after_windows,
            "windows": len(windows),
            "verdicts": [w["serving_verdict"] for w in windows],
            "queue_peaks": [w["stats"]["queue_peak"] for w in windows],
            "sheds": [w["stats"]["shed"] for w in windows],
            "window_ms": [w["window_ms"] for w in windows],
            "moves": moves, "widest_ms": widest,
            "replayed": True, "flushes": flushes}, launches, flushes


def phase_serve_tiers(tree):
    """The serving tier ladder on the flagship at full width (224 px, 1000
    classes, bf16 compute, seeded weights): (a) the base engine (the
    "fp32" route: the model at its compute dtype, bf16 here) and its
    bf16, int8 (the default calibration, 4 batches of 8) and student
    (a seeded vggf_student, bf16) tiers built, each engine's resident
    device bytes measured beside its hbm_estimate_bytes; every bucket of
    each warmed as the server registers it, then 4 POSTs to each tier in
    turn (`?tier=`), each answer bit-equal to that tier's own engine.run
    (cuDNN deterministic); LRN launch counts zeroed before the builds and
    read after the POSTs, by tier (2 a forward, all of the vector
    variant: the student's 32 and 128 channels too); (b) each comparison
    a relative logit gap (`_logit_gap`): the base route and the student
    against the CPU forward of their weights (fp32, plain LRN; the bf16
    gate, 2e-2), bf16 and int8 against the base route at bucket 32 (with
    top-1 agreement), int8 compacted (the engine) against the port's
    dense int8 reference on the calibration stream and on 8 images past
    it (TF32 off), with and without the tier's elision, and the int8
    codes of each path at each head input (`_int8_paths`); forward ms at
    buckets 1 and 32 (the tiers timed in turns) and the peak device bytes
    of a bucket-32 forward for each tier; (c) the admission controller
    under a burst, at the cut setting (checked) and at the preset's
    (recorded: `_controller_burst`).
    Returns the LRN launches of (a) and (c)."""
    import dataclasses

    from distributed_vgg_f_tpu_torch import telemetry
    from distributed_vgg_f_tpu_torch.config import (ModelConfig,
                                                    ServingTiersConfig,
                                                    get_config)
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.serving import tiers as tiers_mod
    from distributed_vgg_f_tpu_torch.serving.engine import PredictEngine
    from distributed_vgg_f_tpu_torch.serving.server import PredictServer
    from distributed_vgg_f_tpu_torch.weights import init_params, load_params
    cfg = get_config("vggf_imagenet_dp")
    size, classes = cfg.data.image_size, cfg.model.num_classes
    serving = dataclasses.replace(
        cfg.serving, enabled=True, controller=False, warmup=True,
        tiers=ServingTiersConfig(enabled=True))
    reg = telemetry.get_registry()
    reg.reset()
    scfg = ModelConfig(name="vggf_student", num_classes=classes,
                       compute_dtype=cfg.model.compute_dtype)
    student_tree = init_params(scfg, 1, image_size=size)
    student_model = load_params(build_model(scfg, image_size=size),
                                student_tree)
    base_model = load_params(build_model(cfg.model, image_size=size), tree)
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (32, size, size, 3)).astype(np.uint8)
    singles = rng.integers(0, 256, (4, size, size, 3)).astype(np.uint8)

    resident, build_s = {}, {}

    def built(tier, make):
        torch.cuda.synchronize()
        m0, t0 = torch.cuda.memory_allocated(), time.perf_counter()
        eng = make()
        torch.cuda.synchronize()
        resident[tier] = torch.cuda.memory_allocated() - m0
        build_s[tier] = time.perf_counter() - t0
        return eng

    lrn_cuda.LAUNCHES = lrn_cuda.VEC_LAUNCHES = 0
    base = built("fp32", lambda: PredictEngine(
        model_name="vggf", model=base_model, image_size=size,
        num_classes=classes, buckets=serving.buckets,
        max_batch=serving.max_batch, image_dtype=cfg.data.image_dtype,
        mean_rgb=cfg.data.mean_rgb, stddev_rgb=cfg.data.stddev_rgb,
        device="cuda"))
    ladder = {"fp32": base,
              "bf16": built("bf16", lambda: tiers_mod.build_bf16_engine(base)),
              "int8": built("int8", lambda: tiers_mod.build_int8_engine(
                  base, tiers_cfg=serving.tiers))}
    calib = ladder["int8"].calibration
    calib_launches = lrn_cuda.LAUNCHES
    check(calib_launches == 2 * calib.batches,
          f"calibration of {calib.batches} batches launched the LRN kernel "
          f"{calib_launches} times")
    ladder["student"] = built(
        "student", lambda: tiers_mod.build_student_engine(
            base, student_model=student_model))
    check(ladder["student"].served_by == "vggf_student"
          and all(e.tier == t for t, e in ladder.items()),
          "tier engines mislabelled")

    server = PredictServer(serving)
    by_tier = {}
    with cudnn_deterministic():
        for tier in tiers_mod.TIERS:
            n0 = lrn_cuda.LAUNCHES
            server.add_engine(ladder[tier])
            torch.cuda.synchronize()
            check(sorted(ladder[tier].compile_log)
                  == list(ladder[tier].buckets),
                  f"{tier}: warm buckets {sorted(ladder[tier].compile_log)}")
            by_tier[tier] = {"warmup": lrn_cuda.LAUNCHES - n0}
        port = server.start()
        bodies = {}
        try:
            for tier in tiers_mod.TIERS:
                n0 = lrn_cuda.LAUNCHES
                bodies[tier] = []
                for img in singles:
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}/v1/predict/vggf?tier="
                        f"{tier}&k={classes}", data=img.tobytes(),
                        method="POST")
                    with urllib.request.urlopen(req, timeout=120) as r:
                        body = json.loads(r.read())
                    check(r.status == 200 and body["tier"] == tier
                          and body["bucket"] == 1,
                          f"{tier} POST {r.status} {body.get('tier')}")
                    bodies[tier].append(body)
                torch.cuda.synchronize()
                by_tier[tier]["served"] = lrn_cuda.LAUNCHES - n0
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/models", timeout=60) as r:
                table = json.loads(r.read())["models"]["vggf"]
        finally:
            server.close()
        torch.cuda.synchronize()
        launches, vec = lrn_cuda.LAUNCHES, lrn_cuda.VEC_LAUNCHES
        # each tier's answers against its own engine.run (not counted)
        for tier in tiers_mod.TIERS:
            for img, body in zip(singles, bodies[tier]):
                probs, _ = ladder[tier].run(img[None])
                served = {r["class"]: r["prob"] for r in body["top_k"]}
                check(all(served[c] == float(p)
                          for c, p in enumerate(probs[0])),
                      f"{tier}: served probabilities differ from its "
                      "engine.run")
    check(sorted(table["tiers"]) == sorted(tiers_mod.TIERS),
          f"/v1/models tiers {sorted(table['tiers'])}")
    forwards = calib.batches + sum(
        len(e.buckets) for e in ladder.values()) + 4 * len(ladder)
    check(launches == 2 * forwards and vec == launches,
          f"{launches} LRN launches ({vec} vector) for {forwards} forwards")
    for tier, n in by_tier.items():
        check(n == {"warmup": 2 * len(ladder[tier].buckets), "served": 8},
              f"{tier}: LRN launches {n}")

    # (b) every comparison as a relative logit gap (`_logit_gap`): the
    # served probabilities' logs against the reference's logits.
    # The base route and the student against the CPU forward of their
    # weights (fp32, plain LRN) within the bf16 gate, as phase model
    # holds the model; bf16 and int8 against the base route
    x = _normalized(imgs[:2], cfg.data)
    on_cpu = {}
    for tier, mcfg, weights in (("fp32", cfg.model, tree),
                                ("student", scfg, student_tree)):
        ref_model = load_params(build_model(dataclasses.replace(
            mcfg, compute_dtype="float32"), image_size=size), weights).eval()
        with torch.no_grad():
            want = ref_model(x).numpy()
        probs, _ = ladder[tier].run(imgs[:2])
        gap = _logit_gap(np.log(probs), want)
        on_cpu[tier] = {"logit_gap": gap, "tolerance": 2e-2,
                        "top1_agree": float(np.mean(
                            probs.argmax(1) == want.argmax(1)))}
        check(bool(np.isfinite(probs).all()) and gap <= 2e-2,
              f"{tier} tier off the CPU forward of its weights: logit gap "
              f"{gap}")
        del ref_model
    ref, _ = base.run(imgs)
    against = {}
    for tier, tol in (("bf16", 2e-2), ("int8", _INT8_ROUTE_GAP)):
        probs, _ = ladder[tier].run(imgs)
        gap = _logit_gap(np.log(probs), np.log(ref))
        against[tier] = {
            "logit_gap": gap, "tolerance": tol,
            "max_abs_prob_err": float(np.abs(probs - ref).max()),
            "largest_prob": float(ref.max()),
            "top1_agree": float(np.mean(probs.argmax(1) == ref.argmax(1)))}
        check(bool(np.isfinite(probs).all()) and gap <= tol,
              f"{tier} off the fp32 route: logit gap {gap} > {tol}")
    # int8 compacted (the served engine) against two references built
    # apart from it (`_int8_paths`), on the calibration stream itself and
    # on 8 images past it (seed 99): the dense heads with the tier's
    # elision (the same function summed in another order) and without
    # it (the dense int8 reference: the elision's cost)
    dense_cmp = {}
    for name, cal in (
            ("calibration", tiers_mod.calibration_images(
                size, batches=calib.batches, batch_size=calib.batch_size,
                seed=calib.seed)),
            ("seed99", tiers_mod.calibration_images(
                size, batches=1, batch_size=8, seed=99))):
        compacted = np.concatenate([
            ladder["int8"].run(cal[i:i + 8])[0]
            for i in range(0, len(cal), 8)])
        codes, paths = _int8_paths(base, calib, cal)
        rec = {"images": int(len(cal)),
               "mirror_max_abs_prob_err": float(np.abs(
                   compacted - paths["mirror"]).max()),
               "elided_logit_gap": _logit_gap(np.log(compacted),
                                              paths["elided"]),
               "elided_tolerance": _INT8_ELIDED_GAP,
               "dense_logit_gap": _logit_gap(np.log(compacted),
                                             paths["dense"]),
               "dense_tolerance": _INT8_DENSE_GAP[name],
               "dense_max_abs_prob_err": float(np.abs(
                   compacted - torch.softmax(torch.from_numpy(
                       paths["dense"]), -1).numpy()).max()),
               "codes": codes}
        dense_cmp[name] = rec
        # the mirror is the tier's own arithmetic: it must be the engine
        check(rec["mirror_max_abs_prob_err"] <= 1e-6,
              f"int8 mirror off the engine on {name}: "
              f"{rec['mirror_max_abs_prob_err']}")
        flips = sum(c["flips"] for c in codes.values())
        check(all(c["flip_step"] <= 1 for c in codes.values())
              and flips <= _INT8_FLIPS * sum(c["codes"]
                                             for c in codes.values())
              and rec["elided_logit_gap"] <= _INT8_ELIDED_GAP,
              f"int8 compacted off the dense heads with its elision on "
              f"{name}: logit gap {rec['elided_logit_gap']} > "
              f"{_INT8_ELIDED_GAP} or codes {codes}")
        check(rec["dense_logit_gap"] <= _INT8_DENSE_GAP[name],
              f"int8 compacted off its dense reference on {name}: logit "
              f"gap {rec['dense_logit_gap']} > {_INT8_DENSE_GAP[name]}; "
              f"codes {codes}")
        if name == "calibration":
            later = [codes[k] for k in ("fc7", "fc8")]
            check(codes["fc6"]["elided_nonzero"] == 0
                  and sum(c["elided_nonzero"] for c in later)
                  <= _INT8_CALIBRATION_ELIDED * sum(c["codes"]
                                                    for c in later),
                  f"int8 elision on its own calibration stream: {codes}")
    rows = {}
    in_turns = _forward_ms(ladder, imgs)
    for tier, eng in ladder.items():
        forward_ms = in_turns[tier]
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.run(imgs)
        torch.cuda.synchronize()
        rows[tier] = {
            "served_by": eng.served_by, "build_s": build_s[tier],
            "forward_ms": forward_ms,
            "images_per_s_32": 32 / (forward_ms["32"] / 1e3),
            "hbm_estimate_bytes": eng.hbm_estimate_bytes,
            "resident_bytes": resident[tier],
            "forward32_peak_extra_bytes":
                torch.cuda.max_memory_allocated() - m0,
            "warmup_s": {str(b): s for b, s in
                         sorted(eng.compile_log.items())},
            "lrn_launches": by_tier[tier]}
    # the cut setting, where the front end can fill the queue: checked
    burst, burst_launches, _ = _controller_burst(
        base, serving, queue_limit=32, interval_s=0.1, seconds=3.0,
        clients=96, checked=True)
    # the preset's queue and windows, 160 clients for 6 windows: recorded
    preset, preset_launches, _ = _controller_burst(
        base, serving, queue_limit=serving.queue_limit,
        interval_s=serving.controller_interval_s,
        seconds=6 * serving.controller_interval_s, clients=160,
        checked=False)
    emit("serve_tiers", model="vggf", image_size=size, num_classes=classes,
         base_compute_dtype=cfg.model.compute_dtype,
         student_compute_dtype=scfg.compute_dtype,
         buckets=list(base.buckets), calibration=calib.receipt(),
         tiers=rows, against_cpu=on_cpu, against_fp32=against,
         int8_against_dense=dense_cmp,
         served_bit_equal=True, lrn_launches=launches,
         lrn_vec_launches=vec, calibration_launches=calib_launches,
         controller=burst, burst_lrn_launches=burst_launches,
         controller_at_preset=preset,
         preset_burst_lrn_launches=preset_launches)
    del ladder, base, server, student_model, base_model
    gc.collect()
    torch.cuda.empty_cache()
    return launches + burst_launches + preset_launches


#: The serving process of phase serve_cli: the console's `--mode serve`
#: run as __main__, reporting its LRN launch counts when it exits.
_SERVE_MAIN = (
    "import atexit, json, runpy, sys\n"
    "from distributed_vgg_f_tpu_torch.ops import lrn_cuda\n"
    "atexit.register(lambda: print('LRN ' + json.dumps({\n"
    "    'launches': lrn_cuda.LAUNCHES,\n"
    "    'vec_launches': lrn_cuda.VEC_LAUNCHES}), flush=True))\n"
    "sys.argv = ['distributed_vgg_f_tpu_torch.cli'] + sys.argv[1:]\n"
    "runpy.run_module('distributed_vgg_f_tpu_torch.cli', "
    "run_name='__main__')\n")


def phase_serve_cli():
    """`python -m distributed_vgg_f_tpu_torch.cli --mode serve` as a user
    starts it, over a checkpoint of the flagship at full width: (a) a
    short fit of its own (2 steps on seeded u8 batches of 64, bf16,
    Trainer.fit with a checkpoint directory; cut from the preset's 1024
    for time), then --mode predict on 4 .npy u8 images in this process;
    (b) the server as a subprocess with serving.enabled and
    serving.tiers.enabled (so bf16 and int8 are built from the
    checkpoint), started through runpy so it reports its own LRN counts
    as it exits: it prints `serving on HOST:PORT`; the 4 images POSTed
    one at a time (the fp32 route) agree with predict's probabilities
    within PERF.md's bf16 gate (2e-2 of the largest) and in top-1, one
    POST each to the bf16 and int8 tiers answers 200, /v1/models lists the
    ladder; SIGINT ends it with 0 and its serving_start record carries
    the ladder. Returns the LRN launches of the serving process."""
    import contextlib
    import dataclasses
    import io
    import signal

    from distributed_vgg_f_tpu_torch import cli
    from distributed_vgg_f_tpu_torch.config import parse_cli
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    root = tempfile.mkdtemp(prefix="serve_cli_")
    ck = os.path.join(root, "ck")
    sets = ["--config", "vggf_imagenet_dp", "--set", "data.name=synthetic",
            "--set", "data.global_batch_size=64", "--set",
            f"train.checkpoint_dir={ck}", "--set", "train.steps=2",
            "--set", "train.checkpoint_every_steps=2"]
    try:
        cfg = parse_cli(sets)
        size = cfg.data.image_size
        t0 = time.perf_counter()
        trainer = Trainer(cfg)
        trainer.fit(trainer.init_state(0))
        fit_s = time.perf_counter() - t0
        check(trainer.checkpoints.latest_step() == 2,
              f"the fit saved step {trainer.checkpoints.latest_step()}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        rng = np.random.default_rng(4)
        imgs = rng.integers(0, 256, (4, size, size, 3)).astype(np.uint8)
        npys = []
        for i, img in enumerate(imgs):
            npys.append(os.path.join(root, f"img{i}.npy"))
            np.save(npys[-1], img)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(sets + ["--mode", "predict", "--images", *npys])
        predicted = [json.loads(line) for line in out.getvalue().splitlines()
                     if line.startswith("{")]
        check(len(predicted) == len(npys),
              f"predict printed {len(predicted)} records")
        gc.collect()
        torch.cuda.empty_cache()

        serve = sets + ["--mode", "serve", "--set", "serving.enabled=true",
                        "--set", "serving.tiers.enabled=true"]
        err_path = os.path.join(root, "serve.stderr")
        t0 = time.perf_counter()
        with open(err_path, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-c", _SERVE_MAIN, *serve],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=err, text=True)
        lines = []
        reader = threading.Thread(
            target=lambda: [lines.append(x.strip()) for x in proc.stdout],
            daemon=True)
        reader.start()
        try:
            deadline = time.perf_counter() + 300
            while not any(x.startswith("serving on ") for x in lines):
                check(proc.poll() is None and time.perf_counter() < deadline,
                      "the server printed no 'serving on' line: "
                      + open(err_path).read()[-2000:])
                time.sleep(0.05)
            start_s = time.perf_counter() - t0
            endpoint = next(x for x in lines
                            if x.startswith("serving on ")).split()[-1]
            served, latency, errs = [], [], []
            for img, rec in zip(imgs, predicted):
                t1 = time.perf_counter()
                req = urllib.request.Request(
                    f"http://{endpoint}/v1/predict/vggf?k=1000",
                    data=img.tobytes(), method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    body = json.loads(r.read())
                latency.append((time.perf_counter() - t1) * 1e3)
                check(body["tier"] == "fp32" and body["bucket"] == 1,
                      f"served {body.get('tier')} bucket {body.get('bucket')}")
                probs = {e["class"]: e["prob"] for e in body["top_k"]}
                want = {e["class"]: e["prob"] for e in rec["top_k"]}
                top = max(want.values())
                errs.append(max(abs(probs[c] - p) for c, p in want.items()))
                served_top1 = body["top_k"][0]["class"]
                check(errs[-1] <= 2e-2 * top and (
                    served_top1 == rec["top_k"][0]["class"]
                    or abs(probs[served_top1] - top) <= 2e-2 * top),
                      f"served probabilities off predict's by {errs[-1]} "
                      f"(largest {top}), top-1 {served_top1} against "
                      f"{rec['top_k'][0]['class']}")
                served.append(body)
            for tier in ("bf16", "int8"):
                req = urllib.request.Request(
                    f"http://{endpoint}/v1/predict/vggf?tier={tier}",
                    data=imgs[0].tobytes(), method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    body = json.loads(r.read())
                check(r.status == 200 and body["tier"] == tier,
                      f"{tier} POST {r.status} {body.get('tier')}")
            with urllib.request.urlopen(f"http://{endpoint}/v1/models",
                                        timeout=60) as r:
                table = json.loads(r.read())["models"]["vggf"]
            check(sorted(table["tiers"]) == ["bf16", "fp32", "int8"],
                  f"/v1/models tiers {sorted(table['tiers'])}")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
            stop_s = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reader.join(timeout=30)
        check(rc == 0, f"serve exited {rc}: " + open(err_path).read()[-2000:])
        counts = json.loads(next(x for x in lines
                                 if x.startswith("LRN "))[4:])
        tiers_cfg = cfg.serving.tiers
        forwards = tiers_cfg.calibration_batches + 3 * len(
            table["buckets"]) + len(imgs) + 2
        check(counts["launches"] == 2 * forwards
              and counts["vec_launches"] == counts["launches"],
              f"serving process LRN launches {counts} for {forwards} "
              "forwards")
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            starts = [json.loads(x) for x in f
                      if '"serving_start"' in x]
        check(len(starts) == 1 and sorted(starts[0]["ladder"]["vggf"])
              == ["bf16", "fp32", "int8"],
              f"serving_start records {starts}")
        ladder = starts[0]["ladder"]["vggf"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("serve_cli", fit_s=fit_s, fit_batch=cfg.data.global_batch_size,
         fit_steps=2, server_start_s=start_s, endpoint=endpoint,
         predict_max_abs_err=max(errs),
         tolerance="2e-2 x the largest probability",
         latency_ms=latency, sigint_to_exit_s=stop_s, exit_code=rc,
         lrn_launches=counts["launches"],
         lrn_vec_launches=counts["vec_launches"],
         ladder_hbm_estimate_bytes={t: r["hbm_estimate_bytes"]
                                    for t, r in ladder.items()},
         ladder_warmup_s={t: r["warmup_s"] for t, r in ladder.items()})
    return counts["launches"]


def phase_distill():
    """The distillation tool on the card (vggf_student, 32 px, 10
    classes, batch 64, fp32, TF32 off): (a) 3 steps of train_distilled at
    dropout 0 from one seeded start on the card and on the CPU, the
    losses within 1e-4 relative; (b) the tool as a user runs it (`python
    -m distributed_vgg_f_tpu_torch.train.distill`), here through its
    `main` (20 steps, 256 eval images): its npz written and read back,
    the final loss finite, the LRN launch counts zeroed just before and
    read just after: 2 forward launches a training step and an eval
    batch, 2 backward a training step, all of the vector variant (32 and
    128 channels). Returns (b)'s forward and backward launches."""
    import contextlib
    import io

    from distributed_vgg_f_tpu_torch.config import ModelConfig
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.train import distill
    from distributed_vgg_f_tpu_torch.weights import init_params
    start = init_params(ModelConfig(name="vggf_student", num_classes=10,
                                    compute_dtype="float32"), 3,
                        image_size=32)
    losses, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _, hist = distill.train_distilled(
            "vggf_student", steps=3, log_every=1, dropout_rate=0.0,
            init_params=start, device=dev)
        seconds[dev] = time.perf_counter() - t0
        losses[dev] = [h["loss"] for h in hist]
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses["cuda"], losses["cpu"]))
    check(len(losses["cuda"]) == 3
          and all(math.isfinite(v) for v in losses["cuda"])
          and rel <= 1e-4,
          f"distillation losses on the card {losses['cuda']} against the "
          f"CPU's {losses['cpu']}: {rel} relative")
    steps, evals, batch = 20, 256, 64
    root = tempfile.mkdtemp(prefix="distill_")
    try:
        out_path = os.path.join(root, "student.npz")
        out = io.StringIO()
        lrn_cuda.LAUNCHES = lrn_cuda.VEC_LAUNCHES = 0
        lrn_cuda.BWD_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = distill.main(["--steps", str(steps), "--eval-examples",
                               str(evals), "--batch-size", str(batch),
                               "--out", out_path])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        fwd, vec = lrn_cuda.LAUNCHES, lrn_cuda.VEC_LAUNCHES
        bwd, vec_bwd = lrn_cuda.BWD_LAUNCHES, lrn_cuda.VEC_BWD_LAUNCHES
        printed = [json.loads(x) for x in out.getvalue().splitlines()
                   if x.startswith("{")]
        tree = distill.load_params(out_path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    final = printed[-1] if printed else {}
    check(rc == 0 and final.get("final_loss") is not None
          and sorted(tree) == sorted(start),
          f"the distillation tool exited {rc}, printed {final}, wrote "
          f"layers {sorted(tree)}")
    want_fwd, want_bwd = 2 * (steps + evals // batch), 2 * steps
    check(fwd == want_fwd and bwd == want_bwd and vec == fwd
          and vec_bwd == bwd,
          f"distillation LRN launches: {fwd} forward ({vec} vector), {bwd} "
          f"backward ({vec_bwd} vector); expected {want_fwd} and "
          f"{want_bwd}")
    emit("distill", model="vggf_student", image_size=32, num_classes=10,
         batch=batch, parity_steps=3, losses_card=losses["cuda"],
         losses_cpu=losses["cpu"], loss_max_rel_err=rel,
         loss_tolerance=1e-4, parity_s=seconds, main_steps=steps,
         main_eval_images=evals, main_s=main_s,
         eval_top1=final.get("eval_top1"),
         final_loss=final.get("final_loss"), lrn_fwd_launches=fwd,
         lrn_bwd_launches=bwd)
    return {"fwd": fwd, "bwd": bwd}


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
            ((32, 27, 27, 256), "conv2", 32),
            # the distillation tool's two sites (vggf_student at 32 px,
            # batch 64), untimed
            ((64, 6, 6, 32), "distill_conv1", None),
            ((64, 3, 3, 128), "distill_conv2", None)]
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
    # autograd leaves reference cycles: free the card's copies now, not at
    # some later collection inside phase train's peak-memory window
    gc.collect()
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
            "nccl_us_per_step": t["nccl_us"],
            "copy_us_per_step": t["copy_us"],
            "padding_us_per_step": t["padding_us"],
            "conv_us_per_step": t["conv_us"],
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
    # the peak counts what is allocated when the fit starts: the state,
    # and anything an earlier phase left on the card
    allocated_before = torch.cuda.memory_allocated()
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
         peak_memory_bytes=peak, allocated_before_fit_bytes=allocated_before,
         losses=losses,
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
    return launches, {"step_ms_median": median_ms,
                      "copy_us_per_step": profile["copy_us_per_step"]}


#: The packed stem against the plain conv, relative L2 of the outputs and
#: of conv1's weight gradient: bf16 rounds every output once (2^-8
#: relative at most an element, so one rounding apart is under 3.9e-3);
#: fp32 is PERF.md §2's gradient gate
_STEM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def phase_stem(tree):
    """VGG-F's packed stem (models/vggf.py `VGGF.stem`: the 3x3x48
    stride-1 conv over the 4x4-packed batch) against the plain 11x11/4
    conv it replaces, on the card at the training batch (1024, 224 px)
    with the seeded conv1 weights: the outputs and conv1's weight
    gradient under one upstream gradient, in bf16 (the flagship's) and
    fp32 (TF32 off); each path's forward and weight-gradient device ms;
    the kernels each runs, where the packed path must run no NHWC
    padding kernel."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.data.device_ingest import (
        make_device_finish, space_to_depth_batch)
    from distributed_vgg_f_tpu_torch.models.vggf import (VGGF, _nchw,
                                                         takes_packed_stem)
    cfg = get_config("vggf_imagenet_dp")
    b, size = cfg.data.global_batch_size, cfg.data.image_size
    check(takes_packed_stem(size, size, 3), f"{size} px takes the plain stem")
    rng = np.random.default_rng(6)
    u8 = torch.from_numpy(rng.integers(0, 256, (b, size, size, 3),
                                       dtype=np.uint8)).cuda()
    finish = make_device_finish(cfg.data.mean_rgb, cfg.data.stddev_rgb)
    kernel = torch.from_numpy(np.ascontiguousarray(
        tree["conv1"]["kernel"].transpose(3, 2, 0, 1)))
    bias = torch.from_numpy(np.array(tree["conv1"]["bias"]))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = VGGF(cfg.model.num_classes, compute_dtype=dtype,
                     image_size=size)
        conv1 = model.conv1.cuda()
        with torch.no_grad():
            conv1.weight.copy_(kernel)
            conv1.bias.copy_(bias)
        x = finish(u8).to(dtype)
        xp = space_to_depth_batch(x)   # the augment stage packs the batch
        view = _nchw(xp)
        paths = {"packed": (model.stem, xp),
                 "plain": (lambda t: model._conv(conv1, _nchw(t), 4, 0), x)}
        ys = {k: fn(inp) for k, (fn, inp) in paths.items()}
        g = torch.randn(ys["plain"].shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7)) \
            .to(dtype).contiguous(memory_format=torch.channels_last)
        grads = {k: torch.autograd.grad(y, conv1.weight, g,
                                        retain_graph=True)[0]
                 for k, y in ys.items()}
        rec = {"dtype": str(dtype).replace("torch.", ""), "batch": b,
               "image_size": size,
               "packed_input": list(xp.shape),
               "packed_input_is_a_view": view.data_ptr() == xp.data_ptr()
               and view.is_contiguous(memory_format=torch.channels_last),
               "out_shape": list(ys["packed"].shape),
               "fwd_rel_l2": _rel_l2(ys["packed"].detach().float(),
                                     ys["plain"].detach().float()),
               "wgrad_rel_l2": _rel_l2(grads["packed"], grads["plain"]),
               "tolerance_rel_l2": _STEM_TOL[dtype],
               "fwd_ms": {k: device_ms(fn, [inp])
                          for k, (fn, inp) in paths.items()},
               "pack_ms": device_ms(space_to_depth_batch, [x]),
               "wgrad_ms": {k: device_ms(
                   lambda _, y=y: torch.autograd.grad(
                       y, conv1.weight, g, retain_graph=True), [None])
                   for k, y in ys.items()},
               "kernels_us": {}}
        rec["padding_kernels_us"] = {}
        for k, (fn, inp) in paths.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.autograd.grad(fn(inp), conv1.weight, g)
                torch.cuda.synchronize()
            t = _trace_breakdown(prof, 1, top=8)
            rec["kernels_us"][k] = t["top_us"]
            rec["padding_kernels_us"][k] = t["padding_us"]
        emit("stem", **rec)
        out[rec["dtype"]] = rec
        del model, conv1, x, xp, view, ys, g, grads
        torch.cuda.empty_cache()
    for rec in out.values():
        check(rec["packed_input_is_a_view"],
              "the packed batch is copied on its way to cuDNN")
        check(rec["out_shape"] == [b, 64, 54, 54], f"stem {rec['out_shape']}")
        check(rec["fwd_rel_l2"] <= rec["tolerance_rel_l2"]
              and rec["wgrad_rel_l2"] <= rec["tolerance_rel_l2"],
              f"packed stem off the plain conv in {rec['dtype']}: "
              f"{rec['fwd_rel_l2']}, {rec['wgrad_rel_l2']}")
        check(not rec["padding_kernels_us"]["packed"],
              f"the packed stem pads: {rec['padding_kernels_us']}")
    return out


#: Phase train_augment's ops on top of the preset's flip and mixup: crop
#: jitter 8 px, cutmix at the CutMix paper's ImageNet alpha of 1, two
#: rounds of RandAugment-lite at magnitude 0.5
_AUGMENT_ALL = {"data.augment.crop_jitter": "8",
                "data.augment.cutmix_alpha": "1.0",
                "data.augment.rand_ops": "2",
                "data.augment.rand_magnitude": "0.5"}
#: RandAugment on the card against the CPU (tests/test_torch_augment.py):
#: elements within 2e-6 (normalised), except at images that drew
#: posterize, where a contrast mean summed in another order can move a
#: pixel across a quantisation step in the next round; those, at most
#: this share of the posterized images' elements
_RAND_ATOL, _TWO_ROUND_SHARE = 2e-6, 0.30


def phase_train_augment(train_ref):
    """Every op of JAX's augment stage on the flagship at full width
    (batch 1024, 224 px, bf16 compute): (a) one batch through the stage's
    ops on the card and on the CPU from the same draws (flip, jitter and
    cutmix bit-equal, mixup within 1e-6, RandAugment within _RAND_ATOL
    but for counted posterize flips), the stage as the train step calls
    it equal to the ops packed, and its device µs a batch (torch.profiler
    over 3 batches: the stage copies its draws to the card, so events
    around it would time the host too); (b) 20 steps
    of Trainer.fit on phase train's seeded u8 batch: finite losses, step
    ms beside phase train's, 40 + 40 LRN launches (all vector). Returns
    (b)'s launches."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_vgg_f_tpu_torch.config import (apply_overrides,
                                                     get_config)
    from distributed_vgg_f_tpu_torch.data.augment import (
        AUGMENT_RNG_FOLD, crop_jitter, cutmix, draw_augment, hflip,
        make_device_augment, mixup, rand_ops)
    from distributed_vgg_f_tpu_torch.data.device_ingest import (
        make_device_finish, space_to_depth_batch)
    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = apply_overrides(get_config("vggf_imagenet_dp"), {
        **_AUGMENT_ALL, "train.log_every": "1", "train.seed": "0"})
    aug, data_cfg = cfg.data.augment, cfg.data
    b, size = data_cfg.global_batch_size, data_cfg.image_size
    data = SyntheticU8(b, size, cfg.model.num_classes, seed=0, pin=True)

    # (a) the ops on both devices from one step's draws
    t0 = time.perf_counter()
    finish = make_device_finish(data_cfg.mean_rgb, data_cfg.stddev_rgb,
                                image_dtype=data_cfg.image_dtype)
    images, labels = data.batch["image"], data.batch["label"]
    key = (0, 3, AUGMENT_RNG_FOLD)
    d = draw_augment(aug, key, b, size, size)
    mean = torch.tensor(data_cfg.mean_rgb, dtype=torch.float32)
    inv_std = torch.tensor(1.0) / torch.tensor(data_cfg.stddev_rgb,
                                               dtype=torch.float32)
    card = finish(images.cuda()).float()
    host = finish(images).float()
    exact = {}
    card, host = hflip(card, d.flip), hflip(host, d.flip)
    exact["flip"] = torch.equal(card.cpu(), host)
    card, host = crop_jitter(card, *d.jitter), crop_jitter(host, *d.jitter)
    exact["jitter"] = torch.equal(card.cpu(), host)
    card = rand_ops(card, *d.rand, mean, inv_std, aug.rand_magnitude)
    host = rand_ops(host, *d.rand, mean, inv_std, aug.rand_magnitude)
    diff = (card.cpu() - host).abs()
    posterized = (d.rand[0] == 3).any(0)
    far = diff > _RAND_ATOL
    rand_rec = {"max_abs_err": float(diff.max()),
                "far_elements": int(far.sum()),
                "far_outside_posterize": int(far[~posterized].sum()),
                "posterized_elements": int(posterized.sum()) * size * size * 3,
                "ops_drawn": np.bincount(d.rand[0].numpy().ravel(),
                                         minlength=4).tolist()}
    # both mixes on the card's RandAugment output, on both devices
    src = card.cpu()
    labels_card = labels.cuda()
    cut_card = cutmix(card, labels_card, d.mix.perm, d.mix.lam, d.mix.cy,
                      d.mix.cx)
    cut_host = cutmix(src, labels, d.mix.perm, d.mix.lam, d.mix.cy, d.mix.cx)
    exact["cutmix"] = (torch.equal(cut_card[0].cpu(), cut_host[0])
                       and torch.equal(cut_card[1].cpu(), cut_host[1])
                       and float(cut_card[2]) == float(cut_host[2]))
    mix_card = mixup(card, labels_card, d.mix.perm, d.mix.lam)
    mix_host = mixup(src, labels, d.mix.perm, d.mix.lam)
    mix_err = float((mix_card[0].cpu() - mix_host[0]).abs().max())
    chosen = cut_card if d.mix.use_cut else mix_card
    stage = make_device_augment(aug, data_cfg.mean_rgb, data_cfg.stddev_rgb,
                                space_to_depth=data_cfg.space_to_depth)
    x_in = finish(images.cuda())
    staged, staged_labels, staged_lam = stage(key, x_in, labels_card)
    stage_equal = (torch.equal(staged, space_to_depth_batch(
        chosen[0].to(x_in.dtype))) and torch.equal(staged_labels, chosen[1])
        and float(staged_lam) == float(chosen[2]))
    a_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for step in range(3):
            stage((0, step, AUGMENT_RNG_FOLD), x_in, labels_card)
        torch.cuda.synchronize()
    t = _trace_breakdown(prof, 3, top=8)
    emit("train_augment", part="a", batch=b, image_size=size,
         augment=aug.describe(), key=list(key), use_cut=d.mix.use_cut,
         lam=float(d.mix.lam), box_centre=[d.mix.cy, d.mix.cx],
         bit_equal=exact, mixup_max_abs_err=mix_err,
         mixup_tolerance=1e-6, rand=rand_rec,
         rand_tolerance={"atol": _RAND_ATOL,
                         "share_of_posterized": _TWO_ROUND_SHARE},
         stage_equals_ops=stage_equal, seconds=a_s,
         stage_profile={"device_busy_us_per_batch": t["busy_us"],
                        "window_us_per_batch": t["window_us"],
                        "device_idle_share": t["idle_share"],
                        "top_device_us_per_batch": t["top_us"]})
    del card, host, diff, far, src, cut_card, cut_host, mix_card, mix_host
    del chosen, staged, x_in
    torch.cuda.empty_cache()

    # (b) Trainer.fit with every op on
    steps = 20
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
    profile_b = _profile_train(trainer, state, next(iter(data)))
    emit("train_augment", part="b", config=cfg.name, batch=b,
         image_size=size, compute_dtype=cfg.model.compute_dtype,
         augment=aug.describe(), steps=steps, wall_s=wall_s,
         first_step_ms=step_ms[0], step_ms_median=median_ms,
         step_ms=step_ms, images_per_s=b / (median_ms / 1e3),
         train_step_ms_median=train_ref["step_ms_median"],
         vs_train=median_ms / train_ref["step_ms_median"],
         stage_device_us=t["busy_us"], peak_memory_bytes=peak,
         losses=losses,
         record_augment=recs[-1].get("augment"),
         lrn_launches=launches, lrn_vec_launches=vec_launches,
         profile=profile_b)
    check(all(exact.values()), f"not bit-equal across devices: {exact}")
    check(mix_err <= 1e-6, f"mixup card against CPU {mix_err}")
    check(rand_rec["far_outside_posterize"] == 0
          and rand_rec["far_elements"]
          <= _TWO_ROUND_SHARE * rand_rec["posterized_elements"],
          f"RandAugment card against CPU: {rand_rec}")
    check(stage_equal, "the stage differs from its ops")
    check(len(recs) == steps and all(math.isfinite(v) for v in losses),
          f"losses {losses}")
    check(all(r["bad_step"] == 0.0 for r in recs), "a step was skipped")
    check(recs[-1].get("augment") == aug.describe(),
          f"the record's augment block {recs[-1].get('augment')}")
    check(launches == {"fwd": 2 * steps, "bwd": 2 * steps}
          and vec_launches == launches,
          f"LRN launches {launches}, vector {vec_launches}")
    del trainer, state, data
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def cudnn_deterministic():
    """Runs its block on cuDNN's deterministic algorithms (restored
    after). cuDNN's default fp32 backward algorithms sum in an order that
    varies from run to run; through a few steps at the preset's LR on
    batch 2 (ReLU and max-pool ties) that can grow past any tolerance of
    two paths that do the same arithmetic."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def zero2_runs(tree, paths, *, steps=3, ema=0.0):
    """Phase `train_zero2` (a)'s runs (and `train_zero3` (a)'s): the
    flagship at full width in fp32 without dropout, from `tree`, `steps`
    steps on seeded u8 batches of 2, one run per name in `paths`, each
    from a fresh model: a name that starts with "zero2" takes the ZeRO-2
    step over the preset's 4 MB buckets in the one-rank group that is up,
    "zero3" the ZeRO-3 step over them, any other the replicated step;
    `ema` the EMA decay. Returns name -> the losses, the last grad norm,
    the params (gathered under ZeRO-3), the momentum, ZeRO's flat momentum
    and layout, the EMA, the LRN launches, the step's comm_meta, and after
    each step the memory allocated on the card since just before the run
    built its model (what the run holds between steps) and the bytes the
    model's parameters hold."""
    from distributed_vgg_f_tpu_torch.config import ModelConfig, get_config
    from distributed_vgg_f_tpu_torch.data.device_ingest import \
        make_device_finish
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.parallel.zero import zero_layout
    from distributed_vgg_f_tpu_torch.train.schedule import (build_optimizer,
                                                            build_schedule)
    from distributed_vgg_f_tpu_torch.train.state import TrainState
    from distributed_vgg_f_tpu_torch.train.step import build_train_step
    from distributed_vgg_f_tpu_torch.weights import load_params
    cfg = get_config("vggf_imagenet_dp")
    mesh, size = cfg.mesh, cfg.data.image_size
    zero_kw = dict(zero1=True, shard_gradients=True,
                   comm_bucket_mb=mesh.comm_bucket_mb)
    model_cfg = ModelConfig(num_classes=cfg.model.num_classes,
                            compute_dtype="float32", dropout_rate=0.0)
    rng = np.random.default_rng(4)
    batches = [{"image": rng.integers(0, 256, (2, size, size, 3), np.uint8),
                "label": rng.integers(0, cfg.model.num_classes, (2,))}
               for _ in range(steps)]
    finish = make_device_finish(cfg.data.mean_rgb, cfg.data.stddev_rgb)
    runs = {}
    for path in paths:
        zero3 = path.startswith("zero3")
        zero2 = zero3 or path.startswith("zero2")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        model = load_params(build_model(model_cfg, image_size=size),
                            tree).to("cuda")
        layout = None
        if zero2:
            layout = zero_layout(model, 1, mesh.comm_bucket_mb)
            state = TrainState.create_sharded(
                model, lambda ps: build_optimizer(cfg, ps)[0], layout,
                ema=ema > 0, shard_params=zero3)
            schedule = build_schedule(cfg)
        else:
            opt, schedule = build_optimizer(cfg, model.parameters())
            state = TrainState.create(model, opt, ema=ema > 0)
        step = build_train_step(
            schedule, cfg.optim.weight_decay, skip_nonfinite=True,
            device_finish=finish, device="cuda", ema_decay=ema,
            shard_params=zero3, **(zero_kw if zero2 else {}))
        lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
        losses, allocated, param_bytes = [], [], []
        for b in batches:
            state, metrics = step(state, b, 0)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            allocated.append(torch.cuda.memory_allocated() - base)
            param_bytes.append(sum(p.untyped_storage().nbytes()
                                   for p in model.parameters()))
        launches = (lrn_cuda.LAUNCHES, lrn_cuda.BWD_LAUNCHES)
        runs[path] = {
            "losses": losses, "grad_norm": float(metrics["grad_norm"]),
            "params": {k: v.detach().clone()
                       for k, v in state.params_tree().items()},
            "momentum": state.momentum(),
            "flat": state.momentum_global() if zero2 else None,
            "ema": (None if state.ema_params is None else
                    {k: v.clone() for k, v in
                     state.params_tree(ema=True).items()}),
            "layout": layout, "launches": launches,
            "allocated": allocated, "param_bytes": param_bytes,
            "shard_numel": (0 if state.param_shard is None
                            else state.param_shard.numel()),
            "comm_meta": dict(step.comm_meta)}
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def phase_train_zero2(tree, train_ref):
    """The flagship's ZeRO-2 exchange over 4 MB buckets on the card,
    through a one-rank NCCL group the script keeps: (a) against the
    replicated step, full width in fp32, on cuDNN's deterministic
    algorithms (`zero2_runs`); (b) in bf16 at batch 1024 with
    dropout, flip and mixup for 20 steps, timed beside phase train
    (`train_ref`). Returns (b)'s LRN launches and its step median, peak
    memory and the memory held after its steps, for `train_zero3`."""
    import dataclasses

    import torch.distributed as dist

    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.parallel.distributed import \
        initialize_distributed
    cfg = get_config("vggf_imagenet_dp")
    mesh, size = cfg.mesh, cfg.data.image_size
    check(mesh.sharding_label == "zero2" and mesh.comm_bucket_mb == 4.0,
          f"the flagship's mesh is {mesh}")
    t0 = time.perf_counter()
    up = initialize_distributed(f"localhost:{_free_port()}", 1, 0,
                                device="cuda")
    check(up and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "initialize_distributed did not start a one-rank NCCL group")
    init_s = time.perf_counter() - t0

    # (a) ZeRO-2 against the replicated step, fp32; the replicated step
    # twice: its own run-to-run bits are the control
    with cudnn_deterministic():
        runs = zero2_runs(tree, ("replicated", "replicated_again", "zero2"))
    layout = runs["zero2"]["layout"]
    rep, z2 = runs["replicated"], runs["zero2"]
    again = runs["replicated_again"]
    control = {"losses": rep["losses"] == again["losses"],
               "params": all(torch.equal(again["params"][k], v)
                             for k, v in rep["params"].items())}
    bits = {"losses": rep["losses"] == z2["losses"],
            "params": all(torch.equal(z2["params"][k], v)
                          for k, v in rep["params"].items()),
            "momentum": all(torch.equal(z2["momentum"][k], v)
                            for k, v in rep["momentum"].items())}
    param_err = max(_rel_l2(z2["params"][k], v)
                    for k, v in rep["params"].items())
    mom_err = max(_rel_l2(z2["momentum"][k], v)
                  for k, v in rep["momentum"].items())
    laid_out = layout.to_global(layout.leaves(rep["momentum"]))
    flat_err = _rel_l2(z2["flat"], laid_out)
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(z2["losses"], rep["losses"]))
    emit("train_zero2", part="a", batch=2, image_size=size, dtype="float32",
         tf32=False, cudnn_deterministic=True, steps=len(rep["losses"]),
         backend="nccl", world=1,
         init_s=init_s, comm_meta=z2["comm_meta"],
         losses_zero2=z2["losses"], losses_replicated=rep["losses"],
         grad_norm_zero2=z2["grad_norm"],
         grad_norm_replicated=rep["grad_norm"], bit_equal=bits,
         replicated_rerun_bit_equal=control,
         replicated_rerun_param_rel_l2_max=max(
             _rel_l2(again["params"][k], v) for k, v in rep["params"].items()),
         loss_rel_err=loss_err, param_rel_l2_max=param_err,
         momentum_rel_l2_max=mom_err,
         flat_momentum_vs_layout_rel_l2=flat_err,
         flat_momentum_bit_equal=bool(torch.equal(z2["flat"], laid_out)),
         lrn_launches={"replicated": rep["launches"],
                       "zero2": z2["launches"]},
         tolerance_rel_l2=1e-6)
    check(z2["launches"] == (6, 6), f"ZeRO-2 LRN launches {z2['launches']}")
    check(z2["comm_meta"]["sharding"] == "zero2"
          and z2["comm_meta"]["buckets"] == layout.num_buckets > 2,
          f"comm_meta {z2['comm_meta']}")
    check(max(loss_err, param_err, mom_err, flat_err) <= 1e-6,
          f"ZeRO-2 off the replicated step: losses {loss_err}, params "
          f"{param_err}, momentum {mom_err}, flat momentum {flat_err}")
    del runs, rep, z2, again, laid_out
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the flagship in bf16 at batch 1024 on the ZeRO-2 path
    steps = 20
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=1, seed=0))
    b = cfg.data.global_batch_size
    run = _zero_trainer_run(cfg, steps, False)
    launches, vec_launches = run["launches"], run["vec_launches"]
    losses, median_ms, meta = (run["losses"], run["step_ms_median"],
                               run["comm_meta"])
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    profile = run["profile"]
    emit("train_zero2", part="b", config=cfg.name, image_size=size, batch=b,
         compute_dtype=cfg.model.compute_dtype,
         dropout_rate=cfg.model.dropout_rate,
         augment={"hflip": cfg.data.augment.hflip,
                  "mixup_alpha": cfg.data.augment.mixup_alpha},
         steps=steps, wall_s=run["wall_s"], first_step_ms=run["step_ms"][0],
         step_ms_median=median_ms, step_ms=run["step_ms"],
         images_per_s=b / (median_ms / 1e3),
         train_step_ms_median=train_ref["step_ms_median"],
         vs_train=median_ms / train_ref["step_ms_median"] - 1.0,
         peak_memory_bytes=run["peak_memory_bytes"],
         resident_bytes=run["resident_bytes"], losses=losses,
         loss_first5_mean=first, loss_last5_mean=last,
         lrn_launches=launches, lrn_vec_launches=vec_launches,
         buckets=meta["buckets"], wire_bytes=meta["wire_bytes"],
         comm_meta=meta, train_copy_us_per_step=train_ref["copy_us_per_step"],
         profile=profile)
    check(run["steps_taken"] == steps + profile["steps"]
          and len(losses) == steps,
          f"{run['steps_taken']} steps, {len(losses)} records")
    check(launches == {"fwd": 2 * steps, "bwd": 2 * steps}
          and vec_launches == launches,
          f"LRN launches {launches} (vector {vec_launches}) over {steps} "
          "steps, expected 2 forward and 2 backward a step, all vector")
    check(meta["sharding"] == "zero2" and meta["bucketed"],
          f"comm_meta {meta}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(run["bad_steps"] == 0, "a step was skipped")
    check(last < first, f"loss did not fall on a fixed batch: mean of the "
          f"first 5 steps {first}, of the last 5 {last}")
    return launches, run


def _zero_trainer_run(cfg, steps, shard_params):
    """Phases `train_zero2` (b)'s and `train_zero3` (b)'s run: the
    flagship preset (bf16, dropout, flip, mixup) through `Trainer.fit` on
    its seeded u8 batch with the ZeRO-2 step over its 4 MB buckets built
    here (the trainer downgrades ZeRO at one rank), ZeRO-3 with
    `shard_params`. Returns the wall and step ms, the losses, the LRN
    launches (counted over the fit only), the peak memory, the memory held
    after the fit since just before the Trainer was built (the state's,
    `resident_bytes`) and the bytes the parameters hold then, comm_meta
    and a profile of 3 more steps."""
    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.parallel.zero import zero_layout
    from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
    from distributed_vgg_f_tpu_torch.train.state import TrainState
    from distributed_vgg_f_tpu_torch.train.step import build_train_step
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    mesh, size = cfg.mesh, cfg.data.image_size
    b = cfg.data.global_batch_size
    data = SyntheticU8(b, size, cfg.model.num_classes, seed=0, pin=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    stamps = []
    trainer = Trainer(cfg, log=lambda event, rec: stamps.append(
        time.perf_counter()))
    trainer.train_step = build_train_step(
        trainer.schedule, cfg.optim.weight_decay,
        grad_clip_norm=cfg.optim.grad_clip_norm,
        ema_decay=cfg.train.ema_decay,
        skip_nonfinite=cfg.train.skip_nonfinite,
        device_finish=trainer.device_finish,
        device_augment=trainer.device_augment, device="cuda", zero1=True,
        shard_gradients=True, shard_params=shard_params,
        comm_bucket_mb=mesh.comm_bucket_mb)
    model = trainer.init_state(0).model
    state = TrainState.create_sharded(
        model, lambda ps: build_optimizer(cfg, ps)[0],
        zero_layout(model, 1, mesh.comm_bucket_mb),
        ema=cfg.train.ema_decay > 0, shard_params=shard_params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
    lrn_cuda.VEC_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    state = trainer.fit(state, data, num_steps=steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fwd": lrn_cuda.LAUNCHES, "bwd": lrn_cuda.BWD_LAUNCHES}
    vec = {"fwd": lrn_cuda.VEC_LAUNCHES, "bwd": lrn_cuda.VEC_BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated() - base
    param_bytes = sum(p.untyped_storage().nbytes()
                      for p in model.parameters())
    recs = [r for r in trainer.records if r["event"] == "train"]
    stamps.insert(0, t0)
    step_ms = [(t1 - t0_) * 1e3 for t0_, t1 in zip(stamps, stamps[1:])]
    out = {"wall_s": wall_s, "step_ms": step_ms,
           "step_ms_median": statistics.median(step_ms[4:]),
           "losses": [r["loss"] for r in recs],
           "bad_steps": sum(r["bad_step"] for r in recs),
           "launches": launches, "vec_launches": vec,
           "peak_memory_bytes": peak, "resident_bytes": resident,
           "param_storage_bytes": param_bytes,
           "comm_meta": dict(trainer.train_step.comm_meta)}
    out["profile"] = _profile_train(trainer, state, next(iter(data)))
    out["steps_taken"] = state.step
    del trainer, state, data, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_zero3(tree, zero2_ref):
    """The flagship's ZeRO-3 (`mesh.shard_params`) over the preset's 4 MB
    buckets on the card, in the one-rank NCCL group phase `train_zero2`
    started: (a) against ZeRO-2 in fp32 at batch 2 with the EMA, on
    cuDNN's deterministic algorithms (`zero2_runs`); (b) in bf16 at batch
    1024 with dropout, flip and mixup for 20 steps, beside
    `train_zero2` (b) (`zero2_ref`). Returns (b)'s LRN launches."""
    import dataclasses

    import torch.distributed as dist

    from distributed_vgg_f_tpu_torch.config import (apply_overrides,
                                                     get_config)
    cfg = apply_overrides(get_config("vggf_imagenet_dp"),
                          {"mesh.shard_params": "true"})
    check(cfg.mesh.sharding_label == "zero3",
          f"--set mesh.shard_params=true gives {cfg.mesh}")
    check(dist.is_initialized() and dist.get_world_size() == 1,
          "train_zero3 runs in train_zero2's one-rank group")

    # (a) ZeRO-3 against ZeRO-2, fp32, both keeping the EMA
    ema = 0.99
    with cudnn_deterministic():
        runs = zero2_runs(tree, ("zero2", "zero3"), ema=ema)
    z2, z3 = runs["zero2"], runs["zero3"]
    layout = z3["layout"]
    bits = {"losses": z2["losses"] == z3["losses"],
            "grad_norm": z2["grad_norm"] == z3["grad_norm"],
            "params": all(torch.equal(z3["params"][k], v)
                          for k, v in z2["params"].items()),
            "flat_momentum": bool(torch.equal(z3["flat"], z2["flat"])),
            "ema": all(torch.equal(z3["ema"][k], v)
                       for k, v in z2["ema"].items())}
    param_fp32_bytes = 4 * sum(v.numel() for v in z2["params"].values())
    saved = [a - b for a, b in zip(z2["allocated"], z3["allocated"])]
    meta = z3["comm_meta"]
    emit("train_zero3", part="a", batch=2, image_size=cfg.data.image_size,
         dtype="float32", tf32=False, cudnn_deterministic=True,
         steps=len(z3["losses"]), backend="nccl", world=1, ema_decay=ema,
         comm_meta=meta, buckets=layout.num_buckets,
         losses_zero3=z3["losses"], losses_zero2=z2["losses"],
         bit_equal=bits, param_storage_bytes_between_steps=z3["param_bytes"],
         shard_numel=z3["shard_numel"],
         allocated_zero2=z2["allocated"], allocated_zero3=z3["allocated"],
         allocated_saved=saved, param_fp32_bytes=param_fp32_bytes,
         lrn_launches={"zero2": z2["launches"], "zero3": z3["launches"]})
    check(all(bits.values()), f"ZeRO-3 off ZeRO-2's bits: {bits}")
    check(z3["param_bytes"] == [0] * len(z3["losses"]),
          f"parameters hold storage between steps: {z3['param_bytes']}")
    check(z3["shard_numel"] == layout.total_padded,
          f"a shard of {z3['shard_numel']} elements at one rank")
    # the allocator may keep up to 1 MiB of a block it does not split, so
    # ZeRO-3 saves the parameters' bytes to within that a tensor
    slack = (2 * len(layout.keys) + 4) << 20
    check(all(abs(d - param_fp32_bytes) <= slack for d in saved),
          f"ZeRO-3 holds {saved} bytes less than ZeRO-2 between steps; "
          f"the parameters are {param_fp32_bytes}")
    check(meta["sharding"] == "zero3" and meta["bucketed"]
          and meta["gathers"] == meta["buckets"] == layout.num_buckets > 2,
          f"comm_meta {meta}")
    check(z3["launches"] == (6, 6), f"ZeRO-3 LRN launches {z3['launches']}")
    del runs, z2, z3
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the flagship in bf16 at batch 1024 on the ZeRO-3 path
    steps = 20
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=1, seed=0))
    run = _zero_trainer_run(cfg, steps, True)
    launches, recs_meta = run["launches"], run["comm_meta"]
    losses = run["losses"]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    b = cfg.data.global_batch_size
    emit("train_zero3", part="b", config=cfg.name, batch=b,
         image_size=cfg.data.image_size,
         compute_dtype=cfg.model.compute_dtype,
         dropout_rate=cfg.model.dropout_rate, ema_decay=cfg.train.ema_decay,
         augment={"hflip": cfg.data.augment.hflip,
                  "mixup_alpha": cfg.data.augment.mixup_alpha},
         steps=steps, first_step_ms=run["step_ms"][0],
         step_ms_median=run["step_ms_median"], step_ms=run["step_ms"],
         images_per_s=b / (run["step_ms_median"] / 1e3),
         zero2_step_ms_median=zero2_ref["step_ms_median"],
         vs_zero2=run["step_ms_median"] / zero2_ref["step_ms_median"] - 1.0,
         peak_memory_bytes=run["peak_memory_bytes"],
         zero2_peak_memory_bytes=zero2_ref["peak_memory_bytes"],
         resident_bytes=run["resident_bytes"],
         zero2_resident_bytes=zero2_ref["resident_bytes"],
         param_storage_bytes=run["param_storage_bytes"],
         losses=losses, loss_first5_mean=first, loss_last5_mean=last,
         lrn_launches=launches, lrn_vec_launches=run["vec_launches"],
         comm_meta=recs_meta, profile=run["profile"])
    check(run["steps_taken"] == steps + run["profile"]["steps"]
          and len(losses) == steps, f"{run['steps_taken']} steps, "
          f"{len(losses)} records")
    check(launches == {"fwd": 2 * steps, "bwd": 2 * steps}
          and run["vec_launches"] == launches,
          f"LRN launches {launches} (vector {run['vec_launches']}) over "
          f"{steps} steps, expected 2 forward and 2 backward a step")
    check(recs_meta["sharding"] == "zero3"
          and recs_meta["gathers"] == recs_meta["buckets"] > 2,
          f"comm_meta {recs_meta}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(run["bad_steps"] == 0, "a step was skipped")
    check(last < first, f"loss did not fall on a fixed batch: mean of the "
          f"first 5 steps {first}, of the last 5 {last}")
    check(run["param_storage_bytes"] == 0,
          "parameters hold storage after the fit")
    check(run["resident_bytes"] < zero2_ref["resident_bytes"],
          f"ZeRO-3 holds {run['resident_bytes']} bytes after its fit, "
          f"ZeRO-2 {zero2_ref['resident_bytes']}")
    return launches


# ------------------------------------------------------------ the feed
#: the fixture JPEGs phase train_feed packs into TFRecords
_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "jpeg_fixture")


def _pack_fixture(out_dir, shards=4, per_shard=1024):
    """The fixture's JPEGs repeated into `shards` TFRecord shards of
    `per_shard` records (1-based labels, one per image)."""
    from tools.tfrecord_write import write_shards
    paths = sorted(f for f in os.listdir(_FIXTURE) if f.endswith(".jpg"))
    check(len(paths) == 16, f"fixture holds {len(paths)} JPEGs")
    jpegs = []
    for f in paths:
        with open(os.path.join(_FIXTURE, f), "rb") as fh:
            jpegs.append(fh.read())
    labels = [1 + (61 * k) % 1000 for k in range(len(jpegs))]
    return write_shards(out_dir, jpegs, labels, shards=shards,
                        per_shard=per_shard)


def _h2d_overlap(prof, count):
    """From a torch.profiler run over `count` steps: the device µs a step
    of the pinned host-to-device copies (the feed's; the step's own small
    uploads are pageable), and the share of that copy time during which a
    kernel ran on the card."""
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [(e.time_range.start, e.time_range.end) for e in device
              if "HtoD" in e.name and "Pinned" in e.name]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in device
                     if "Memcpy" not in e.name and "Memset" not in e.name)
    merged = []
    for s0, e0 in kernels:
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e0)
        else:
            merged.append([s0, e0])
    copy_us = sum(e0 - s0 for s0, e0 in copies)
    overlap_us = sum(max(0, min(e0, e1) - max(s0, s1))
                     for s0, e0 in copies for s1, e1 in merged)
    return {"h2d_copies": len(copies), "h2d_us_per_step": copy_us / count,
            "h2d_overlap_share": overlap_us / copy_us if copy_us else None}


def phase_train_feed(train_ref, tmp):
    """The flagship's host-to-card training feed: the fixture packed into
    4 TFRecord shards of 1024 records in `tmp` (the caller deletes it),
    then Trainer.fit(state, num_steps=20) with data.data_dir there — the
    native index and decode on the u8 wire, the pinned ring, the H2D copy
    on the prefetcher's side stream — timed beside phase train
    (`train_ref`); the decoder alone; 4 prefetched batches against a CPU
    decode of the same cursors; a profile of 3 steps through a live feed.
    Returns the LRN launches of the fit."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.data import native_jpeg, native_tfrecord
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.telemetry import get_registry
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("vggf_imagenet_dp")
    steps = 20
    t0 = time.perf_counter()
    files = _pack_fixture(tmp)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_tfrecord.load_native_tfrecord()
    native_jpeg.load_native_jpeg()
    native_build_s = time.perf_counter() - t0
    with open("/proc/self/maps") as maps:
        libjpeg = sorted({os.path.basename(line.split()[-1])
                          for line in maps if "libjpeg" in line})
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_dir=tmp),
        train=dataclasses.replace(cfg.train, log_every=1, seed=0))
    b = cfg.data.global_batch_size
    stamps = []
    trainer = Trainer(cfg, log=lambda event, rec: stamps.append(
        time.perf_counter()) if event == "train" else None)
    state = trainer.init_state(0)

    # the decoder alone: 8 batches drained into a pinned buffer, at
    # the config's thread count (0: min(8, CPUs))
    images = torch.empty((b, cfg.data.image_size, cfg.data.image_size,
                          3), dtype=torch.uint8, pin_memory=True)
    labels = torch.empty((b,), dtype=torch.int32, pin_memory=True)
    src = trainer.make_dataset("train")
    src.next_into(images, labels)  # starts the decode threads
    t0 = time.perf_counter()
    for _ in range(8):
        src.next_into(images, labels)
    decode_rate = 8 * b / (time.perf_counter() - t0)
    threads = src.num_threads()
    src.close()
    del images, labels

    reg = get_registry()
    wait0 = reg.counter_value("prefetch/wait_ns", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
    lrn_cuda.VEC_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    state = trainer.fit(state, num_steps=steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fwd": lrn_cuda.LAUNCHES, "bwd": lrn_cuda.BWD_LAUNCHES}
    vec_launches = {"fwd": lrn_cuda.VEC_LAUNCHES,
                    "bwd": lrn_cuda.VEC_BWD_LAUNCHES}
    wait_ns = reg.counter_value("prefetch/wait_ns", 0) - wait0
    decode_errors = trainer.ingest.decode_errors()
    peak = torch.cuda.max_memory_allocated()
    recs = [r for r in trainer.records if r["event"] == "train"]
    losses = [r["loss"] for r in recs]
    stamps.insert(0, t0)
    step_ms = [(t1 - t0_) * 1e3 for t0_, t1 in zip(stamps, stamps[1:])]
    median_ms = statistics.median(step_ms[4:])

    # 4 batches through the prefetcher at cursors 20..23, its side
    # stream stalled 2 s before its first copy and the consumer's
    # stream slowed after each batch, against a CPU-only decode of
    # the same cursors: a slot reused before its copy, or device
    # memory handed back before the step read it, shows here
    start = state.step
    ingest, feed = trainer.open_feed(start)
    with torch.cuda.stream(feed.stream):
        torch.cuda._sleep(int(2.0 * _SLEEP_HZ))
    got = []
    for _ in range(4):
        batch = next(feed)
        torch.cuda._sleep(int(0.1 * _SLEEP_HZ))
        got.append({k: v.clone() for k, v in batch.items()})
        del batch
    torch.cuda.synchronize()
    feed.close()
    ingest.close()
    ref_src = trainer.make_dataset("train")
    check(ref_src.restore_state(start), "the CPU decode did not seek")
    want = [next(ref_src) for _ in range(4)]
    ref_src.close()
    byte_equal = [
        bool(torch.equal(g["image"].cpu(), torch.from_numpy(w["image"]))
             and torch.equal(g["label"].cpu(),
                             torch.from_numpy(w["label"])))
        for g, w in zip(got, want)]
    del got, want

    # where a step's time goes through a live feed: 3 steps after 3
    ingest, feed = trainer.open_feed(state.step)
    for _ in range(3):
        state, _ = trainer.train_step(state, next(feed), cfg.train.seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = trainer.train_step(state, next(feed),
                                          cfg.train.seed)
        torch.cuda.synchronize()
    feed.close()
    ingest.close()
    t = _trace_breakdown(prof, 3, top=15)
    h2d = _h2d_overlap(prof, 3)
    del trainer, state
    gc.collect()
    synthetic = _feed_synthetic(cfg)
    emit("train_feed", config=cfg.name, image_size=cfg.data.image_size,
         batch=b, source={"jpegs": 16, "shards": len(files),
                          "records_per_shard": 1024, "pixels": "500x375",
                          "quality": 90},
         pack_s=pack_s, native_build_s=native_build_s, libjpeg=libjpeg,
         cpu_count=os.cpu_count(), native_threads=threads,
         decode_only_images_per_s=decode_rate, decode_only_batches=8,
         steps=steps, wall_s=wall_s, first_step_ms=step_ms[0],
         step_ms_median=median_ms, step_ms=step_ms,
         images_per_s=b / (median_ms / 1e3),
         train_step_ms_median=train_ref["step_ms_median"],
         train_images_per_s=b / (train_ref["step_ms_median"] / 1e3),
         vs_train=median_ms / train_ref["step_ms_median"] - 1.0,
         host_wait_fraction=recs[-1]["host_wait_fraction"],
         prefetch_wait_ns_per_step=wait_ns / steps,
         prefetch_to_device=cfg.train.prefetch_to_device,
         decode_errors=decode_errors, peak_memory_bytes=peak,
         losses=losses, lrn_launches=launches,
         lrn_vec_launches=vec_launches, byte_equal_cursors=list(
             range(start, start + 4)), byte_equal=byte_equal,
         profile={"steps": 3, "window_us_per_step": t["window_us"],
                  "device_busy_us_per_step": t["busy_us"],
                  "device_idle_share": t["idle_share"],
                  "copy_us_per_step": t["copy_us"], **h2d,
                  "top_device_us_per_step": t["top_us"]},
         synthetic_source=synthetic)
    check(len(recs) == steps, f"{len(recs)} records over {steps} steps")
    check(launches == {"fwd": 2 * steps, "bwd": 2 * steps}
          and vec_launches == launches,
          f"LRN launches {launches} (vector {vec_launches}) over {steps} "
          "steps, expected 2 forward and 2 backward a step, all vector")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(decode_errors == 0, f"{decode_errors} decode errors")
    check(all(byte_equal), f"prefetched batches against the CPU decode of "
          f"the same cursors: {byte_equal}")
    check(all(math.isfinite(v) for v in synthetic["losses"]),
          f"synthetic-source losses {synthetic['losses']}")
    torch.cuda.empty_cache()
    return launches, median_ms


def _feed_synthetic(cfg, steps=20):
    """The same trainer-owned feed with `data.name="synthetic"`: phase
    train's seeded batch drawn through the prefetcher (copied into its
    pinned ring, then H2D on its side stream), where the host keeps up —
    whether the side stream hides the copy under the step. Step ms over
    `steps` steps and a profile of 3 through a live feed."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, name="synthetic"))
    stamps = []
    trainer = Trainer(cfg, log=lambda event, rec: stamps.append(
        time.perf_counter()) if event == "train" else None)
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.fit(state, num_steps=steps)
    torch.cuda.synchronize()
    recs = [r for r in trainer.records if r["event"] == "train"]
    stamps.insert(0, t0)
    step_ms = [(t1 - t0_) * 1e3 for t0_, t1 in zip(stamps, stamps[1:])]
    ingest, feed = trainer.open_feed(state.step)
    for _ in range(3):
        state, _ = trainer.train_step(state, next(feed), cfg.train.seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = trainer.train_step(state, next(feed), cfg.train.seed)
        torch.cuda.synchronize()
    feed.close()
    ingest.close()
    t = _trace_breakdown(prof, 3, top=5)
    out = {"steps": steps, "step_ms_median": statistics.median(step_ms[4:]),
           "step_ms": step_ms,
           "images_per_s": cfg.data.global_batch_size
           / (statistics.median(step_ms[4:]) / 1e3),
           "host_wait_fraction": recs[-1]["host_wait_fraction"],
           "losses": [r["loss"] for r in recs],
           "profile": {"window_us_per_step": t["window_us"],
                       "device_busy_us_per_step": t["busy_us"],
                       "device_idle_share": t["idle_share"],
                       **_h2d_overlap(prof, 3)}}
    del trainer, state
    gc.collect()
    return out


def _largest_file(root):
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
    return max(files, key=os.path.getsize)


def _same_tree(got, want):
    """Names whose tensors differ in any bit (CPU copies)."""
    if set(got) != set(want):
        return sorted(set(got) ^ set(want))
    return [k for k in want if not torch.equal(got[k], want[k])]


def phase_train_ckpt(train_step_ms, feed_step_ms, feed_dir, smi):
    """Checkpoint and resume of the flagship on its TFRecord feed
    (`feed_dir`, phase train_feed's shards), cuDNN deterministic for this
    phase only: (a) Trainer.fit(num_steps=10) with a checkpoint directory
    in a temp dir and checkpoint_every_steps=5 (saves at 1, the first, 5,
    and the forced 10 with its wait()); (b) the D2H copy of a save on the
    compute stream, timed with CUDA events, with and without allocating
    the pinned buffers, and the time until the save's manifest is on
    disk, without a wait(); (c) a fresh Trainer's restore_or_init() held
    bit for bit to the live state at the save and to its iterator blob,
    then (e) its fit to 15, held bit for bit against an uninterrupted run
    of 15; (d) one byte of step 10's largest file flipped, and a fresh
    Trainer falls back to step 5; (f) 20 steps on phase train's fixed
    batch with checkpoint_every_steps=10, the step times beside phase
    train's (`train_step_ms`). Returns the LRN launches of (a) and (e).
    """
    import dataclasses
    import shutil
    import tempfile

    from distributed_vgg_f_tpu_torch.checkpoint.manager import \
        CheckpointManager
    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.resilience.integrity import (
        list_manifest_steps, step_dir, step_size_bytes, verify_step_manifest)
    from distributed_vgg_f_tpu_torch.telemetry import get_recorder
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = get_config("vggf_imagenet_dp")
    base = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_dir=feed_dir),
        train=dataclasses.replace(cfg.train, log_every=1, seed=0))
    b = cfg.data.global_batch_size
    root = tempfile.mkdtemp(prefix="train_ckpt_")
    ck_cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, checkpoint_dir=os.path.join(root, "ck"),
        checkpoint_every_steps=5))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def timed_trainer(c):
        stamps = []
        tr = Trainer(c, log=lambda event, rec: stamps.append(
            (rec["step"], time.perf_counter())) if event == "train" else None)
        return tr, stamps

    def spans(name, since):
        return [d / 1e6 for n, _, t0, d, *_ in get_recorder().snapshot()
                if n == name and t0 >= since]

    def step_ms(stamps, t0):
        prev, out = t0, {}
        for step, t in stamps:
            out[step] = (t - prev) * 1e3
            prev = t
        return out

    def cpu_tree(state):
        return {k: v.detach().cpu().clone()
                for k, v in state.checkpoint_tree().items()}

    def counts():
        return {"fwd": lrn_cuda.LAUNCHES, "bwd": lrn_cuda.BWD_LAUNCHES,
                "vec_fwd": lrn_cuda.VEC_LAUNCHES,
                "vec_bwd": lrn_cuda.VEC_BWD_LAUNCHES}

    def zero_counts():
        lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
        lrn_cuda.VEC_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0

    try:
        # (a) 10 steps with checkpoints
        extras, saves = {}, []

        def record_saves(trainer):
            mgr, save = trainer.checkpoints, trainer.checkpoints.save

            def recorded_save(state, extra=None, **kw):
                t0 = time.perf_counter()
                taken = save(state, extra=extra, **kw)
                if taken and "wait_s" in mgr.timings:
                    extras[state.step] = json.loads(json.dumps(extra))
                    saves.append({
                        "step": state.step,
                        "save_ms": (time.perf_counter() - t0) * 1e3,
                        "wait_ms": mgr.timings.pop("wait_s") * 1e3,
                        "snapshot_ms": mgr.timings["snapshot_s"] * 1e3})
                return taken

            mgr.save = recorded_save

        a, stamps_a = timed_trainer(ck_cfg)
        record_saves(a)
        torch.cuda.synchronize()
        since = time.monotonic_ns()
        zero_counts()
        t0 = time.perf_counter()
        state_a = a.fit(num_steps=10)
        torch.cuda.synchronize()
        fit_a_s = time.perf_counter() - t0
        launches_a = counts()
        live = cpu_tree(state_a)
        ms_a = step_ms(stamps_a, t0)
        dispatch_ms = spans("checkpoint_save_dispatch", since)
        wait_ms = spans("checkpoint_wait", since)
        timings_a = dict(a.checkpoints.timings)
        steps_a = a.checkpoints.all_steps()
        bytes_step = step_size_bytes(ck_cfg.train.checkpoint_dir, 10)
        # fp32 params and momentum, 4 bytes each
        state_bytes = 8 * sum(p.numel() for p in state_a.model.parameters())
        losses_a = [r["loss"] for r in a.records if r["event"] == "train"]

        # (b) the snapshot's D2H copy on the compute stream, device time,
        # and the manifest that the writer leaves without a wait()
        d2h, probe_dir = {}, os.path.join(root, "d2h")
        probe = CheckpointManager(probe_dir, max_to_keep=1)
        for i, label in enumerate(("allocating", "reused")):
            tree = dict(state_a.checkpoint_tree())
            tree["step"] = torch.tensor(100 + i, dtype=torch.int32)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            check(probe.save(tree, force=True), "the probe save was dropped")
            ev1.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            ev1.synchronize()
            while (100 + i not in list_manifest_steps(probe_dir)
                   and time.perf_counter() - t0 < 120):
                time.sleep(0.005)
            manifest_s = time.perf_counter() - t0
            d2h[label] = {"device_ms": ev0.elapsed_time(ev1),
                          "dispatch_ms": host_ms,
                          "manifest_on_disk_s": manifest_s,
                          "manifest_verdict": verify_step_manifest(
                              probe_dir, 100 + i)[0]}
            probe.wait()
        d2h["write_s"] = probe.timings.get("write_s")
        d2h["manifest_s"] = probe.timings.get("manifest_s")
        d2h["gb_per_s"] = bytes_step / 1e9 / (d2h["reused"]["device_ms"]
                                              / 1e3)
        probe.close()
        shutil.rmtree(os.path.join(root, "d2h"), ignore_errors=True)
        del probe, tree
        a.checkpoints.close()
        del a, state_a

        # (c) a fresh Trainer restores; the manager's verify and read alone
        reader = CheckpointManager(ck_cfg.train.checkpoint_dir)
        t0 = time.perf_counter()
        check(reader.best_step() == 10, "step 10 is not the newest intact")
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reader.restore(10)
        read_s = time.perf_counter() - t0
        del reader
        bt, stamps_b = timed_trainer(ck_cfg)
        record_saves(bt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_b = bt.restore_or_init()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_diff = _same_tree(cpu_tree(state_b), live)
        blob_equal = (bt._restored_iterator_state
                      == extras[10].get("iterator_state"))

        # (d) the newest step damaged: a fresh Trainer falls back
        damaged = _largest_file(step_dir(ck_cfg.train.checkpoint_dir, 10))
        with open(damaged, "r+b") as f:
            f.seek(os.path.getsize(damaged) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0x01]))
        dt = Trainer(ck_cfg)
        state_d = dt.restore_or_init()
        fallback_step = state_d.step
        fallback = [r for r in dt.records
                    if r["event"] == "checkpoint_integrity_fallback"]
        dt.checkpoints.close()
        del dt, state_d

        # (e) the resumed run to 15, then an uninterrupted one
        since = time.monotonic_ns()
        zero_counts()
        t0 = time.perf_counter()
        state_b = bt.fit(state_b, num_steps=15)
        torch.cuda.synchronize()
        launches_b = counts()
        ms_b = step_ms(stamps_b, t0)
        dispatch_ms_b = spans("checkpoint_save_dispatch", since)
        resume_events = [r for r in bt.records if r["event"] != "train"]
        losses_b = [r["loss"] for r in bt.records if r["event"] == "train"]
        resumed = cpu_tree(state_b)
        bt.checkpoints.close()
        del bt, state_b
        ct = Trainer(base)
        state_c = ct.fit(num_steps=15)
        torch.cuda.synchronize()
        straight = cpu_tree(state_c)
        losses_c = [r["loss"] for r in ct.records if r["event"] == "train"]
        del ct, state_c
        shutil.rmtree(ck_cfg.train.checkpoint_dir, ignore_errors=True)

        # (f) phase train's fixed batch, a save every 10 steps
        torch.backends.cudnn.deterministic = deterministic
        f_cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, checkpoint_dir=os.path.join(root, "f"),
            checkpoint_every_steps=10))
        ft, stamps_f = timed_trainer(f_cfg)
        data = SyntheticU8(b, cfg.data.image_size, cfg.model.num_classes,
                           seed=0, pin=True)
        state_f = ft.init_state(0)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        state_f = ft.fit(state_f, data, num_steps=20)
        torch.cuda.synchronize()
        launches_f = counts()
        ms_f = step_ms(stamps_f, t0)
        steps_f = ft.checkpoints.all_steps()
        losses_f = [r["loss"] for r in ft.records if r["event"] == "train"]
        ft.checkpoints.close()
        del ft, state_f, data
        gc.collect()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    resume_diff = _same_tree(resumed, straight)
    max_rel = max(float((resumed[k].double() - straight[k].double()).norm()
                        / max(float(straight[k].double().norm()), 1e-30))
                  for k in straight if straight[k].is_floating_point())
    # the steps whose interval holds a save's dispatch: the cadence's
    with_save = {s: ms for s, ms in list(ms_a.items()) + list(ms_b.items())
                 if s == 1 or s % 5 == 0}
    no_save = [ms for s, ms in list(ms_a.items()) + list(ms_b.items())
               if s not in with_save and s != 11]
    f_with_save = {s: ms for s, ms in ms_f.items() if s in (1, 10, 20)}
    f_no_save = [ms for s, ms in ms_f.items()
                 if s >= 5 and s not in f_with_save]
    emit("train_ckpt", card=smi, config=cfg.name, batch=b,
         image_size=cfg.data.image_size, checkpoint_every_steps=5,
         cudnn_deterministic=True, fit_s=fit_a_s, saved_steps=steps_a,
         save_steps=sorted(extras),
         step_ms={"a": ms_a, "b": ms_b}, step_ms_with_save=with_save,
         step_ms_without_save_median=statistics.median(no_save),
         train_feed_step_ms_median=feed_step_ms,
         save_dispatch_ms=dispatch_ms + dispatch_ms_b, saves=saves,
         d2h=d2h, writer_s=timings_a.get("write_s"),
         manifest_s=timings_a.get("manifest_s"),
         final_wait_ms=wait_ms[-1] if wait_ms else None,
         restore_s=restore_s, restore_verify_s=verify_s,
         restore_read_s=read_s, bytes_per_step=bytes_step,
         state_bytes=state_bytes,
         restored_bit_equal=not restored_diff, restored_diff=restored_diff,
         blob_equal=blob_equal, resume_events=resume_events,
         resumed_bit_equal=not resume_diff, resumed_diff=resume_diff[:8],
         resumed_max_rel_l2=max_rel, losses_resumed=losses_b,
         losses_straight=losses_c, losses_first=losses_a,
         fallback_step=fallback_step, fallback=fallback,
         damaged_file=os.path.relpath(damaged, root),
         fixed_batch={"step_ms": ms_f, "step_ms_with_save": f_with_save,
                      "step_ms_without_save_median":
                      statistics.median(f_no_save),
                      "train_step_ms_median": train_step_ms,
                      "saved_steps": steps_f, "lrn_launches": launches_f},
         lrn_launches={"fit_0_10": launches_a, "fit_10_15": launches_b})
    check(steps_a == [1, 5, 10], f"steps on disk after the fit: {steps_a}")
    check(not restored_diff, f"restored state differs in {restored_diff}")
    check(blob_equal, "the restored iterator blob is not the saved one")
    check(any(e["event"] == "iterator_state_restore"
              and e["replayed_batches"] == 0 for e in resume_events),
          f"the resume did not go through the blob: {resume_events}")
    check(not resume_diff and losses_b == losses_c[10:],
          f"resumed run differs from the uninterrupted one in "
          f"{resume_diff[:8]} (max rel L2 {max_rel}); losses {losses_b} "
          f"against {losses_c[10:]}")
    check(fallback_step == 5 and fallback
          and fallback[0]["chosen"] == 5,
          f"damaged step 10 restored step {fallback_step}, {fallback}")
    check(0 <= bytes_step - state_bytes < 1e6,
          f"{bytes_step} bytes on disk a step for {state_bytes} of state")
    check(all(d2h[k]["manifest_verdict"] is True
              for k in ("allocating", "reused")),
          f"a save's manifest was not on disk and intact before wait(): "
          f"{d2h}")
    both = {k: launches_a[k] + launches_b[k] for k in launches_a}
    check(both == {"fwd": 30, "bwd": 30, "vec_fwd": 30, "vec_bwd": 30},
          f"LRN launches {both} over 15 steps, expected 2 + 2 a step, "
          "every one of the vector variant")
    check(launches_f == {"fwd": 40, "bwd": 40, "vec_fwd": 40, "vec_bwd": 40},
          f"LRN launches {launches_f} over (f)'s 20 steps")
    check(steps_f == [1, 10, 20], f"(f) saved {steps_f}")
    check(all(math.isfinite(v) for v in losses_a + losses_b + losses_f),
          "non-finite loss")
    torch.cuda.empty_cache()
    return both


def _pack_validation(out_dir, records=1200):
    """`records` validation records of the fixture's JPEGs (the labels of
    `_pack_fixture`) in 2 shards: 1024 + 176 at the flagship's batch."""
    from tools.tfrecord_write import write_shards
    paths = sorted(f for f in os.listdir(_FIXTURE) if f.endswith(".jpg"))
    jpegs = []
    for f in paths:
        with open(os.path.join(_FIXTURE, f), "rb") as fh:
            jpegs.append(fh.read())
    labels = [1 + (61 * k) % 1000 for k in range(len(jpegs))]
    return write_shards(out_dir, jpegs, labels, shards=2,
                        per_shard=records // 2, prefix="validation")


def phase_train_e2e(feed_dir, train_step_ms, feed_step_ms, smi):
    """The flagship end to end through the command line, in this process
    (cli.main(argv)), on phase train_feed's shards plus 1200 validation
    records in `feed_dir`, at base_lr 0.001 (the preset's LR diverges on
    the 16-image fixture, in fp32 without dropout, flip and mixup too:
    tools/torch_flagship_probe.py): (a) train to 30 with an eval every 10, a record
    every 5 and a checkpoint every 10, stopped by SIGTERM from a thread
    once a record of step >= 12 is on disk and the next step dispatched
    (a preempt record at the next completed step, its forced save); (b) a
    second main() resumes through the iterator blob and runs to 30 (evals
    at 20 and 30); (c) --mode eval
    (its counts equal the in-fit eval at 30), --mode eval from the best
    slot (its eval_top1 the slot's recorded score), --mode predict on the
    16 fixture JPEGs (top-1 equal to the eval forward's on the restored
    weights, or a class whose bf16 logit ties its largest; each full
    probability row sums to 1); (d) metrics.jsonl
    valid under telemetry/schema.py. LRN counts are zeroed before (a) and
    read after (c)'s predict. cuDNN deterministic for this phase only.
    Returns the LRN launches."""
    import contextlib
    import io
    import signal

    from distributed_vgg_f_tpu_torch import cli
    from distributed_vgg_f_tpu_torch.checkpoint.manager import \
        CheckpointManager
    from distributed_vgg_f_tpu_torch.config import parse_cli
    from distributed_vgg_f_tpu_torch.data.native_jpeg import \
        NativeJpegEvalIterator
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.telemetry import get_recorder
    from distributed_vgg_f_tpu_torch.telemetry.schema import \
        validate_metrics_jsonl
    from distributed_vgg_f_tpu_torch.train import predict as predict_mod
    from distributed_vgg_f_tpu_torch.train import trainer as trainer_mod

    _pack_validation(feed_dir)
    root = tempfile.mkdtemp(prefix="train_e2e_")
    ck = os.path.join(root, "ck")
    jsonl = os.path.join(ck, "metrics.jsonl")
    argv = ["--config", "vggf_imagenet_dp",
            "--set", f"data.data_dir={feed_dir}",
            "--set", f"train.checkpoint_dir={ck}",
            "--set", "train.steps=30", "--set", "train.eval_every_steps=10",
            "--set", "train.log_every=5",
            "--set", "train.checkpoint_every_steps=10",
            "--set", "train.seed=0",
            # the preset's LR (0.04, no warmup) diverges on the 16-image
            # fixture, in fp32 without dropout, flip and mixup as well
            # (tools/torch_flagship_probe.py part lr)
            "--set", "optim.base_lr=0.001"]
    cfg = parse_cli(argv)
    b = cfg.data.global_batch_size
    fixture = sorted(os.path.join(_FIXTURE, f)
                     for f in os.listdir(_FIXTURE) if f.endswith(".jpg"))

    # every train step's host time, and the device-complete time of each
    # main()'s first step, through a Trainer whose step is stamped
    stamps, first_done = [], []
    base_trainer = trainer_mod.Trainer

    class Stamped(base_trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            inner = self.train_step

            def step(state, batch, seed):
                out = inner(state, batch, seed)
                if len(first_done) < len(mains):
                    torch.cuda.synchronize()
                    first_done.append(time.perf_counter())
                stamps.append((state.step, time.perf_counter()))
                return out

            step.comm_meta = inner.comm_meta
            self.train_step = step

    def records():
        with open(jsonl) as f:
            return [json.loads(line) for line in f if line.strip()]

    # the watcher: SIGTERM to this process once a record of step >= 12
    # is on disk and the step after it is dispatched (so the loop has
    # passed that step's stop check, and the stop is a later step); a
    # signal after fit's handler is gone lands here
    sent, late, stop_watch = {}, [], threading.Event()

    def watch():
        while not stop_watch.wait(0.02):
            if not os.path.exists(jsonl):
                continue
            steps = [r["step"] for r in records() if r["event"] == "train"]
            if steps and max(steps) >= 12 \
                    and any(int(s) >= max(steps) for s, _ in list(stamps)):
                sent.update(step=max(steps), ns=time.monotonic_ns())
                os.kill(os.getpid(), signal.SIGTERM)
                return

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    old_sigterm = signal.signal(signal.SIGTERM,
                                lambda *a: late.append(time.perf_counter()))
    trainer_mod.Trainer = Stamped
    mains = []
    spans_since = time.monotonic_ns()
    lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
    lrn_cuda.VEC_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
    try:
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        mains.append(time.perf_counter())
        cli.main(argv)
        stop_watch.set()
        watcher.join(timeout=10)
        check(not watcher.is_alive(), "the SIGTERM watcher did not stop")
        run1 = records()
        mains.append(time.perf_counter())
        cli.main(argv)
        run2 = records()[len(run1):]
        outs = {}
        for name, extra in (("eval", ["--mode", "eval"]),
                            ("eval_best", ["--mode", "eval", "--set",
                                           "train.restore_from_best=true"]),
                            ("predict", ["--mode", "predict",
                                         "--images", *fixture])):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                cli.main(argv + extra)
            outs[name] = (out.getvalue(), time.perf_counter() - t0)
        launches = {"fwd": lrn_cuda.LAUNCHES, "bwd": lrn_cuda.BWD_LAUNCHES,
                    "vec_fwd": lrn_cuda.VEC_LAUNCHES,
                    "vec_bwd": lrn_cuda.VEC_BWD_LAUNCHES}
    finally:
        stop_watch.set()
        trainer_mod.Trainer = base_trainer
        signal.signal(signal.SIGTERM, old_sigterm)
    try:
        recs = records()
        errors = validate_metrics_jsonl(jsonl)
        preempt = [r for r in run1 if r["event"] == "preempt"]
        restore2 = [r for r in run2 if r["event"] in (
            "restore", "iterator_state_restore", "data_iterator_restore",
            "data_fast_forward")]
        evals = [r for r in recs if r["event"] == "eval"]
        fit_evals = {r["step"]: r for r in evals[:-2]}
        mode_eval, best_eval = evals[-2], evals[-1]
        best_mgr = CheckpointManager(os.path.join(ck, "best"),
                                     best_metric="eval_top1")
        best_extra = best_mgr.latest_extra() or {}
        predicted = [json.loads(line) for line in
                     outs["predict"][0].splitlines()
                     if line.startswith("{")]
        # the eval forward of the restored weights on the same decode
        tr = base_trainer(cfg)
        state = tr.restore_or_init()
        dec = NativeJpegEvalIterator(
            fixture, [0] * len(fixture), len(fixture), cfg.data.image_size,
            mean=np.asarray(cfg.data.mean_rgb, np.float32),
            std=np.asarray(cfg.data.stddev_rgb, np.float32))
        batch = next(iter(dec))
        dec.close()
        with torch.inference_mode():
            logits = state.model(
                torch.from_numpy(batch["image"]).cuda()).float().cpu()
        eval_top1 = logits.argmax(-1).tolist()
        t0 = time.perf_counter()
        full = predict_mod.run_predict(tr, fixture,
                                       top_k=cfg.model.num_classes,
                                       stream=io.StringIO())
        predict_s = time.perf_counter() - t0
        sums = [sum(e["prob"] for e in r["top_k"]) for r in full]
        # the float32 eval wire: one batch's pageable H2D copy
        host = torch.empty((b, cfg.data.image_size, cfg.data.image_size, 3),
                           dtype=torch.float32)
        dev = torch.empty_like(host, device="cuda")
        h2d_ms = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            dev.copy_(host)
            e1.record()
            e1.synchronize()
            h2d_ms.append(e0.elapsed_time(e1))
        del host, dev, tr, state
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    stop = preempt[0]["step"] if preempt else None
    dispatch = [(t0, d / 1e6) for n, _, t0, d, *_ in
                get_recorder().snapshot()
                if n == "checkpoint_save_dispatch" and t0 >= spans_since]
    # the preemption's forced save: the first dispatch after the signal
    forced = [ms for t0, ms in dispatch if t0 >= sent.get("ns", 0)][:1]
    by_main = [[t for s, t in stamps if mains[i] <= t
                and (i + 1 == len(mains) or t < mains[i + 1])]
               for i in range(len(mains))]
    step_ms = [(t1 - t0) * 1e3 for run in by_main
               for t0, t1 in zip(run, run[1:])]
    # the gaps that hold no eval and no save (those follow a step that is
    # a multiple of 10, or the preemption's stop)
    steps_by_main = [[s for s, t in stamps if mains[i] <= t
                      and (i + 1 == len(mains) or t < mains[i + 1])]
                     for i in range(len(mains))]
    quiet_ms = [ms for run_s, run_t in zip(steps_by_main, by_main)
                for s, ms in zip(run_s, [(t1 - t0) * 1e3 for t0, t1 in
                                         zip(run_t, run_t[1:])])
                if s % 10]
    eval_s = [r["eval_seconds"] for r in evals]
    emit("train_e2e", card=smi, preset="vggf_imagenet_dp", batch=b,
         argv=argv, steps=30, validation_records=1200,
         step_ms_median=statistics.median(step_ms),
         step_ms_median_without_eval_or_save=statistics.median(quiet_ms),
         host_wait_fraction=[r["host_wait_fraction"] for r in recs
                             if r["event"] == "train"],
         train_feed_step_ms_median=feed_step_ms,
         train_step_ms_median=train_step_ms,
         images_per_s=b / (statistics.median(step_ms) / 1e3),
         eval_passes=len(evals), eval_seconds=eval_s,
         eval_images_per_s=[r["eval_examples"] / r["eval_seconds"]
                            for r in evals],
         eval_h2d_ms=h2d_ms,
         eval_batch_bytes=b * cfg.data.image_size ** 2 * 3 * 4,
         signal_after_step=sent.get("step"), preempted_at=stop,
         steps_signal_to_stop=(stop - sent["step"]
                               if stop and sent else None),
         forced_save_dispatch_ms=forced[0] if forced else None,
         save_dispatch_ms=[ms for _, ms in dispatch],
         resume_first_step_s=first_done[1] - mains[1]
         if len(first_done) > 1 else None,
         restore_events=restore2,
         fit_evals={k: [v["eval_top1"], v["eval_top5"], v["eval_examples"]]
                    for k, v in fit_evals.items()},
         mode_eval=[mode_eval["eval_top1"], mode_eval["eval_top5"],
                    mode_eval["eval_examples"]],
         best_eval=best_eval["eval_top1"], best_slot=best_extra.get(
             "eval_top1"), best_slot_step=best_extra.get("step"),
         predict_records=len(predicted), predict_s=predict_s,
         predict_top1_ties=sum(
             p != e for p, e in zip(
                 [r["top_k"][0]["class"] for r in predicted], eval_top1)),
         predict_images_per_s=len(fixture) / predict_s,
         cli_seconds={k: v[1] for k, v in outs.items()},
         prob_sums=[min(sums), max(sums)] if sums else None,
         schema_errors=errors, lrn_launches=launches, late_sigterm=late,
         losses=[r["loss"] for r in recs if r["event"] == "train"])
    check(not late, "a SIGTERM reached the process outside fit")
    check(stop is not None and sent and 1 <= stop - sent["step"] <= 3,
          f"preempt {preempt} after the signal at step {sent.get('step')}")
    check(preempt[0]["checkpointed"], f"preempt record {preempt}")
    check(any(r["event"] == "restore" and r["step"] == stop
              for r in restore2)
          and any(r["event"] == "iterator_state_restore"
                  and r["replayed_batches"] == 0 for r in restore2)
          and not any(r["event"] == "data_fast_forward" for r in restore2),
          f"the resume did not restore step {stop} through the blob: "
          f"{restore2}")
    check(sorted(fit_evals) == [10, 20, 30],
          f"in-fit evals at {sorted(fit_evals)}")
    check(all(r["eval_examples"] == 1200 for r in evals),
          f"eval examples {[r['eval_examples'] for r in evals]}")
    f30 = fit_evals.get(30, {})
    check([mode_eval[k] for k in ("eval_top1", "eval_top5")]
          == [f30.get(k) for k in ("eval_top1", "eval_top5")],
          f"--mode eval {mode_eval} against the in-fit eval at 30 {f30}")
    check(best_eval["eval_top1"] == best_extra.get("eval_top1"),
          f"best-slot eval {best_eval} against the slot {best_extra}")
    # the same class, or one whose bf16 logit ties the eval forward's
    # largest (records break ties by np.argsort, as JAX's do)
    top1 = [r["top_k"][0]["class"] for r in predicted]
    check(len(predicted) == len(fixture)
          and all(float(logits[i, c]) == float(logits[i].max())
                  for i, c in enumerate(top1)),
          f"predict top-1 {top1} against the eval forward's {eval_top1}")
    check(len(sums) == len(fixture)
          and all(abs(s - 1.0) <= 1e-3 for s in sums),
          f"probability rows sum to {sums}")
    check(errors == [], f"metrics.jsonl schema errors: {errors}")
    steps_run = 30
    passes = len(evals)
    want = {"fwd": 2 * steps_run + 2 * 2 * passes + 2,
            "bwd": 2 * steps_run}
    check(launches == {**want, "vec_fwd": want["fwd"],
                       "vec_bwd": want["bwd"]},
          f"LRN launches {launches}, expected {want} (30 steps, {passes} "
          "eval passes of 2 batches, one predict batch), all vector")
    check(all(math.isfinite(r["loss"]) for r in recs
              if r["event"] == "train"), "non-finite loss")
    torch.cuda.empty_cache()
    return launches


def _autotune_run(cfg, steps):
    """One fit of `cfg` for `steps` steps through the trainer-owned feed,
    a record every 5 steps: (trainer, per-window rows, ms a step of each
    window, LRN launches, the largest `prefetch/pinned_bytes` seen at a
    record, peak device memory, the `autotune/*` counters' movement)."""
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.telemetry import get_registry
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    reg = get_registry()
    names = ("windows", "actuations", "blocked_hysteresis",
             "blocked_cooldown", "blocked_rail", "oscillation_freezes")
    before = {n: reg.counter_value(f"autotune/{n}", 0) for n in names}
    stamps, pinned = [], [0]

    def on_record(event, rec):
        if event == "train":
            stamps.append(time.perf_counter())
            pinned[0] = max(pinned[0],
                            reg.gauge("prefetch/pinned_bytes", 0) or 0)

    trainer = Trainer(cfg, log=on_record)
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
    lrn_cuda.VEC_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    state = trainer.fit(state, num_steps=steps)
    torch.cuda.synchronize()
    launches = {"fwd": lrn_cuda.LAUNCHES, "bwd": lrn_cuda.BWD_LAUNCHES,
                "vec_fwd": lrn_cuda.VEC_LAUNCHES,
                "vec_bwd": lrn_cuda.VEC_BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    moved = {n: reg.counter_value(f"autotune/{n}", 0) - before[n]
             for n in names}
    recs = [r for r in trainer.records if r["event"] == "train"]
    stamps.insert(0, t0)
    window_ms = [(t1 - t0_) * 1e3 / (r["step"] - p)
                 for t0_, t1, r, p in zip(stamps, stamps[1:], recs,
                                          [0] + [r["step"] for r in recs])]
    rows = []
    for r in recs:
        at = r.get("autotune") or {}
        rows.append({
            "step": r["step"], "verdict": r["stall"]["verdict"],
            "infeed_fraction": r["stall"]["infeed_fraction"],
            "queue_depth": r["stall"].get("queue_depth"),
            "host_wait_fraction": r["host_wait_fraction"],
            "actuations": [(a["knob"], a["from"], a["to"])
                           for a in at.get("actuations", [])],
            "blocked": at.get("blocked"), "knobs": at.get("knobs"),
            "settled": at.get("settled")})
    del state
    return trainer, recs, rows, window_ms, launches, pinned[0], peak, moved


def _replay_autotune(armed, stalls):
    """The records a fresh IngestAutotuner makes of `stalls` over knobs
    that start where `armed` (the autotune_armed receipt) says: what the
    controller's rules allow."""
    from distributed_vgg_f_tpu_torch.data import autotune

    class Target:
        def __init__(self, value):
            self.value = value

        def apply(self, n):
            self.value = n
            return n

    knobs = []
    for k in armed["knobs"]:
        t = Target(k["value"])
        knobs.append(autotune.Knob(
            k["name"], lambda t=t: t.value, t.apply, k["min"], k["max"],
            geometric=k["name"] == "native_threads"))
    from distributed_vgg_f_tpu_torch.telemetry import TelemetryRegistry
    tuner = autotune.IngestAutotuner(knobs, registry=TelemetryRegistry(),
                                     clock=lambda: 0.0)
    check(tuner.describe()["config"] == armed["config"],
          f"train_autotune: armed with {armed['config']}, not the module's "
          "settings")
    return [tuner.observe(s) for s in stalls]


def phase_train_autotune(feed_dir, smi):
    """The flagship's ingest autotuner on the card, after a 5-step warm-up
    fit: (a) 60 steps on phase train_feed's shards with a record every 5
    and the preset's autotuner on; (b) the same under DVGGF_AUTOTUNE=0; (c) the seeded-batch feed
    (data.name="synthetic") with the autotuner on, 30 steps. Returns the
    LRN launches of the three runs."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.data import autotune
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = get_config("vggf_imagenet_dp")
    check(cfg.data.autotune.enabled, "the preset's autotuner is off")
    # base_lr 0.001, as train_e2e: at the preset's LR the 16-image
    # fixture diverges within 40 steps (PERF.md §6)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_dir=feed_dir),
        optim=dataclasses.replace(cfg.optim, base_lr=0.001),
        train=dataclasses.replace(cfg.train, log_every=5, seed=0))
    steps = 60
    # warm the process first (cuDNN's algorithm search, the decoder's first
    # draws): a cold first window takes seconds a step, the read-ahead
    # fills meanwhile, and window 2 would drain it at the card's pace
    warm = Trainer(cfg)
    warm.fit(warm.init_state(0), num_steps=5)
    torch.cuda.synchronize()
    del warm
    gc.collect()
    out, launches = {}, {}
    for run, env, c, n in (
            ("a", None, cfg, steps),
            ("b", "0", cfg, steps),
            ("c", None, dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, name="synthetic")), 30)):
        if env is not None:
            os.environ[autotune.ENV_KILL] = env
        try:
            (trainer, recs, rows, window_ms, launches[run], pinned, peak,
             moved) = _autotune_run(c, n)
        finally:
            os.environ.pop(autotune.ENV_KILL, None)
        armed = [r for r in trainer.records if r["event"] == "autotune_armed"]
        out[run] = {
            "steps": n, "windows": rows, "window_step_ms": window_ms,
            "step_ms_median": statistics.median(window_ms[1:]),
            "pinned_host_bytes_max": pinned, "peak_memory_bytes": peak,
            "autotune_counters_moved": moved,
            "host_stage": trainer.host_prefetch is not None,
            "armed": armed[0] if armed else None,
            "describe": (trainer.autotuner.describe()
                         if trainer.autotuner is not None else None),
            "lrn_launches": launches[run]}
        want = {"fwd": 2 * n, "bwd": 2 * n}
        check(launches[run] == {**want, "vec_fwd": 2 * n, "vec_bwd": 2 * n},
              f"train_autotune ({run}): LRN launches {launches[run]}, "
              f"expected {want}, all vector")
        check(all(math.isfinite(r["loss"]) for r in recs),
              f"train_autotune ({run}): non-finite loss")
        if run == "b":
            check(not out[run]["host_stage"] and trainer.autotuner is None
                  and not armed and all("autotune" not in r for r in recs)
                  and not any(moved.values()),
                  f"train_autotune (b): the killed autotuner left a host "
                  f"stage, a record or a counter: {moved}")
        else:
            check(len(armed) == 1 and out[run]["host_stage"],
                  f"train_autotune ({run}): not armed")
            # every move is one the rules make of the recorded verdicts
            def untimed(rec):
                return {**rec, "actuations": [
                    {k: v for k, v in a.items() if k != "ts_unix"}
                    for a in rec.get("actuations", [])]}

            want_rows = _replay_autotune(armed[0],
                                         [r["stall"] for r in recs])
            check([untimed(r["autotune"]) for r in recs]
                  == [untimed(w) for w in want_rows],
                  f"train_autotune ({run}): the controller moved outside "
                  "its rules")
            knobs = {k["name"]: k for k in out[run]["describe"]["knobs"]}
            out[run]["knob_rails"] = {
                name: "rail" if k["value"] >= k["max"] else None
                for name, k in knobs.items()}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    a, c = out["a"], out["c"]
    threads = {k["name"]: k for k in a["describe"]["knobs"]}.get(
        "native_threads")
    emit("train_autotune", config=cfg.name, data_dir_shards=4,
         log_every=5, cpu_count=os.cpu_count(),
         rails={"max_threads": autotune.MAX_THREADS or max(
             autotune.MIN_THREADS, min(16, os.cpu_count() or 1)),
                "max_prefetch": autotune.MAX_PREFETCH,
                "max_prefetch_to_device": autotune.MAX_PREFETCH_TO_DEVICE},
         k_windows=autotune.K_WINDOWS,
         cooldown_windows=autotune.COOLDOWN_WINDOWS,
         step_ms_median_a=a["step_ms_median"],
         step_ms_median_b=out["b"]["step_ms_median"],
         step_ms_median_c=c["step_ms_median"],
         pinned_host_bytes_a=a["pinned_host_bytes_max"],
         pinned_host_bytes_b=out["b"]["pinned_host_bytes_max"],
         peak_memory_bytes_a=a["peak_memory_bytes"],
         peak_memory_bytes_b=out["b"]["peak_memory_bytes"],
         runs=out, nvidia_smi=smi)
    # the acceptance of the infeed signal and of the controller
    late = a["windows"][1:]
    check(all(w["verdict"] == "infeed_bound" and w["infeed_fraction"] >= 0.25
              for w in late),
          "train_autotune (a): a window after the first is not infeed_bound "
          f"at >= 0.25: {[(w['verdict'], w['infeed_fraction']) for w in late]}")
    check(all(w["verdict"] == "compute_bound" for w in c["windows"])
          and c["describe"]["actuations_total"] == 0,
          "train_autotune (c): the seeded feed is not compute_bound "
          f"everywhere or moved a knob: {c['windows']}")
    moves = [w for w in a["windows"] if w["actuations"]]
    check(moves and a["windows"].index(moves[0]) + 1 >= autotune.K_WINDOWS,
          f"train_autotune (a): no move, or one before window "
          f"{autotune.K_WINDOWS}")
    if threads is not None and threads["value"] >= threads["max"]:
        check(a["knob_rails"]["native_threads"] == "rail"
              and not any(w["actuations"][0][0] == "native_threads"
                          for w in moves),
              "train_autotune (a): the railed thread knob moved")
    torch.cuda.empty_cache()
    return {k: launches["a"][k] + launches["b"][k] + launches["c"][k]
            for k in ("fwd", "bwd")}


def _decode_run(files, items, cfg, batches, keep=(), keep_labels=False):
    """The native decoder alone over TFRecord `files` (their `items`: path
    index, offsets, lengths, labels) at `cfg`'s batch, size and threads:
    batch 0 drawn untimed (it starts the workers), then `batches` more
    into one pinned buffer, timed. Returns (images/s, {position: images
    copied to the CPU} for `keep`, every drawn batch's labels when
    `keep_labels`, the decode_stats and decode_profile of the run)."""
    from distributed_vgg_f_tpu_torch.data import native_jpeg
    path_idx, offsets, lengths, labels = items
    b, size = cfg.data.global_batch_size, cfg.data.image_size
    it = native_jpeg.NativeJpegTrainIterator(
        files, labels, b, size, seed=cfg.train.seed,
        mean=np.asarray(cfg.data.mean_rgb, np.float32),
        std=np.asarray(cfg.data.stddev_rgb, np.float32),
        image_dtype="uint8", num_threads=cfg.data.native_threads or None,
        ranges=(path_idx, offsets, lengths),
        hflip=not cfg.data.augment.owns_hflip)
    images = torch.empty((b, size, size, 3), dtype=torch.uint8,
                         pin_memory=True)
    lab = torch.empty((b,), dtype=torch.int32, pin_memory=True)
    native_jpeg.decode_stats(reset=True)
    native_jpeg.decode_profile(reset=True)
    kept, all_labels = {}, []
    t0 = 0.0
    try:
        for pos in range(batches + 1):
            if pos == 1:
                t0 = time.perf_counter()
            it.next_into(images, lab)
            if pos in keep:
                kept[pos] = images.clone()
            if keep_labels:
                all_labels.append(lab.clone())
        rate = batches * b / (time.perf_counter() - t0)
    finally:
        it.close()
    return (rate, kept, all_labels, native_jpeg.decode_stats(reset=True),
            native_jpeg.decode_profile(reset=True))


def _decode_surface(cfg, feed_dir, tmp, positions):
    """Phase train_snapshot (d): decode-only images/s of the fixture's
    shards with DCT-scaled decode and the SIMD resample each on and off,
    and of the fixture re-encoded with a restart marker every MCU row
    (`reencode_restart`, packed into 2048 records under `tmp`) at fan-out
    1 and 4; each run's decode_stats, decode_profile split and the kinds
    it dispatched to. Every run's batch 1 is byte-equal to the default
    run's (at 224 px from 500x375 every train crop keeps scale 8/8, where
    the scaled decode is the full one; SIMD and scalar, restart and
    sequential, fan-out 1 and 4 are equal by the JAX package's tests).
    The default run draws `positions` batches and returns their labels
    and its first four batches (the uncached stream)."""
    from distributed_vgg_f_tpu_torch.data import native_jpeg
    from distributed_vgg_f_tpu_torch.data.imagenet import _tfrecord_items
    from tools.tfrecord_write import write_shards
    shards = sorted(os.path.join(feed_dir, f) for f in os.listdir(feed_dir)
                    if f.startswith("train-"))
    items = _tfrecord_items(shards, 1)
    paths = sorted(f for f in os.listdir(_FIXTURE) if f.endswith(".jpg"))
    marked = []
    for f in paths:
        with open(os.path.join(_FIXTURE, f), "rb") as fh:
            marked.append(native_jpeg.reencode_restart(fh.read(), 0))
    check(all(marked), "reencode_restart failed on the fixture")
    rdir = os.path.join(tmp, "restart")
    rfiles = write_shards(rdir, marked,
                          [1 + (61 * k) % 1000 for k in range(len(marked))],
                          shards=1, per_shard=2048)
    ritems = _tfrecord_items(rfiles, 1)
    switches = (native_jpeg.simd_kind(), native_jpeg.scaled_kind(),
                native_jpeg.restart_kind(), native_jpeg.restart_fanout())
    # the largest train crop of a 500 x 375 JPEG keeps DCT scale 8/8 at
    # this size: the scaled decode is then the full one byte for byte
    full_scale = native_jpeg.expected_scale_denom(500, 375,
                                                  cfg.data.image_size) == 8
    runs, ref, uncached = {}, None, None
    try:
        for name, simd, scaled, restart, fanout, fs, its, n in (
                ("default", True, True, True, 1, shards, items, positions),
                ("scaled_off", True, False, True, 1, shards, items, 3),
                ("simd_off", False, True, True, 1, shards, items, 3),
                ("scaled_off_simd_off", False, False, True, 1, shards, items,
                 3),
                ("restart_fanout1", True, True, True, 1, rfiles, ritems, 3),
                ("restart_fanout4", True, True, True, 4, rfiles, ritems, 3),
                ("restart_sequential", True, True, False, 1, rfiles, ritems,
                 3)):
            kinds = {"simd": native_jpeg.set_simd(simd),
                     "scaled": native_jpeg.set_scaled(scaled),
                     "restart": native_jpeg.set_restart(restart),
                     "fanout": native_jpeg.set_restart_fanout(fanout),
                     "partial": native_jpeg.partial_supported()}
            native_jpeg.restart_stats(reset=True)
            default = name == "default"
            rate, kept, labels, stats, prof = _decode_run(
                fs, its, cfg, n - 1 if default else n,
                keep=(0, 1, 2, 3) if default else (1,),
                keep_labels=default)
            runs[name] = {"kinds": kinds, "images_per_s": rate,
                          "timed_batches": n - 1 if default else n,
                          "decode_stats": stats,
                          "restart_stats": native_jpeg.restart_stats(
                              reset=True),
                          "jpeg_s": prof["jpeg_s"],
                          "resample_s": prof["resample_s"],
                          "jpeg_share": prof["jpeg_s"] / (
                              prof["jpeg_s"] + prof["resample_s"])
                          if prof["jpeg_s"] + prof["resample_s"] else None}
            if default:
                uncached = {"labels": labels, "images": kept}
                ref = kept[1]
            elif fs is shards:
                runs[name]["batch1_equal_default"] = bool(
                    torch.equal(kept[1], ref))
            else:
                runs[name]["batch1"] = kept[1]
        rref = runs["restart_sequential"]["batch1"]
        for name in ("restart_fanout1", "restart_fanout4",
                     "restart_sequential"):
            runs[name]["batch1_equal_sequential"] = bool(
                torch.equal(runs[name].pop("batch1"), rref))
    finally:
        native_jpeg.set_simd(switches[0] != "scalar")
        native_jpeg.set_scaled(switches[1] == "scaled")
        native_jpeg.set_restart(switches[2] == "restart")
        native_jpeg.set_restart_fanout(switches[3])
    for name, run in runs.items():
        for key in ("batch1_equal_default", "batch1_equal_sequential"):
            check(run.get(key, True) or (not full_scale and "scaled_off"
                                         in name),
                  f"train_snapshot (d): {name}'s batch 1 differs ({key})")
    check(runs["restart_fanout1"]["restart_stats"]["images"] > 0
          and runs["restart_fanout4"]["restart_stats"]["fanout_images"] > 0,
          "train_snapshot (d): the restart path or its fan-out never "
          f"engaged: {runs['restart_fanout4']['restart_stats']}")
    return runs, uncached


def phase_train_snapshot(feed_dir, smi):
    """The flagship's decoded-crop snapshot cache on train_feed's shards,
    base_lr 0.001, a record every 4 steps, the store in a fresh temp dir:
    (a) one fit of 24 steps, the 4 cold steps capturing the 4096 items
    and 20 warm; a profile of 3 warm steps through a live feed; (b) a
    fresh Trainer on the complete store, warm from batch 0 with no
    decode; (c) checks: no warm miss, the labels at each position those
    of the uncached native stream, the images of epochs 1 and later the
    epoch-0 crops of the same items, and one corrupted payload byte one
    miss, repaired to its cold crop; (d) the decode surface
    (`_decode_surface`). Returns the LRN launches of (a) and (b)."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.config import (SnapshotCacheConfig,
                                                    get_config)
    from distributed_vgg_f_tpu_torch.data import build_dataset, native_jpeg
    from distributed_vgg_f_tpu_torch.data import snapshot_cache as sc
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.telemetry import get_registry
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="train_snapshot_")
    try:
        base = get_config("vggf_imagenet_dp")
        check(not base.data.snapshot_cache.enabled,
              "the preset turns the snapshot cache on")
        cfg = dataclasses.replace(
            base, data=dataclasses.replace(
                base.data, data_dir=feed_dir,
                snapshot_cache=SnapshotCacheConfig(
                    enabled=True, dir=os.path.join(tmp, "store"))),
            optim=dataclasses.replace(base.optim, base_lr=0.001),
            train=dataclasses.replace(base.train, log_every=4, seed=0))
        from distributed_vgg_f_tpu_torch.data.imagenet import _tfrecord_items
        b, size = cfg.data.global_batch_size, cfg.data.image_size
        n_items = len(_tfrecord_items(sorted(
            os.path.join(feed_dir, f) for f in os.listdir(feed_dir)
            if f.startswith("train-")), 1)[3])
        cold, steps = n_items // b, 24
        check(cold * b == n_items and cold < steps - 4,
              f"train_snapshot: {n_items} items in batches of {b}")
        reg = get_registry()
        names = ("prefetch/snapshot_hits", "prefetch/snapshot_misses",
                 "prefetch/snapshot_bytes")

        def counts():
            return [reg.counter_value(n, 0) for n in names]

        def spied(trainer, keep):
            made, stamps = [], []
            make, step = trainer.make_dataset, trainer.train_step

            def make_spy(split="train", data_cfg=None):
                made.append(make(split, data_cfg))
                return made[-1]

            def step_spy(state, batch, seed):
                stamps.append(time.perf_counter())
                if keep is not None:
                    keep.append((batch["image"].clone(),
                                 batch["label"].clone()))
                return step(state, batch, seed)

            step_spy.comm_meta = getattr(step, "comm_meta", None)
            trainer.make_dataset, trainer.train_step = make_spy, step_spy
            return made, stamps, step

        def run(steps, keep=None):
            trainer = Trainer(cfg)
            made, stamps, step = spied(trainer, keep)
            state = trainer.init_state(0)
            before, dec0 = counts(), native_jpeg.decode_stats()["images"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
            lrn_cuda.VEC_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
            t0 = time.perf_counter()
            state = trainer.fit(state, num_steps=steps)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            trainer.train_step = step
            launches = {"fwd": lrn_cuda.LAUNCHES, "bwd": lrn_cuda.BWD_LAUNCHES,
                        "vec_fwd": lrn_cuda.VEC_LAUNCHES,
                        "vec_bwd": lrn_cuda.VEC_BWD_LAUNCHES}
            moved = [a - c for a, c in zip(counts(), before)]
            out = {"wall_s": time.perf_counter() - t0,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "step_ms": [(t1 - t0_) * 1e3
                               for t0_, t1 in zip(stamps, stamps[1:])],
                   "snapshot_hits": moved[0], "snapshot_misses": moved[1],
                   "snapshot_bytes": moved[2],
                   "decoded_images": native_jpeg.decode_stats()["images"]
                   - dec0,
                   "lrn_launches": launches}
            recs = [r for r in trainer.records if r["event"] == "train"]
            out["windows"] = [{
                "step": r["step"], "verdict": r["stall"]["verdict"],
                "infeed_fraction": r["stall"]["infeed_fraction"],
                "host_wait_fraction": r["host_wait_fraction"],
                "autotune": r.get("autotune")} for r in recs]
            out["losses"] = [r["loss"] for r in recs]
            check(len(made) == 1
                  and isinstance(made[0], sc.SnapshotCachingTrainIterator),
                  f"train_snapshot: the train stream is {made}, not the "
                  "snapshot cache")
            check(launches == {"fwd": 2 * steps, "bwd": 2 * steps,
                               "vec_fwd": 2 * steps, "vec_bwd": 2 * steps},
                  f"train_snapshot: LRN launches {launches} over {steps} "
                  "steps, expected 2 + 2 a step, all vector")
            check(all(math.isfinite(v) for v in out["losses"]),
                  f"train_snapshot: losses {out['losses']}")
            return trainer, state, made[0], out

        # (a) 4 cold steps, then 20 warm
        seen = []
        trainer, state, wrapper, a = run(steps, keep=seen)
        store = wrapper.store
        # 616,562,688 bytes at full size: 4096 items of 224 x 224 x 3 u8
        check(wrapper.warm and store.complete
              and store.bytes_used == n_items * size * size * 3,
              f"train_snapshot (a): warm {wrapper.warm}, complete "
              f"{store.complete}, {store.bytes_used} store bytes")
        check(a["snapshot_misses"] == 0, f"train_snapshot (a): "
              f"{a['snapshot_misses']} warm misses")
        # step_ms[i]: from step i's call to step i + 1's (the last, to
        # the end of fit): the waits for batches 1..3 are cold, those for
        # batches 6..23 warm (batches 4 and 5 the switch)
        a["cold_step_ms_median"] = statistics.median(a["step_ms"][:cold - 1])
        a["warm_step_ms_median"] = statistics.median(
            a["step_ms"][cold + 1:steps - 1])
        assembly = list(wrapper.warm_assembly_s)
        a["warm_assembly_ms"] = [s * 1e3 for s in assembly]
        a["warm_assembly_ms_median"] = statistics.median(assembly) * 1e3
        a["store_bytes"] = store.bytes_used
        # one epoch-1 batch's reads and checks alone, with nothing else
        # running, at each thread count (median of 3)
        keys = sc.shuffle_indices(n_items, cfg.train.seed, 1)[:b]
        entries = [store.lookup(int(k)) for k in keys]
        dst = torch.empty((b, size, size, 3), dtype=torch.uint8,
                          pin_memory=True).numpy()
        at = [j * size * size * 3 for j in range(b)]
        gather_ms = {}
        for threads in (1, 2, 4, 8):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                whys = store.fetch(entries, dst, at, threads)
                times.append((time.perf_counter() - t0) * 1e3)
            check(whys == [None] * b, "train_snapshot (a): a stored payload "
                  "failed its read")
            gather_ms[threads] = statistics.median(times)
        a["gather_ms_by_threads"] = gather_ms
        del dst
        # the card's idle share over warm steps through a live feed
        ingest, feed = trainer.open_feed(state.step)
        for _ in range(3):
            state, _ = trainer.train_step(state, next(feed), cfg.train.seed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                state, _ = trainer.train_step(state, next(feed),
                                              cfg.train.seed)
            torch.cuda.synchronize()
        feed.close()
        ingest.close()
        t = _trace_breakdown(prof, 3, top=10)
        a["warm_profile"] = {"steps": 3, "window_us_per_step": t["window_us"],
                             "device_busy_us_per_step": t["busy_us"],
                             "device_idle_share": t["idle_share"],
                             "top_device_us_per_step": t["top_us"]}
        del trainer, state, prof
        gc.collect()

        # (b) a fresh Trainer on the complete store: warm from batch 0
        trainer, state, wrapper_b, bb = run(8)
        check(bb["snapshot_misses"] == 0 and bb["decoded_images"] == 0
              and bb["snapshot_hits"] >= 8 * b,
              f"train_snapshot (b): {bb['snapshot_misses']} misses, "
              f"{bb['decoded_images']} decoded, {bb['snapshot_hits']} hits")
        bb["warm_step_ms_median"] = statistics.median(bb["step_ms"][1:7])
        del trainer, state
        gc.collect()

        # (d) the decode surface; its default run is the uncached stream
        runs, uncached = _decode_surface(cfg, feed_dir, tmp, steps)

        # (c) the order, the re-served crops and a repaired payload
        got_labels = [lab.cpu() for _, lab in seen]
        labels_equal = [bool(torch.equal(g, w)) for g, w in
                        zip(got_labels, uncached["labels"])]
        check(len(seen) == steps and all(labels_equal),
              f"train_snapshot (c): labels against the uncached stream "
              f"{labels_equal}")
        cold_equal = [bool(torch.equal(seen[p][0].cpu(),
                                       uncached["images"][p]))
                      for p in range(cold)]
        check(all(cold_equal), f"train_snapshot (c): the cold batches "
              f"against the uncached stream {cold_equal}")
        epoch0 = torch.cat([seen[p][0] for p in range(cold)])
        order0 = sc.shuffle_indices(n_items, cfg.train.seed, 0)
        inv0 = np.empty_like(order0)
        inv0[order0] = np.arange(n_items)
        reserved = []
        for p in range(cold, steps):
            epoch = p * b // n_items
            order = sc.shuffle_indices(n_items, cfg.train.seed, epoch)
            idx = order[(p * b) % n_items + np.arange(b)]
            src = torch.from_numpy(inv0[idx]).to(epoch0.device)
            reserved.append(bool(torch.equal(seen[p][0], epoch0[src])))
        check(all(reserved), f"train_snapshot (c): warm batches against "
              f"the epoch-0 crops of their items {reserved}")
        # one payload byte flipped: one miss, repaired to the cold crop
        idx = int(sc.shuffle_indices(n_items, cfg.train.seed, 1)[0])
        crop = epoch0[int(inv0[idx])].cpu()
        off, nbytes = store._entries[idx][0], store._entries[idx][1]
        with open(store._pack_path, "r+b") as f:
            f.seek(off + nbytes // 2)
            v = f.read(1)[0]
            f.seek(off + nbytes // 2)
            f.write(bytes([v ^ 0xFF]))
        probe = build_dataset(cfg.data, "train", seed=cfg.train.seed)
        try:
            check(probe.restore_state(cold), "train_snapshot (c): no seek")
            before = counts()
            images = torch.empty((b, size, size, 3), dtype=torch.uint8,
                                 pin_memory=True)
            lab = torch.empty((b,), dtype=torch.int32, pin_memory=True)
            probe.next_into(images, lab)
            moved = [x - y for x, y in zip(counts(), before)]
            repaired = probe.store.read(idx)
            repair = {"item": idx, "hits": moved[0], "misses": moved[1],
                      "served_equal_cold": bool(torch.equal(images[0], crop)),
                      "store_equal_cold": repaired is not None and bool(
                          torch.equal(torch.from_numpy(repaired), crop))}
        finally:
            probe.close()
        check(repair["misses"] == 1 and repair["hits"] == b - 1
              and repair["served_equal_cold"] and repair["store_equal_cold"],
              f"train_snapshot (c): a corrupted payload gave {repair}")
        del seen, epoch0
        gc.collect()
        torch.cuda.empty_cache()
        emit("train_snapshot", config=cfg.name, data_dir_shards=4,
             items=n_items, log_every=4, steps=steps, cold_steps=cold,
             cpu_count=os.cpu_count(), batch_io_threads=sc.BATCH_IO_THREADS,
             capacity_bytes=cfg.data.snapshot_cache.capacity_bytes,
             a=a, b=bb, labels_equal=labels_equal, cold_equal=cold_equal,
             reserved_equal=reserved, repair=repair, decode=runs,
             phase_s=time.perf_counter() - t_phase, nvidia_smi=smi)
        return {k: a["lrn_launches"][k] + bb["lrn_launches"][k]
                for k in ("fwd", "bwd")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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


#: the zoo's BASELINE presets and their models (phases zoo_*)
_ZOO = (("vgg16", "vgg16_imagenet"), ("resnet50", "resnet50_imagenet"))
#: zoo_train's global batch: the presets' 1024 over four cards
_ZOO_BATCH = 256


def _hand_kernel_counts():
    """Every hand kernel's launch count (LRN and flash, block included)."""
    from distributed_vgg_f_tpu_torch.ops import flash_cuda, lrn_cuda
    counts = {k: getattr(lrn_cuda, k) for k in (
        "LAUNCHES", "BWD_LAUNCHES", "VEC_LAUNCHES", "VEC_BWD_LAUNCHES")}
    counts.update({k: getattr(flash_cuda, k) for k in dir(flash_cuda)
                   if k.endswith("_LAUNCHES")})
    return counts


def _zoo_tree(name, preset):
    """Seeded weights (init_params, seed 0) and, for ResNet, non-trivial
    BatchNorm statistics (means N(0, 0.1), variances U(0.8, 1.25)) with
    bn3's scales drawn at 0.05–0.15, so the residual branches reach the
    logits (their init of zeros would silence them)."""
    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.weights import (init_batch_stats,
                                                      init_params)
    cfg = get_config(preset)
    tree = init_params(cfg.model, 0, image_size=cfg.data.image_size)
    stats = init_batch_stats(cfg.model)
    rng = np.random.default_rng(0)

    def draw(node, name=""):
        for key, value in node.items():
            if isinstance(value, dict):
                draw(value, key)
                continue
            if name == "bn3" and key == "scale":
                value = rng.uniform(0.05, 0.15, value.shape)
            elif key == "mean":
                value = 0.1 * rng.standard_normal(value.shape)
            elif key == "var":
                value = rng.uniform(0.8, 1.25, value.shape)
            node[key] = value.astype(np.float32)

    if stats:
        draw(tree)
        draw(stats)
    return cfg, tree, stats


def _write_npz(path, tree, stats):
    """The flat 'layer/leaf' npz build_engine reads, the statistics under
    'batch_stats/'."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = v

    walk(tree, ())
    walk(stats, ("batch_stats",))
    np.savez(path, **flat)


def phase_zoo_model(name, preset, tmp):
    """A zoo model at full width (224 px, 1000 classes, bf16) through
    build_engine on the flagship's ladder, from an npz of seeded weights
    (and ResNet's statistics); logits against the CPU forward of the same
    weights. Returns (cfg, tree, stats)."""
    from distributed_vgg_f_tpu_torch.config import ModelConfig
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.ops.batch_norm import batch_stats_of
    from distributed_vgg_f_tpu_torch.serving.engine import build_engine
    from distributed_vgg_f_tpu_torch.weights import load_params
    t0 = time.perf_counter()
    cfg, tree, stats = _zoo_tree(name, preset)
    path = os.path.join(tmp, f"{name}.npz")
    _write_npz(path, tree, stats)
    init_s = time.perf_counter() - t0
    size, classes = cfg.data.image_size, cfg.model.num_classes
    before = _hand_kernel_counts()
    engine = build_engine(name, size, classes, cfg.serving.buckets,
                          cfg.serving.max_batch, weights=path,
                          device="cuda", compute_dtype=cfg.model.compute_dtype,
                          extra=cfg.model.extra)
    os.remove(path)
    check(engine.buckets == (1, 2, 4, 8, 16, 32),
          f"{name} ladder is {engine.buckets}")
    engine.warmup()
    torch.cuda.synchronize()
    check(sorted(engine.compile_log) == list(engine.buckets),
          f"{name} warmed {sorted(engine.compile_log)}")
    served = dict(engine._model.named_buffers())
    for key, v in batch_stats_of(engine._model).items():
        layer, leaf = key.rsplit(".", 1)
        node = stats
        for part in layer.split("."):
            node = node[part]
        check(bool(torch.equal(v.cpu(), torch.from_numpy(node[leaf]))),
              f"{name} served statistic {key} is not the npz's")
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (32, size, size, 3)).astype(np.uint8)
    probs, bucket = engine.run(imgs)
    check(probs.shape == (32, classes) and bucket == 32,
          f"{name} probs {probs.shape} bucket {bucket}")
    check(bool(np.isfinite(probs).all()), f"{name} non-finite probabilities")
    sums_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    check(sums_err <= 1e-3, f"{name} probabilities sum off 1 by {sums_err}")
    forward_ms = _forward_ms({"e": engine}, imgs, engine.buckets)["e"]
    check(_hand_kernel_counts() == before,
          f"{name} launched a hand kernel: {before} -> "
          f"{_hand_kernel_counts()}")
    x = _normalized(imgs[:2], cfg.data)
    fp32 = ModelConfig(name=name, num_classes=classes,
                       compute_dtype="float32", extra=cfg.model.extra)
    ref_model = load_params(build_model(fp32, image_size=size), tree,
                            stats).eval()
    with torch.no_grad():
        ref = ref_model(x).numpy()
        card32 = load_params(build_model(fp32, image_size=size), tree,
                             stats).cuda()
        got32 = card32(x.cuda()).cpu().numpy()
        del card32
        card16 = load_params(build_model(cfg.model, image_size=size), tree,
                             stats).cuda()
        got16 = card16(x.cuda()).cpu().numpy()
        del card16
    err32 = float(np.abs(got32 - ref).max())
    err16 = float(np.abs(got16 - ref).max())
    scale = float(np.abs(ref).max())
    # phase model's tolerances: fp32 (TF32 off) 1e-3; bf16 2e-2 of the
    # largest logit
    check(np.allclose(got32, ref, rtol=1e-3, atol=1e-3),
          f"{name} fp32 card logits off the CPU by {err32}")
    check(np.allclose(got16, ref, rtol=2e-2, atol=2e-2 * scale),
          f"{name} bf16 card logits off the CPU fp32 by {err16}")
    n_params = sum(p.numel() for p in engine._model.parameters())
    n_stats = sum(v.numel() for v in batch_stats_of(engine._model).values())
    emit("zoo_model", model=name, preset=preset, image_size=size,
         num_classes=classes, compute_dtype=cfg.model.compute_dtype,
         params=n_params, param_leaves=len(list(engine._model.parameters())),
         batch_stats=n_stats, batch_stat_leaves=len(batch_stats_of(
             engine._model)), buffers=len(served), init_s=init_s,
         buckets=list(engine.buckets),
         warmup_s={str(b): s for b, s in sorted(engine.compile_log.items())},
         probs_sum_max_err=sums_err, forward_ms=forward_ms,
         images_per_s={b: int(b) / (ms / 1e3)
                       for b, ms in forward_ms.items()},
         ref_max_abs_logit=scale, fp32_max_abs_err=err32,
         bf16_max_abs_err=err16,
         hbm_estimate_bytes=engine.hbm_estimate_bytes,
         hand_kernel_launches=0)
    del engine, ref_model
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, tree, stats


def phase_zoo_train_parity(name, cfg):
    """One fp32 train step of a zoo model at full width (TF32 off,
    dropout and augment off, batch 2) on the card, from the seeded init
    (init_params seed 0, Flax's initial statistics; ResNet's bn3 scales
    are the init's zeros, so its branch convs get exactly zero gradients)
    and a seeded u8 batch, against the same step on the CPU in fp64; the
    CPU's fp32 step and the card's fp64 step beside them. Checks: the
    card's fp64 step is the CPU's, every gradient, update and statistic
    within 1e-6 relative L2 (the same function and derivative on both
    devices, to the rounding of the fp32 logits and loss both keep; 1.5e-8
    and 1.8e-8 measured); the card's fp32 step within 1e-2 relative L2
    of the fp64 step. Phase train_parity's 1e-4 cannot hold here: at batch
    2 the CPU's own fp32 VGG-16 step parts from its fp64 step by 3.7e-3
    (conv1, ReLU kinks and max-pool ties that fp32 rounding flips), and
    the card's by 6.7e-3 (cuDNN's fp32 3x3 algorithms, 1.4e-3 in conv4-5
    where the CPU's is within 2.5e-5); ResNet-50's card step by 1.5e-3 in
    stage 4's bn3 scales, where the fast variance E[x²] - E[x]² loses
    digits to the card's fp32 sums (the CPU sums float in double: 5.8e-6).
    Measured in the first card runs of this phase, on cuDNN's default
    algorithms; the card's steps now run on its deterministic ones."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.data.device_ingest import \
        make_device_finish
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.ops.batch_norm import batch_stats_of
    from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
    from distributed_vgg_f_tpu_torch.train.state import TrainState
    from distributed_vgg_f_tpu_torch.train.step import build_train_step
    from distributed_vgg_f_tpu_torch.weights import (init_batch_stats,
                                                      init_params,
                                                      load_params)
    t0 = time.perf_counter()
    size = cfg.data.image_size
    model_cfg = dataclasses.replace(cfg.model, compute_dtype="float32",
                                    dropout_rate=0.0)
    tree = init_params(model_cfg, 0, image_size=size)
    stats0 = init_batch_stats(model_cfg)
    # past the warmup's zero: the step's update is its gradient's
    opt_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, warmup_epochs=0.0))
    rng = np.random.default_rng(2)
    batch = {"image": rng.integers(0, 256, (2, size, size, 3), np.uint8),
             "label": rng.integers(0, cfg.model.num_classes, (2,))}
    finish = make_device_finish(cfg.data.mean_rgb, cfg.data.stddev_rgb)
    out = {}
    before = _hand_kernel_counts()
    # the card's steps on cuDNN's deterministic algorithms, so the gaps
    # below are the same in every run (see cudnn_deterministic)
    with cudnn_deterministic():
        for run, dev, dtype in (("fp64", "cpu", torch.float64),
                                ("cpu", "cpu", torch.float32),
                                ("cuda", "cuda", torch.float32),
                                ("cuda64", "cuda", torch.float64)):
            model = load_params(build_model(model_cfg, image_size=size),
                                tree, stats0).to(dev, dtype)
            model.compute_dtype = dtype
            p0 = {k: p.detach().cpu().double().clone()
                  for k, p in model.named_parameters()}
            opt, schedule = build_optimizer(opt_cfg, model.parameters())
            state = TrainState.create(model, opt)
            step = build_train_step(schedule, cfg.optim.weight_decay,
                                    skip_nonfinite=True,
                                    device_finish=finish, device=dev)
            state, metrics = step(state, batch, 0)
            torch.cuda.synchronize()
            out[run] = {
                "loss": float(metrics["loss"]),
                "grads": {k: p.grad.cpu().double()
                          for k, p in model.named_parameters()},
                "updates": {k: p.detach().cpu().double() - p0[k]
                            for k, p in model.named_parameters()},
                "stats": {k: v.cpu().double()
                          for k, v in batch_stats_of(model).items()}}
            del model, opt, state
    gc.collect()
    torch.cuda.empty_cache()
    check(_hand_kernel_counts() == before, f"{name} launched a hand kernel")
    ref, cpu, card, card64 = (out["fp64"], out["cpu"], out["cuda"],
                              out["cuda64"])
    tol, tol64 = 1e-2, 1e-6
    errs, cpu_errs, vs_cpu, errs64 = {}, {}, {}, {}
    for part in ("grads", "updates", "stats"):
        for table, got in ((errs, card), (cpu_errs, cpu), (errs64, card64)):
            table[part] = {k: _rel_l2(got[part][k], ref[part][k])
                           for k in ref[part]}
        vs_cpu[part] = {k: _rel_l2(card[part][k], cpu[part][k])
                        for k in ref[part]}
    spread = max(max(e.values(), default=0.0) for e in cpu_errs.values())
    loss_err = abs(card["loss"] - ref["loss"]) / abs(ref["loss"])
    zero = sorted(k for k, g in ref["grads"].items()
                  if not bool(g.abs().max() > 0))

    def worst(e):
        return sorted(e.items(), key=lambda kv: -kv[1])[:3]

    emit("zoo_train_parity", model=name, batch=2, image_size=size,
         dtype="float32", tf32=False, reference="cpu float64",
         loss_card=card["loss"], loss_cpu=cpu["loss"],
         loss_fp64=ref["loss"], loss_rel_err=loss_err, tolerance_rel_l2=tol,
         max_rel_l2={part: max(e.values()) if e else None
                     for part, e in errs.items()},
         cpu_fp32_max_rel_l2={part: max(e.values()) if e else None
                              for part, e in cpu_errs.items()},
         card_vs_cpu_fp32_max_rel_l2={part: max(e.values()) if e else None
                                      for part, e in vs_cpu.items()},
         worst={part: worst(e) for part, e in errs.items()},
         cpu_fp32_spread=spread,
         card_fp64_max_rel_l2={part: max(e.values()) if e else None
                               for part, e in errs64.items()},
         tolerance_fp64_rel_l2=tol64,
         leaves=len(ref["grads"]), zero_grad_leaves=len(zero),
         stat_leaves=len(ref["stats"]), seconds=time.perf_counter() - t0)
    check(loss_err <= 1e-4, f"{name} loss card {card['loss']} fp64 "
          f"{ref['loss']}")
    for part in errs:
        bad = {k: v for k, v in errs64[part].items() if v > tol64}
        check(not bad, f"{name} {part}: the card's fp64 step is not the "
              f"CPU's: {bad}")
        bad = {k: v for k, v in errs[part].items() if v > tol}
        check(not bad, f"{name} {part} off the fp64 step: {bad}")
    check(all(bool(v.abs().max() > 0) for k, v in card["stats"].items()
              if k.endswith(".mean")),
          f"{name}: the step left a running mean at its init")


def phase_zoo_train(name, preset):
    """Trainer.fit on a zoo preset at full width (bf16, the preset's
    dropout, flip, mixup, the non-finite skip, its LR schedule) for 20
    steps on one seeded u8 batch of 256 — the preset's global 1024 over
    four cards, cut to one card's share — then a torch.profiler breakdown
    of 3 more steps."""
    import dataclasses

    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = get_config(preset)
    steps = 20
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data,
                                      global_batch_size=_ZOO_BATCH),
        train=dataclasses.replace(cfg.train, log_every=1, seed=0))
    b, size = cfg.data.global_batch_size, cfg.data.image_size
    data = SyntheticU8(b, size, cfg.model.num_classes, seed=0, pin=True)
    stamps = []
    trainer = Trainer(cfg, log=lambda event, rec: stamps.append(
        time.perf_counter()) if event == "train" else None)
    state = trainer.init_state(0)
    stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _hand_kernel_counts()
    t0 = time.perf_counter()
    state = trainer.fit(state, data, num_steps=steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches_same = _hand_kernel_counts() == before
    recs = [r for r in trainer.records if r["event"] == "train"]
    losses = [r["loss"] for r in recs]
    stamps.insert(0, t0)
    step_ms = [(t1 - t0_) * 1e3 for t0_, t1 in zip(stamps, stamps[1:])]
    median_ms = statistics.median(step_ms[4:])
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    moved = sum(int(not torch.equal(v, stats0[k]))
                for k, v in state.batch_stats.items())
    profile = _profile_train(trainer, state, next(iter(data)))
    emit("zoo_train", model=name, config=cfg.name, image_size=size,
         batch=b, preset_global_batch=get_config(preset).data
         .global_batch_size, cut="batch 256 = the preset's 1024 over four "
         "cards; 20 steps; one seeded u8 batch; one card",
         num_classes=cfg.model.num_classes,
         compute_dtype=cfg.model.compute_dtype,
         dropout_rate=cfg.model.dropout_rate,
         augment={"hflip": cfg.data.augment.hflip,
                  "mixup_alpha": cfg.data.augment.mixup_alpha},
         skip_nonfinite=cfg.train.skip_nonfinite, steps=steps,
         lr=[r["lr"] for r in recs], wall_s=wall_s,
         first_step_ms=step_ms[0], step_ms_median=median_ms,
         step_ms=step_ms, images_per_s=b / (median_ms / 1e3),
         meter_images_per_sec=recs[-1]["images_per_sec"],
         peak_memory_bytes=peak, allocated_before_fit_bytes=allocated_before,
         losses=losses, grad_norms=[r["grad_norm"] for r in recs],
         loss_first5_mean=first, loss_last5_mean=last,
         loss_fell=last < first, stat_leaves_moved=moved,
         stat_leaves=len(stats0), hand_kernel_launches=0
         if launches_same else "nonzero", profile=profile)
    check(state.step == steps + profile["steps"] and len(recs) == steps,
          f"{name}: {state.step} steps, {len(recs)} records")
    check(launches_same, f"{name} launched a hand kernel")
    check(all(math.isfinite(v) for v in losses), f"{name} losses {losses}")
    check(all(r["bad_step"] == 0.0 for r in recs), f"{name}: a step was "
          "skipped")
    check(moved == len(stats0), f"{name}: {moved} of {len(stats0)} "
          "statistics moved")
    del trainer, state, data
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms_median": median_ms, "peak_memory_bytes": peak}


def phases_zoo():
    """zoo_model, zoo_train_parity and zoo_train for VGG-16 and
    ResNet-50."""
    tmp = tempfile.mkdtemp(prefix="zoo_")
    try:
        for name, preset in _ZOO:
            cfg, _, _ = phase_zoo_model(name, preset, tmp)
            phase_zoo_train_parity(name, cfg)
            phase_zoo_train(name, preset)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    forward_ms = _forward_ms({"e": engine}, imgs, engine.buckets)["e"]

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

    # (a) the one-rank NCCL group phase train_zero2 started (NCCL puts no
    # two ranks on one card); initialize_distributed leaves it as it is
    check(dist.is_initialized(), "no process group is up")
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
    import importlib
    # the entry points and planes of the port, imported here as well so
    # the check covers them whichever phases ran
    port = ["distributed_vgg_f_tpu_torch.cli",
            "distributed_vgg_f_tpu_torch.parallel.preempt",
            "distributed_vgg_f_tpu_torch.utils.logging",
            "distributed_vgg_f_tpu_torch.train.predict",
            "distributed_vgg_f_tpu_torch.serving.tiers",
            "distributed_vgg_f_tpu_torch.serving.controller",
            "distributed_vgg_f_tpu_torch.data.teacher",
            "distributed_vgg_f_tpu_torch.train.distill"]
    for name in port:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if any(m == r or m.startswith(r + ".")
                        for r in ("jax", "jaxlib", "flax",
                                  "distributed_vgg_f_tpu")))
    check(bad == [], f"JAX-side modules imported: {bad}")
    emit("isolation", forbidden_modules=bad, port_modules_checked=port)


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
    serve_tiers_launches = phase_serve_tiers(tree)
    serve_cli_launches = phase_serve_cli()
    distill_launches = phase_distill()
    phase_train_parity(tree)
    phase_stem(tree)
    train_launches, train_ref = phase_train()
    augment_launches = phase_train_augment(train_ref)
    zero2_launches, zero2_ref = phase_train_zero2(tree, train_ref)
    zero3_launches = phase_train_zero3(tree, zero2_ref)
    feed_dir = tempfile.mkdtemp(prefix="train_feed_")
    try:
        feed_launches, feed_ms = phase_train_feed(train_ref, feed_dir)
        ckpt_launches = phase_train_ckpt(train_ref["step_ms_median"],
                                         feed_ms, feed_dir, smi)
        e2e_launches = phase_train_e2e(feed_dir, train_ref["step_ms_median"],
                                       feed_ms, smi)
        autotune_launches = phase_train_autotune(feed_dir, smi)
        snapshot_launches = phase_train_snapshot(feed_dir, smi)
    finally:
        shutil.rmtree(feed_dir, ignore_errors=True)
    del tree
    phases_zoo()

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
                and r["site"] in ("conv1", "conv2")
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
                and r["site"] in ("conv1", "conv2")
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
        serve_launches + serve_tiers_launches + serve_cli_launches
        + distill_launches["fwd"] + train_launches["fwd"]
        + augment_launches["fwd"]
        + zero2_launches["fwd"] + zero3_launches["fwd"]
        + feed_launches["fwd"] + ckpt_launches["fwd"] + e2e_launches["fwd"]
        + autotune_launches["fwd"] + snapshot_launches["fwd"],
        {"serve": serve_launches, "serve_tiers": serve_tiers_launches,
         "serve_cli": serve_cli_launches,
         "distill": distill_launches["fwd"], "train": train_launches["fwd"],
         "train_augment": augment_launches["fwd"],
         "train_zero2": zero2_launches["fwd"],
         "train_zero3": zero3_launches["fwd"],
         "train_feed": feed_launches["fwd"],
         "train_ckpt": ckpt_launches["fwd"],
         "train_e2e": e2e_launches["fwd"],
         "train_autotune": autotune_launches["fwd"],
         "train_snapshot": snapshot_launches["fwd"]},
        "both LRN sites of one bf16 forward at bucket 32, ReLU fused")
    at32 = lrn_times(lrn_sites(records, "bucket", 32), "relu_ms")
    lrn_fwd_row.update(
        variant="vector", fused_relu=True, unfused_ms=at32["unfused_ms"],
        relu_ms=at32["relu_ms"],
        batch1024=lrn_times(lrn_sites(records, "bucket", 1024), "relu_ms"))
    lrn_bwd_row = summary(
        "lrn_bwd", "distributed_vgg_f_tpu_torch/csrc/lrn_bwd.cu",
        "distributed_vgg_f_tpu/ops/lrn_pallas.py:74", bwd_records, "batch",
        1024, distill_launches["bwd"] + train_launches["bwd"]
        + augment_launches["bwd"]
        + zero2_launches["bwd"] + zero3_launches["bwd"]
        + feed_launches["bwd"] + ckpt_launches["bwd"] + e2e_launches["bwd"]
        + autotune_launches["bwd"] + snapshot_launches["bwd"],
        {"serve": 0, "serve_tiers": 0, "serve_cli": 0,
         "distill": distill_launches["bwd"],
         "train": train_launches["bwd"],
         "train_augment": augment_launches["bwd"],
         "train_zero2": zero2_launches["bwd"],
         "train_zero3": zero3_launches["bwd"],
         "train_feed": feed_launches["bwd"],
         "train_ckpt": ckpt_launches["bwd"],
         "train_e2e": e2e_launches["bwd"],
         "train_autotune": autotune_launches["bwd"],
         "train_snapshot": snapshot_launches["bwd"]},
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

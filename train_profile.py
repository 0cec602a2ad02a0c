#!/usr/bin/env python3
"""VGG-F's training step on one NVIDIA GPU, timed and broken down by kernel.

    python3 train_profile.py [--steps 20] [--label NAME]

Trains the flagship `vggf_imagenet_dp` of the PyTorch/CUDA port
(distributed_vgg_f_tpu_torch) at full width, batch 1024, bf16, on one
fixed seeded u8 batch for --steps steps through `Trainer.fit`, then
profiles 3 more steps with torch.profiler. Prints one JSON line: the
median step ms (after the first 4 steps), images/s, peak device memory,
and per step the device's busy time and idle share, the LRN kernels'
device time, every ReLU pass outside them (torch's relu runs as a
clamp_min kernel, its backward as threshold_backward) and the top kernels
by device time; then the card's name and power limit.

It uses only the port's training API as it stands since VGG-F's training
slice (Trainer, SyntheticU8, the kernel build on first use), so a copy of
this file at the root of a checkout of an earlier commit of the port times
that commit. Running both from one card call compares two trees on one
card: parent, change, change, parent. Without a CUDA device it exits 2.
"""

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch


def _breakdown(prof, count, top=12):
    """Device time by kernel per step, the busy time (union of kernel and
    copy spans) and idle share of the traced window."""
    events = list(prof.events())
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in sorted((e.time_range.start, e.time_range.end)
                         for e in device):
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))

    def total(*keys):
        return sum(v for k, v in by_name.items()
                   if any(key in k for key in keys)) / count

    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"window_us": window / count, "busy_us": busy / count,
            "idle_share": 1.0 - busy / window,
            "lrn_fwd_us": total("lrn_fwd"), "lrn_bwd_us": total("lrn_bwd"),
            "relu_fwd_us": total("clamp"), "relu_bwd_us": total("threshold"),
            "top_us": [[k[:100], v / count] for k, v in ranked]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer

    cfg = get_config("vggf_imagenet_dp")
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
    t0 = time.perf_counter()
    state = trainer.fit(state, data, num_steps=args.steps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stamps.insert(0, t0)
    step_ms = [(t1 - t0_) * 1e3 for t0_, t1 in zip(stamps, stamps[1:])]
    median_ms = statistics.median(step_ms[4:])
    batch = next(iter(data))
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch, cfg.train.seed)
        torch.cuda.synchronize()
    t = _breakdown(prof, steps)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    print(json.dumps({
        "label": args.label, "config": cfg.name, "batch": b,
        "image_size": size, "compute_dtype": cfg.model.compute_dtype,
        "steps": args.steps, "step_ms_median": median_ms,
        "step_ms": step_ms, "images_per_s": b / (median_ms / 1e3),
        "peak_memory_bytes": peak,
        "losses": [r["loss"] for r in trainer.records
                   if r["event"] == "train"],
        "profile_steps": steps,
        **{f"{k}_per_step" if k != "idle_share" else k: v
           for k, v in t.items()}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

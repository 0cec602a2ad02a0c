"""ZeRO-3 beside ZeRO-2 on four CUDA cards, without the host feed: the
flagship preset (bf16, dropout, flip, mixup, 4 MB buckets) through
`Trainer.fit` in a 4-rank NCCL group, one card a rank, on seeded u8
batches (256 a card), with `mesh.shard_params` off and on in turns
(ZeRO-2, ZeRO-3, ZeRO-2, ... for `--pairs` pairs). Each fit runs
`--steps` steps and a torch.profiler window of 3 more
(tests/_torch_dp_worker.py's `trainer` case). It imports torch, numpy
and the port only.

    python -m tools.torch_zero3_probe [--pairs 2] [--steps 20] [--out FILE]

Prints the card's name and power limit, then one JSON object a fit: each
rank's median step ms (steps 5 on), peak memory, the losses, the LRN
launches, `comm_meta`, and each rank's device busy and idle share, NCCL
and copy µs a step. Exits 1 without four CUDA cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("torch_zero3_probe: needs four CUDA devices", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    from _torch_dp_worker import run_group
    lines = [subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()]
    cases = [dict(name=f"{basis}_{i}", trainer="vggf_imagenet_dp",
                  steps=args.steps,
                  overrides={"mesh.shard_params": "true" if basis == "zero3"
                             else "false"})
             for i in range(args.pairs) for basis in ("zero2", "zero3")]
    spec = {"widths": {}, "size": 224, "classes": 1000, "batch": 1024,
            "lr": 0.04, "weight_decay": 5e-4, "cases": cases}
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_group(4, spec, {}, tmp, timeout=1200, device="cuda")
    for case in cases:
        n = case["name"]
        profiles = [json.loads(str(o[f"{n}/profile"])) for o in outs]
        lines.append(json.dumps({
            "fit": n, "steps": args.steps,
            "step_ms_median": [float(np.median(o[f"{n}/step_ms"][4:]))
                               for o in outs],
            "peak_memory_bytes": [int(o[f"{n}/peak_memory_bytes"])
                                  for o in outs],
            "losses": outs[0][f"{n}/loss"].tolist(),
            "lrn_launches": outs[0][f"{n}/lrn_launches"].tolist(),
            "comm_meta": json.loads(str(outs[0][f"{n}/comm_meta"])),
            "busy_us": [p["busy_us"] for p in profiles],
            "idle_share": [p["idle_share"] for p in profiles],
            "nccl_us": [p["nccl_us"] for p in profiles],
            "copy_us": [p["copy_us"] for p in profiles]}))
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

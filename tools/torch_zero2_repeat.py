"""How far the flagship's fp32 steps on a CUDA card move from run to run,
and whether the ZeRO-2 step stays on the replicated one.
`chip_smoke.zero2_runs` (phase `train_zero2` (a): the flagship at full
width in fp32, batch 2, 3 steps from the seed-0 weights) is repeated
`--iters` times with cuDNN's default algorithms and `--iters` times with
its deterministic ones; then, with the deterministic ones, the replicated
step runs from weights moved by one ulp in random places (`--nudges`
seeds), which measures how far a last-bit difference grows in 3 steps.
It imports torch, numpy and the port only, and builds the LRN kernels.

    python -m tools.torch_zero2_repeat [--iters 10] [--nudges 4] [--out FILE]

Prints the card's name and power limit, then one JSON object a run: the
ZeRO-2 run against the replicated run of the same iteration, and the
replicated run against the first replicated run of its mode (or, for a
nudge, against the deterministic mode's first): the largest relative
loss gap, the largest per-leaf relative L2 of the params and the
momentum, the leaf it falls on, and whether the params are bit-equal.
Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _gaps(run: dict, ref: dict) -> dict:
    from chip_smoke import _rel_l2
    params = {k: _rel_l2(v, ref["params"][k]) for k, v in
              run["params"].items()}
    moms = {k: _rel_l2(v, ref["momentum"][k]) for k, v in
            run["momentum"].items()}
    worst = max(params, key=params.get)
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in
                            zip(run["losses"], ref["losses"])),
            "param_rel_l2_max": params[worst], "param_worst_leaf": worst,
            "momentum_rel_l2_max": max(moms.values()),
            "momentum_worst_leaf": max(moms, key=moms.get),
            "params_bit_equal": all(torch.equal(v, ref["params"][k])
                                    for k, v in run["params"].items())}


def _nudge(a, rng) -> np.ndarray:
    """`a` as float32 with the last mantissa bit flipped in about half
    of its elements."""
    out = np.array(a, dtype=np.float32, copy=True)
    bits = out.view(np.uint32)
    bits ^= (rng.random(out.shape) < 0.5).astype(np.uint32)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--nudges", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_zero2_repeat: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.kernels import build
    from distributed_vgg_f_tpu_torch.parallel.distributed import \
        initialize_distributed
    from distributed_vgg_f_tpu_torch.weights import init_params
    out = open(args.out, "w") if args.out else None

    def emit(**kw):
        line = json.dumps(kw)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), torch=torch.__version__)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    initialize_distributed(f"localhost:{chip_smoke._free_port()}", 1, 0,
                           device="cuda")
    cfg = get_config("vggf_imagenet_dp")
    tree = init_params(cfg.model, 0, image_size=cfg.data.image_size)
    first = {}
    for mode in ("default", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        for i in range(args.iters):
            t0 = time.perf_counter()
            runs = chip_smoke.zero2_runs(tree, ("replicated", "zero2"))
            rep, z2 = runs["replicated"], runs["zero2"]
            first.setdefault(mode, rep)
            emit(mode=mode, iter=i, losses=rep["losses"],
                 zero2_vs_replicated=_gaps(z2, rep),
                 replicated_vs_first=_gaps(rep, first[mode]),
                 seconds=time.perf_counter() - t0)
            del runs, rep, z2
    torch.backends.cudnn.deterministic = True
    for seed in range(args.nudges):
        rng = np.random.default_rng(1000 + seed)
        nudged = {layer: {k: _nudge(a, rng) for k, a in leaves.items()}
                  for layer, leaves in tree.items()}
        rep = chip_smoke.zero2_runs(nudged, ("replicated",))["replicated"]
        emit(mode="nudged", seed=seed, losses=rep["losses"],
             replicated_vs_first=_gaps(rep, first["deterministic"]))
        del rep
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

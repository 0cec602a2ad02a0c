"""Whether the zoo presets' own global batch fits one CUDA card: the
port's `Trainer.fit` on `vgg16_imagenet` and `resnet50_imagenet` at full
width (224 px, 1000 classes, bf16, the preset's dropout, flip, mixup and
skip) on one seeded u8 batch of the preset's global 1024, for `--steps`
steps. It imports torch, numpy and the port only.

    python -m tools.torch_zoo_probe [--steps 3] [--batch 1024] [--out FILE]

Each preset prints one JSON object: `fits` with the peak device memory
(`torch.cuda.max_memory_allocated`), the step ms a step and the losses;
or, when the card runs out of memory, `fits: false` with the error's
first line and the peak reached before it. The card's name and power
limit (nvidia-smi) come first. Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time

import torch

PRESETS = ("vgg16_imagenet", "resnet50_imagenet")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def probe(preset: str, batch: int, steps: int) -> dict:
    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = get_config(preset)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, global_batch_size=batch),
        train=dataclasses.replace(cfg.train, log_every=1, seed=0))
    stamps = []
    out = {"preset": preset, "batch": batch, "steps": steps,
           "compute_dtype": cfg.model.compute_dtype}
    trainer = state = data = None
    try:
        trainer = Trainer(cfg, log=lambda e, p: stamps.append(
            time.perf_counter()) if e == "train" else None)
        state = trainer.init_state(0)
        data = SyntheticU8(batch, cfg.data.image_size, cfg.model.num_classes,
                           seed=0, pin=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = trainer.fit(state, data, num_steps=steps)
        torch.cuda.synchronize()
        stamps.insert(0, t0)
        out.update(fits=True,
                   step_ms=[(b - a) * 1e3 for a, b in zip(stamps,
                                                          stamps[1:])],
                   losses=[r["loss"] for r in trainer.records
                           if r["event"] == "train"])
    except torch.cuda.OutOfMemoryError as e:
        out.update(fits=False, error=str(e).splitlines()[0])
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["card_bytes"] = torch.cuda.get_device_properties(0).total_memory
    del trainer, state, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_zoo_probe: no CUDA device", file=sys.stderr)
        return 1
    lines = [{"card": _smi(), "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    for preset in PRESETS:
        lines.append(probe(preset, args.batch, args.steps))
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(rec) + "\n" for rec in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two measurements of the port's flagship training on one CUDA card, on
TFRecords of the JPEG fixture (tests/data/jpeg_fixture: 16 JPEGs packed
into 4 train shards of 1024 records and 1200 validation records, as
chip_smoke.py packs them). It imports torch, numpy and the port only.

    python -m tools.torch_flagship_probe [--steps 30] [--out FILE]

(a) `lr`: the preset's learning rate on this data. `Trainer.fit` through
    the trainer-owned feed, a record every step, in five variants: the
    preset as it is (bf16, dropout 0.5, flip, mixup 0.2, base_lr 0.01
    scaled to 0.04 at batch 1024, no warmup); bf16 and fp32 with
    dropout, flip and mixup off at the preset's LR; fp32 with them off
    at base_lr 0.001; the preset at base_lr 0.001. Each prints its
    per-step losses, its non-finite skips, and the step at which the
    non-finite guard aborted it, if it did.
(b) `gaps`: where chip_smoke.py phase train_e2e's extra step time over
    phase train_feed's comes from. The same fit at base_lr 0.001 for
    `--steps` steps in six runs: as train_feed (no checkpoints, no eval,
    cuDNN free to choose), with cuDNN deterministic, with a checkpoint
    every 10 steps, with the eval split evaluated every 10 steps, with
    all three (as train_e2e), and as train_feed again. Each prints the
    median ms between consecutive step records over the steps after
    the fourth, with and without the gaps that hold an eval or a save,
    and the median host-wait fraction of its one-step records.

One JSON object a line on stdout (and in FILE with --out), the card's
name and power limit (nvidia-smi) first. Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")


def _pack(out_dir: str) -> None:
    sys.path.insert(0, REPO)
    from tools.tfrecord_write import write_shards
    jpegs = []
    for f in sorted(f for f in os.listdir(FIXTURE) if f.endswith(".jpg")):
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            jpegs.append(fh.read())
    labels = [1 + (61 * k) % 1000 for k in range(len(jpegs))]
    write_shards(out_dir, jpegs, labels, shards=4, per_shard=1024)
    write_shards(out_dir, jpegs, labels, shards=2, per_shard=600,
                 prefix="validation")


def _config(data_dir: str, sets: dict):
    from distributed_vgg_f_tpu_torch import config as tcfg
    return tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"), {
        "data.data_dir": data_dir, "train.seed": "0", "train.log_every": "1",
        **sets})


def _fit(cfg, steps: int, evals: bool = False):
    """(train records, the perf_counter stamp of each, the error that
    ended the run or None)."""
    from distributed_vgg_f_tpu_torch.resilience.guard import \
        NonFiniteStepError
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    stamps = []
    trainer = Trainer(cfg, log=lambda event, rec: stamps.append(
        time.perf_counter()) if event == "train" else None)
    state = trainer.init_state()
    error = None
    try:
        trainer.fit(state, num_steps=steps,
                    eval_dataset=trainer.make_dataset("eval")
                    if evals else None)
    except NonFiniteStepError as e:   # the guard's abort is a result
        error = str(e)
    torch.cuda.synchronize()
    train = [r for r in trainer.records if r["event"] == "train"]
    del trainer, state
    torch.cuda.empty_cache()
    return train, stamps, error


LR_VARIANTS = (
    ("preset", {}),
    ("bf16_plain_preset_lr", {"model.dropout_rate": "0.0",
                              "data.augment.enabled": "false"}),
    ("fp32_plain_preset_lr", {"model.compute_dtype": "float32",
                              "model.dropout_rate": "0.0",
                              "data.augment.enabled": "false"}),
    ("fp32_plain_lr0.001", {"model.compute_dtype": "float32",
                            "model.dropout_rate": "0.0",
                            "data.augment.enabled": "false",
                            "optim.base_lr": "0.001"}),
    ("preset_lr0.001", {"optim.base_lr": "0.001"}),
)


def probe_lr(data_dir: str, steps: int):
    for name, sets in LR_VARIANTS:
        cfg = _config(data_dir, sets)
        t0 = time.perf_counter()
        train, _, error = _fit(cfg, steps)
        yield {"part": "lr", "variant": name, "sets": sets,
               "lr": cfg.scaled_lr, "steps": steps,
               "losses": [r["loss"] for r in train],
               "nonfinite_skips": max([r.get("nonfinite_skips", 0)
                                       for r in train] or [0]),
               "first_nonfinite_loss_step": next(
                   (r["step"] for r in train
                    if not math.isfinite(r["loss"])), None),
               "aborted": error, "wall_s": time.perf_counter() - t0}


def probe_gaps(data_dir: str, steps: int):
    scratch = tempfile.mkdtemp(prefix="probe_ck_")
    runs = (("feed", False, False, False), ("e2e", True, True, True),
            ("deterministic", True, False, False),
            ("checkpoints", False, True, False), ("eval", False, False, True),
            ("feed_again", False, False, False))
    try:
        for i, (name, det, ckpt, evals) in enumerate(runs):
            sets = {"optim.base_lr": "0.001",
                    "train.eval_every_steps": "10"}
            if ckpt:
                sets.update({"train.checkpoint_dir":
                             os.path.join(scratch, str(i)),
                             "train.checkpoint_every_steps": "10"})
            cfg = _config(data_dir, sets)
            torch.backends.cudnn.deterministic = det
            try:
                train, stamps, error = _fit(cfg, steps, evals)
            finally:
                torch.backends.cudnn.deterministic = False
            # gap k ends at record k + 1; an eval and a save follow the
            # record of a step that is a multiple of 10
            gaps = [(r["step"], (t1 - t0) * 1e3) for r, t0, t1 in
                    zip(train, stamps, stamps[1:])][4:]
            quiet = [ms for s, ms in gaps if s % 10]
            yield {"part": "gaps", "run": name, "deterministic": det,
                   "checkpoint_every": 10 if ckpt else None,
                   "eval_every": 10 if evals else None, "steps": steps,
                   "step_ms_median": statistics.median(
                       [ms for _, ms in gaps]),
                   "step_ms_median_without_eval_or_save":
                       statistics.median(quiet),
                   "gap_ms": [ms for _, ms in gaps],
                   "host_wait_fraction_median": statistics.median(
                       r["host_wait_fraction"] for r in train[4:]),
                   "aborted": error}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--part", choices=("lr", "gaps", "both"),
                        default="both")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps({"card": card, **obj})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    data_dir = tempfile.mkdtemp(prefix="probe_data_")
    try:
        _pack(data_dir)
        if args.part in ("lr", "both"):
            for row in probe_lr(data_dir, args.steps):
                emit(row)
        if args.part in ("gaps", "both"):
            for row in probe_gaps(data_dir, args.steps):
                emit(row)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

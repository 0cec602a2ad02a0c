"""Console entry point of the port (`dvggf-torch-train`, or
``python -m distributed_vgg_f_tpu_torch.cli``) — the counterpart of the
JAX package's `cli.py`, with its modes and `--set` keys:

    python -m distributed_vgg_f_tpu_torch.cli --config vggf_imagenet_dp \\
        --set data.data_dir=/data/imagenet --set train.checkpoint_dir=/ckpt
    python -m distributed_vgg_f_tpu_torch.cli --mode eval \\
        --set data.data_dir=/data/imagenet --set train.checkpoint_dir=/ckpt
    python -m distributed_vgg_f_tpu_torch.cli --mode predict \\
        --set train.checkpoint_dir=/ckpt --images a.jpg photos/
    python -m distributed_vgg_f_tpu_torch.cli --mode serve \\
        --set train.checkpoint_dir=/ckpt --set serving.enabled=true
    torchrun --nproc_per_node 4 -m distributed_vgg_f_tpu_torch.cli ...

`--config` defaults to the flagship, `vggf_imagenet_dp` (config.py
`parse_cli`). Train mode fits from the newest checkpoint (or from
scratch) with the validation split as the eval cadence's dataset
(`eval_dataset_unavailable` logged when there is none), stops cleanly
on SIGTERM with a forced save, and resumes on the next start; `--mode
eval` runs one exact pass over the validation split, `--mode predict`
classifies `--images`; both need a checkpoint. `--mode serve` starts the
predict server over the checkpoint (serving/server.py
`serve_from_trainer`, with the tier ladder under
`serving.tiers.enabled=true`), prints ``serving on HOST:PORT`` (port 0
binds a free one) and serves until SIGINT, then drains and exits 0. It
needs the double opt-in: the mode and `serving.enabled=true`.

Under `torchrun` (WORLD_SIZE > 1 with MASTER_ADDR, MASTER_PORT and RANK
set) the process group starts through parallel/distributed.py
`initialize_distributed`: NCCL with one card a rank (LOCAL_RANK's), gloo
when the caller asks for the CPU. Rank 0 writes the records to
`<checkpoint_dir>/metrics.jsonl` (telemetry/schema.py) and stdout.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

import torch


def _start_group(device: Optional[str]) -> bool:
    """The torchrun environment's process group, when there is one;
    True when this call started it (the caller destroys it)."""
    from distributed_vgg_f_tpu_torch.parallel.distributed import \
        initialize_distributed
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or torch.distributed.is_initialized():
        return False
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK")
               if k not in os.environ]
    if missing:
        raise SystemExit(f"WORLD_SIZE={world} but {missing} unset: start "
                         "a multi-process run under torchrun")
    rank = int(os.environ["RANK"])
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda":
        # one card a rank: LOCAL_RANK's, before NCCL binds a device
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    initialize_distributed(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world,
        rank, device=kind)
    return True


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> None:
    """Run one mode of the command line. `device` is for library callers
    and tests (`"cpu"`); the console always runs on the card."""
    from distributed_vgg_f_tpu_torch.config import parse_cli
    from distributed_vgg_f_tpu_torch.parallel.collectives import \
        rank_and_size
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    from distributed_vgg_f_tpu_torch.utils.logging import MetricLogger

    cfg, args = parse_cli(argv, with_mode=True)
    mode = args.mode
    if mode == "serve" and not cfg.serving.enabled:
        # the mode names the intent, the config flag arms the server: a
        # mistyped --mode never starts listening
        raise SystemExit(
            "serve mode: serving is disabled — pass "
            "--set serving.enabled=true (the server is off by "
            "default; see README 'Serving')")
    started = _start_group(device)
    try:
        jsonl = (os.path.join(cfg.train.checkpoint_dir, "metrics.jsonl")
                 if cfg.train.checkpoint_dir else None)
        rank = rank_and_size()[0]
        # records are rank 0's (as the JAX package logs on process 0):
        # the other ranks open no file
        with MetricLogger(jsonl_path=jsonl if rank == 0 else None) as logger:
            trainer = Trainer(cfg, device=device, log=logger.log)

            def require_checkpoint():
                # eval and predict never score random weights
                if trainer.checkpoints is None \
                        or trainer.checkpoints.latest_step() is None:
                    raise SystemExit(
                        f"{mode} mode: no checkpoint found under "
                        f"{cfg.train.checkpoint_dir!r} (set "
                        "train.checkpoint_dir to a directory holding "
                        "checkpoints)")

            if mode == "serve":
                from distributed_vgg_f_tpu_torch.serving.server import \
                    serve_from_trainer
                require_checkpoint()
                server = serve_from_trainer(trainer)
                # launchers read the bound port from this line
                print(f"serving on {server.endpoint}", flush=True)
                try:
                    server.wait()
                except KeyboardInterrupt:
                    pass
                finally:
                    server.close()
                return
            if mode == "predict":
                from distributed_vgg_f_tpu_torch.train.predict import \
                    run_predict
                require_checkpoint()
                if not args.images:
                    raise SystemExit("predict mode: pass --images "
                                     "<files/dirs>")
                run_predict(trainer, args.images)
                return
            if mode == "eval":
                require_checkpoint()
                trainer.evaluate(trainer.restore_or_init(),
                                 trainer.make_dataset("eval"))
                return
            eval_ds = None
            try:
                eval_ds = trainer.make_dataset("eval")
            except (FileNotFoundError, NotADirectoryError, ValueError) as e:
                # the train-mode eval cadence is best effort (no split
                # yet), but said; anything else propagates
                trainer.log("eval_dataset_unavailable", {"error": repr(e)})
            trainer.fit(eval_dataset=eval_ds)
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

"""One rank of a process group that runs the port's zoo models with
sync-BN, for tests/test_torch_sync_bn.py, tests/test_torch_zoo_trainer.py
and the four-card case of tests/test_torch_cuda.py. It imports only
torch, numpy and the port.

    python tests/_torch_zoo_worker.py RANK WORLD PORT SPEC.npz OUT_DIR [cuda]

SPEC.npz holds `spec` (JSON: a list of `cases`) and the arrays the cases
name. Rank r of n takes rows r*B/n .. (r+1)*B/n - 1 of every global
array it splits. The group is gloo on the CPU, or NCCL with one card a
rank when the last argument is "cuda" (TF32 off there).

- `bn`: ops/batch_norm.py's `BatchNorm` (axis `axis`, dtype `dtype`) in
  training mode on this rank's rows of ``<case>/x`` (N, C, H, W) with
  ``<case>/scale`` and ``<case>/bias``, then the backward of
  sum(y * dy) with this rank's rows of ``<case>/dy``; writes `y`, `dx`
  (this rank's rows), `dscale`, `dbias` (this rank's gradients of its
  own loss), and the running `mean` and `var`. Also the gradient of
  sum(pmean(p) * w) for this rank's row p, w of ``<case>/p``,
  ``<case>/w`` (`pmean`, `pmean_grad`).
- `fit`: `Trainer.fit` on the preset `preset` with the dotted
  `overrides` and `extra` (the model's `extra`, lists as tuples), fed
  this rank's rows of ``batch<i>/image`` and ``batch<i>/label`` for
  `steps` steps from `first_batch`, from `restore_or_init()` (a
  checkpoint directory in the overrides resumes); writes `loss`,
  `bad_step`, `restored_step` (-1 for a fresh start), `step`,
  `params/<name>` and `stats/<name>` (the state_dict's parameters,
  gathered under ZeRO-3, and BatchNorm buffers), `ema/<name>` and
  `ema_stats/<name>` with an EMA, `comm_meta`, and
  the SHA-256 of the statistics' bytes (`stats_sha`).
- `timed`: `Trainer.fit` on `preset` at its own config (overrides
  allowed) for `steps` steps on this rank's share of a seeded u8 batch;
  writes the step times, losses, peak device memory, the statistics'
  SHA-256 and a torch.profiler breakdown of 3 more steps (NCCL and copy
  µs a step; tests/_torch_dp_worker.py's, as its record keeping).

`run_group` (for the tests) starts the ranks on a free port and loads
their outputs.
"""

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from _torch_dp_worker import _profile, every_rank_records  # noqa: E402
from distributed_vgg_f_tpu_torch import config as tcfg  # noqa: E402
from distributed_vgg_f_tpu_torch.ops.batch_norm import \
    BatchNorm  # noqa: E402
from distributed_vgg_f_tpu_torch.parallel.collectives import \
    pmean  # noqa: E402
from distributed_vgg_f_tpu_torch.parallel.distributed import \
    initialize_distributed  # noqa: E402


def _rows(arr, rank, world):
    n = arr.shape[0] // world
    return arr[rank * n:(rank + 1) * n]


def port_config(case: dict):
    """The case's preset with its dotted overrides and model `extra`."""
    cfg = tcfg.apply_overrides(tcfg.get_config(case.get("preset",
                                                        "resnet50_imagenet")),
                               case.get("overrides", {}))
    if "extra" in case:
        extra = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in case["extra"].items()}
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, extra=extra))
    return cfg


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_bn(case, data, rank, world, dev):
    name = case["name"]
    dtype = getattr(torch, case.get("dtype", "float32"))
    x = torch.from_numpy(_rows(data[f"{name}/x"], rank, world)).to(
        dev, dtype).requires_grad_()
    dy = torch.from_numpy(_rows(data[f"{name}/dy"], rank, world)).to(
        dev, dtype)
    bn = BatchNorm(x.shape[1], axis_name=case.get("axis", "data")).to(dev)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data[f"{name}/scale"]))
        bn.bias.copy_(torch.from_numpy(data[f"{name}/bias"]))
    y = bn(x, train=True)
    (y.float() * dy.float()).sum().backward()
    p = torch.from_numpy(data[f"{name}/p"][rank]).to(dev).requires_grad_()
    w = torch.from_numpy(data[f"{name}/w"][rank]).to(dev)
    m = pmean(p)
    (m * w).sum().backward()
    out = {"y": y.detach().float(), "dx": x.grad.float(),
           "dscale": bn.weight.grad, "dbias": bn.bias.grad,
           "mean": bn.mean, "var": bn.var, "pmean": m.detach(),
           "pmean_grad": p.grad}
    return {f"{name}/{k}": v.detach().cpu().numpy() for k, v in out.items()}


def run_fit(case, data, rank, world, dev):
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    name = case["name"]
    cfg = port_config(case)
    trainer = every_rank_records(Trainer(cfg, device=dev.type))
    first = case.get("first_batch", 0)
    batches = [{"image": _rows(data[f"batch{i}/image"], rank, world),
                "label": _rows(data[f"batch{i}/label"], rank, world)}
               for i in range(first, case["steps"])]
    state = trainer.fit(None, batches, num_steps=case["steps"])
    restored = [r["step"] for r in trainer.records
                if r["event"] == "restore"]
    recs = [r for r in trainer.records if r["event"] == "train"]
    stats = state.batch_stats
    out = {
        f"{name}/loss": np.array([r["loss"] for r in recs]),
        f"{name}/bad_step": np.array([r.get("bad_step", 0.0)
                                      for r in recs]),
        f"{name}/restored_step": np.array(restored[0] if restored else -1),
        f"{name}/step": np.array(state.step),
        f"{name}/stats_sha": np.array(_sha(stats.values())),
        f"{name}/comm_meta": np.array(json.dumps(
            trainer.train_step.comm_meta)),
    }
    for k, p in state.params_tree().items():
        out[f"{name}/params/{k}"] = p.detach().cpu().numpy()
    if state.ema_params is not None:
        for k, p in state.params_tree(ema=True).items():
            out[f"{name}/ema/{k}"] = p.detach().cpu().numpy()
    for k, v in stats.items():
        out[f"{name}/stats/{k}"] = v.detach().cpu().numpy()
    for k, v in (state.ema_batch_stats or {}).items():
        out[f"{name}/ema_stats/{k}"] = v.detach().cpu().numpy()
    return out


def run_timed(case, rank, world, dev):
    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    name = case["name"]
    cfg = port_config(case)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=1, seed=0))
    stamps = []
    trainer = every_rank_records(
        Trainer(cfg, device=dev.type), lambda e, p: stamps.append(
            time.perf_counter()) if e == "train" else None)
    data = SyntheticU8(trainer.local_batch_size, cfg.data.image_size,
                       cfg.model.num_classes, seed=rank, pin=True)
    state = trainer.init_state(0)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = trainer.fit(state, data, num_steps=case["steps"])
    torch.cuda.synchronize(dev)
    stamps.insert(0, t0)
    recs = [r for r in trainer.records if r["event"] == "train"]
    peak = torch.cuda.max_memory_allocated(dev)
    sha = _sha(state.batch_stats.values())
    return {
        f"{name}/step_ms": np.diff(stamps) * 1e3,
        f"{name}/loss": np.array([r["loss"] for r in recs]),
        f"{name}/bad_step": np.array([r["bad_step"] for r in recs]),
        f"{name}/peak_memory_bytes": np.array(peak),
        f"{name}/local_batch": np.array(trainer.local_batch_size),
        f"{name}/stats_sha": np.array(sha),
        f"{name}/comm_meta": np.array(json.dumps(
            trainer.train_step.comm_meta)),
        f"{name}/sharded": np.array(state.param_shard is not None),
        f"{name}/profile": np.array(json.dumps(_profile(
            trainer, state, data, dev))),
        f"{name}/device": np.array(torch.cuda.get_device_name(dev)),
    }


def main(rank: int, world: int, port: int, spec_path: str, out_dir: str,
         device: str = "cpu") -> None:
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device=device,
                           timeout=120.0)
    dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}"
                       if device == "cuda" else "cpu")
    if device == "cuda":   # fp32 in full fp32, as the one-card reference
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    data = np.load(spec_path)
    spec = json.loads(str(data["spec"]))
    results = {}
    for case in spec["cases"]:
        if case.get("kind") == "bn":
            results.update(run_bn(case, data, rank, world, dev))
        elif case.get("kind") == "timed":
            results.update(run_timed(case, rank, world, dev))
        else:
            results.update(run_fit(case, data, rank, world, dev))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(world: int, spec: dict, arrays: dict, tmp_dir: str,
              timeout: float = 240.0, device: str = "cpu") -> list:
    """Run `spec`'s cases (with `arrays`) in `world` processes; returns
    each rank's outputs, in rank order."""
    os.makedirs(tmp_dir, exist_ok=True)
    spec_path = os.path.join(tmp_dir, "spec.npz")
    np.savez(spec_path, spec=np.array(json.dumps(spec)), **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), spec_path, tmp_dir, device], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(logs))
    return [dict(np.load(os.path.join(tmp_dir, f"rank{r}.npz")))
            for r in range(world)]


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5], *sys.argv[6:])

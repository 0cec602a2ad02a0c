"""The port's command line across ranks under torchrun, for
tests/test_torch_cli.py (4 gloo ranks on the CPU, narrow VGG-F) and
tests/test_torch_cuda.py (4 NCCL ranks, one card each, the flagship at
full width). It imports only the standard library, numpy and the port.

Run as a script it is one CPU rank of the command line:

    python tests/_torch_cli_run.py ARGS...     # cli.main(ARGS, device="cpu")

with DVGGF_SIGTERM_AT="RANK:STEP" in its environment, rank RANK sends
itself SIGTERM after step STEP; with DVGGF_CLI_DEVICE=cuda it runs on
the card (cuDNN's deterministic algorithms with
DVGGF_CUDNN_DETERMINISTIC=1); with DVGGF_CLI_STATS=DIR each rank writes
DIR/rank<r>.json at exit: after each train step the memory allocated on
the card, the bytes the model's parameters hold and the bytes of the
parameter shard and its EMA (tests/test_torch_cuda.py's ZeRO-3 case).

`cli_scenario(tmp_path, device, ..., sets=())` packs TFRecords of the
JPEG fixture (4 train shards and 4 validation shards), then, with the
`--set` items of `sets` added to every command:

(a) trains 40 steps under torchrun (4 ranks) with an eval every 10, a
    record every step and a checkpoint every 10, and SIGTERMs rank 2
    alone: on the CPU rank 2 itself after step 13, and every rank must
    stop at step 15 (the consensus reads the flag 2 steps later); on the
    card a thread of this process, once rank 0 has logged a step >= 12
    (rank 2's pid found beforehand by a marker in the environment
    torchrun passes on), and every rank must stop after the last step
    logged before the signal and within 3 of the last logged when it was
    sent. torchrun returns 0 (a rank stopping alone would strand the
    others in a collective), and the step is committed and intact;
(b) restarts the 4 ranks, which resume it through the iterator blob and
    run to 40 (evals at 20, 30 and 40; 1200 or 20 examples each);
(c) runs `--mode eval` in one process on the final checkpoint: its counts
    equal the 4-rank eval at 40.
It asserts all of that and returns the numbers. On the card the run
keeps the flagship's widths at base_lr 0.001: the preset's LR diverges
on the 16-image fixture after ~20 steps.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")

#: The CPU run's narrowing (tests/test_torch_zero_jax.py's widths; the
#: head keeps the fixture labels' 1000 classes), fp32, 4 images a rank.
NARROW = ["--set", "model.compute_dtype=float32", "--set",
          "model.extra.stem_features=8", "--set",
          "model.extra.conv_features=16", "--set",
          "model.extra.fc_features=32", "--set", "data.image_size=32",
          "--set", "data.global_batch_size=16", "--set",
          "data.num_train_examples=48", "--set", "data.native_threads=1",
          "--set", "optim.reference_batch_size=16"]


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def rank_pid(marker, rank):
    """The pid of this run's worker with RANK=rank."""
    want = {f"DVGGF_CLI_TEST={marker}".encode(), f"RANK={rank}".encode()}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = set(f.read().split(b"\0"))
        except OSError:
            continue
        if want <= env and int(pid) != os.getpid():
            return int(pid)
    return None


def window_ms(recs):
    """Each train record's ms a step over its own window, the first
    (warm-up) window and windows holding an eval left out."""
    ms = [1e3 / r["steps_per_sec"] for r in recs if r["event"] == "train"
          and "eval_seconds" not in r]
    return ms[1:]


def _pack(data, shards):
    sys.path.insert(0, REPO)
    from tools.tfrecord_write import write_shards
    jpegs = []
    for f in sorted(os.listdir(FIXTURE)):
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            jpegs.append(fh.read())
    labels = [1 + (61 * k) % 1000 for k in range(len(jpegs))]
    train, val = shards
    write_shards(data, jpegs, labels, shards=4, per_shard=train)
    write_shards(data, jpegs, labels, shards=4, per_shard=val,
                 prefix="validation")


def cli_scenario(tmp_path, device="cpu", shards=(12, 5), timeout=900,
                 sets=()):
    from distributed_vgg_f_tpu_torch.checkpoint.manager import \
        CheckpointManager
    from distributed_vgg_f_tpu_torch.telemetry.schema import \
        validate_metrics_jsonl
    data = os.path.join(str(tmp_path), "data")
    _pack(data, shards)
    n_eval = 4 * shards[1]
    marker = uuid.uuid4().hex
    env = dict(os.environ, DVGGF_CLI_TEST=marker, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    if device == "cuda":
        # the preset's LR (0.04 at batch 1024, no warmup) diverges on the
        # 16-image fixture after ~20 steps, and 10 skipped steps abort
        entry = ["-m", "distributed_vgg_f_tpu_torch.cli"]
        narrow = ["--set", "optim.base_lr=0.001"]
    else:
        entry = [os.path.abspath(__file__)]
        if shards[0] * 4 != 48:
            raise ValueError("the CPU narrowing reads 48 train records")
        narrow = NARROW
    narrow = [*narrow, *sets]

    def argv(ck, *extra, log_every=5):
        return ["--config", "vggf_imagenet_dp",
                "--set", f"data.data_dir={data}",
                "--set", f"train.checkpoint_dir={ck}",
                "--set", f"train.log_every={log_every}",
                "--set", "train.seed=0", *narrow, *extra]

    def run(args, watch=None, nproc=4, **env_extra):
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--standalone", f"--nproc_per_node={nproc}", *entry, *args]
        proc = subprocess.Popen(cmd, env=dict(env, **env_extra),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        if watch is not None:
            threading.Thread(target=watch, args=(proc,), daemon=True).start()
        try:
            out, _ = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, out[-6000:]
        return out

    ck = os.path.join(str(tmp_path), "ck")
    jsonl = os.path.join(ck, "metrics.jsonl")
    main = argv(ck, "--set", "train.steps=40",
                "--set", "train.eval_every_steps=10",
                "--set", "train.checkpoint_every_steps=10", log_every=1)
    sent = {}

    def logged(pos):
        """(the last train step logged, the file offset read to)."""
        with open(jsonl) as f:
            f.seek(pos)
            lines = f.readlines()
        steps = [json.loads(line)["step"] for line in lines
                 if '"event": "train"' in line]
        return (max(steps) if steps else None), pos + sum(map(len, lines))

    def watch(proc):
        pid = None
        while pid is None and proc.poll() is None:
            time.sleep(0.05)
            pid = rank_pid(marker, 2)
        last, pos = 0, 0
        while proc.poll() is None:
            time.sleep(0.002)
            if not os.path.exists(jsonl):
                continue
            step, pos = logged(pos)
            last = step or last
            if last >= 12:
                os.kill(pid, signal.SIGTERM)
                sent.update(step=last, pid=pid)
                time.sleep(0.002)
                sent["after"] = logged(pos)[0] or last
                return

    t0 = time.monotonic()
    if device == "cuda":
        run(main, watch=watch)
    else:
        run(main, DVGGF_SIGTERM_AT="2:13")
        sent.update(step=13, after=13)
    run_s = [time.monotonic() - t0]
    first = records(jsonl)
    preempt = [r for r in first if r["event"] == "preempt"]
    assert sent and len(preempt) == 1, (sent, preempt)
    stop = preempt[0]["step"]
    assert preempt[0]["checkpointed"], preempt
    if device == "cuda":
        assert sent["step"] < stop <= sent["after"] + 3, (sent, preempt)
    else:
        assert stop == 15, preempt
    mgr = CheckpointManager(ck)
    assert mgr.latest_step() == stop and mgr.verify_step(stop)

    t0 = time.monotonic()
    run(main)
    run_s.append(time.monotonic() - t0)
    second = records(jsonl)[len(first):]
    assert {"event": "restore", "schema_version": "1.0", "step": stop,
            "best": False} in second
    blob = [r for r in second if r["event"] == "iterator_state_restore"]
    assert blob and blob[0]["replayed_batches"] == 0, second
    assert not any(r["event"] == "data_fast_forward" for r in second)
    evals = {r["step"]: r for r in first + second if r["event"] == "eval"}
    assert {10, 20, 30, 40} <= set(evals), sorted(evals)
    assert all(r["eval_examples"] == n_eval for r in evals.values())

    one = subprocess.run(
        [sys.executable, *entry, *main, "--mode", "eval"],
        env=dict(env, CUDA_VISIBLE_DEVICES="0"), capture_output=True,
        text=True, timeout=timeout)
    assert one.returncode == 0, one.stdout[-4000:] + one.stderr[-4000:]
    single = records(jsonl)[-1]
    keys = ("eval_top1", "eval_top5", "eval_examples")
    assert single["event"] == "eval" and single["step"] == 40
    assert [single[k] for k in keys] == [evals[40][k] for k in keys]
    assert validate_metrics_jsonl(jsonl) == []
    train = [r for r in first + second if r["event"] == "train"]

    out = {"signal_after_step": sent["step"],
           "logged_after_signal": sent["after"], "preempted_at": stop,
           "run_s": run_s, "window_ms": window_ms(first + second),
           "eval": {k: [v[x] for x in keys + ("eval_seconds",)]
                    for k, v in sorted(evals.items())},
           "one_card_eval": [single[k] for k in keys + ("eval_seconds",)],
           "losses": [r["loss"] for r in train],
           "host_wait_fraction": [r["host_wait_fraction"] for r in train],
           "comm": train[-1].get("comm")}
    return out


def _sigterm_after(rank, step):
    """Make this process's Trainers SIGTERM it after `step` on `rank`."""
    from distributed_vgg_f_tpu_torch.train import trainer as mod
    base = mod.Trainer

    class Signalling(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inner = self.train_step

            def train_step(state, batch, seed):
                state, metrics = inner(state, batch, seed)
                if self.rank == rank and state.step == step:
                    os.kill(os.getpid(), signal.SIGTERM)
                return state, metrics

            train_step.comm_meta = inner.comm_meta
            self.train_step = train_step

    mod.Trainer = Signalling


def _record_stats(out_dir):
    """Make this process's Trainers record, after each train step, the
    memory the card holds and what the state's parameters hold; written to
    `out_dir`/rank<r>.json at exit."""
    import atexit

    import torch

    from distributed_vgg_f_tpu_torch.train import trainer as mod
    base = mod.Trainer
    rows = []

    def shard_bytes(t):
        return 0 if not isinstance(t, torch.Tensor) else 4 * t.numel()

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inner = self.train_step

            def train_step(state, batch, seed):
                state, metrics = inner(state, batch, seed)
                torch.cuda.synchronize()
                rows.append({
                    "rank": self.rank, "step": state.step,
                    "allocated": torch.cuda.memory_allocated(),
                    "peak": torch.cuda.max_memory_allocated(),
                    "param_storage": sum(p.untyped_storage().nbytes()
                                         for p in state.model.parameters()),
                    "param_numel": sum(p.numel() for p in
                                       state.shapes.parameters()),
                    "shard": shard_bytes(state.param_shard),
                    "ema_shard": shard_bytes(state.ema_params),
                    "sharding": inner.comm_meta.get("sharding")})
                return state, metrics

            train_step.comm_meta = inner.comm_meta
            self.train_step = train_step

    def dump():
        if rows:
            with open(os.path.join(out_dir, f"rank{rows[0]['rank']}.json"),
                      "w") as f:
                json.dump(rows, f)

    atexit.register(dump)
    mod.Trainer = Recording


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    from distributed_vgg_f_tpu_torch import cli
    if os.environ.get("DVGGF_SIGTERM_AT"):
        _sigterm_after(*map(int, os.environ["DVGGF_SIGTERM_AT"].split(":")))
    if os.environ.get("DVGGF_CLI_STATS"):
        _record_stats(os.environ["DVGGF_CLI_STATS"])
    device = os.environ.get("DVGGF_CLI_DEVICE", "cpu")
    if device == "cuda" and os.environ.get("DVGGF_CUDNN_DETERMINISTIC"):
        import torch
        torch.backends.cudnn.deterministic = True
    cli.main(sys.argv[1:], device=device)

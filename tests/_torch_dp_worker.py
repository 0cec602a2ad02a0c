"""One rank of a gloo process group that trains the port's narrow VGG-F
with the data-parallel gradient exchange, for tests/test_torch_zero.py and
tests/test_torch_zero_jax.py. It imports only torch, numpy and the port.

    python tests/_torch_dp_worker.py RANK WORLD PORT SPEC.npz OUT_DIR [cuda]

SPEC.npz holds `spec` (JSON: the model widths, image size, classes,
global batch, optimizer numbers and a list of cases), the initial Flax
params as ``params/<layer>/<leaf>``, and the global batches as
``batch<i>/image`` and ``batch<i>/label``. At full width the spec may
name `init_seed` (weights.init_params) and `u8_seed` (seeded u8 batches
made here, through the device finish) instead, `compute_dtype`, and
`rank0_params` (only rank 0 writes its params and no momentum; every
rank writes their float64 sum). On the card TF32 is off. Each case names its exchange
(`zero1`, `zero2`, `zero3`, `bucket_mb`, `accum`, `accum_shard`,
`reduce_dtype`), its `steps`, and optionally `ema` (the decay),
`dropout`, `skip_nonfinite`, a `nan` [rank,
step] whose local batch gets a NaN, `events` (record the step's hook
events on the first step), `masks` (record the dropout keep-masks), a
`resume` prefix (params ``<resume>/params/...``, the JAX ZeRO momentum
trace ``<resume>/trace``, `resume_step`) and `seed`. A case with
`trainer` instead runs Trainer.fit on that preset (with its dotted
`overrides`) and its own mesh for `steps` steps on this rank's share of
a seeded u8 batch, and
writes the step times, losses, peak memory, LRN launches and the step's
`comm_meta`. A case with `checkpoint` (a directory) runs
`Trainer.fit()` with no state on `checkpoint_config(spec, case)` (ZeRO-2,
or with `zero3` ZeRO-3, or with `zero1_only` ZeRO-1, over `bucket_mb`
buckets at the group's size, `ema` the EMA decay, checkpoints in that
directory every `every` steps): it restores the directory's newest
intact step or starts fresh, and trains to `steps` on global batches
`first_batch` onwards (with `restore_only` it only restores); with
`reload` a second Trainer then restores what the first left. `preset`
takes that preset's model, data and mesh instead of the spec's. Rank r takes rows r*B/n .. (r+1)*B/n - 1 of each global
batch.

For each case every rank writes, to OUT_DIR/rank<r>.npz: `<case>/loss`,
`<case>/grad_norm`, `<case>/bad_step` (one value a step, the metrics the
step returns), `<case>/params/<name>` (the port's state_dict after the
last step; under ZeRO-3 gathered), `<case>/ema/<name>` with an EMA,
`<case>/resident` (under ZeRO-3: the bytes the model's parameters held
after each step, then the shard's and the EMA shard's elements),
`<case>/comm` (the `comm/*` counters' moves over the case),
`<case>/momentum` ((T,) flat under ZeRO, gathered; the
per-leaf buffers as `<case>/momentum/<name>` otherwise), `<case>/snap<i>`
(params and momentum flattened after step i, with `nan`), and the events
and masks when asked; a checkpoint case also `<case>/shard` (this rank's
(S,) momentum), `<case>/restored_step` (-1 for a fresh start),
`<case>/opt_count` and, with `reload`, the same under `<case>/reload/`;
with `digest`, the SHA-256 of the params, shard and momentum bytes
instead of the arrays (`<case>/params_sha`, ...).
A case with `fit` runs `Trainer.fit()` with no state and no dataset (the
trainer-owned native feed) on `preset` (default the flagship) with its
dotted `overrides` (config.apply_overrides), optionally SIGTERMing
itself after step s on rank r (`sigterm` [r, s]), and writes
`<case>/loss`, `<case>/steps` (the train records'), `<case>/preempted_at`
(-1 if not), `<case>/events` (the other records, JSON), the local
batches the steps took (`<case>/images`, `<case>/labels`) and the
params' SHA-256 (`<case>/params_sha`). A case with `eval` evaluates
`init_state()` on the preset with its overrides over
`make_dataset("eval")` and writes the result as JSON (`<case>/eval`). A
case with `consensus` polls parallel/preempt.py `PreemptConsensus`
`polls` times, this rank's flag raised from poll `flag_step` on rank
`flag_rank`, and writes the poll at which it stopped (`<case>/stop`). A
case with `best_view` runs `fit` on this rank's copy of a checkpoint
directory and writes the CheckpointIntegrityError it raised
(`<case>/error`). A case with `hp_timing` times fits with
`train.handle_preemption` on and off in turn (`<case>/ms_true`,
`<case>/ms_false`: ms a step of each record's window).
The group is gloo on the CPU, or NCCL with one card a rank when the last
argument is "cuda".

`run_group` (for the tests) starts the ranks on a free port and loads
their outputs; `make_config` is the port's config for a spec, shared
with the tests' one-process reference.
"""

import dataclasses
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributed_vgg_f_tpu_torch import config as tcfg  # noqa: E402
from distributed_vgg_f_tpu_torch.data.device_ingest import \
    make_device_finish  # noqa: E402
from distributed_vgg_f_tpu_torch.models.vggf import VGGF  # noqa: E402
from distributed_vgg_f_tpu_torch.parallel.distributed import \
    initialize_distributed  # noqa: E402
from distributed_vgg_f_tpu_torch.parallel.zero import \
    zero_layout  # noqa: E402
from distributed_vgg_f_tpu_torch.train.schedule import \
    build_optimizer  # noqa: E402
from distributed_vgg_f_tpu_torch.train.state import TrainState  # noqa: E402
from distributed_vgg_f_tpu_torch.train.step import \
    build_train_step  # noqa: E402
from distributed_vgg_f_tpu_torch.weights import (  # noqa: E402
    init_params, load_params, momentum_shard_from_optax)


def make_config(spec: dict, dropout: float = 0.0):
    """The vggf_teacher preset cut to the spec: constant LR `lr` at the
    spec's global batch, no warmup, clip `clip`, L2 `weight_decay`."""
    cfg = tcfg.get_config("vggf_teacher")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, num_classes=spec["classes"],
                                  dropout_rate=dropout),
        optim=dataclasses.replace(
            cfg.optim, base_lr=spec["lr"],
            reference_batch_size=spec["batch"], schedule="constant",
            warmup_epochs=0.0, grad_clip_norm=spec.get("clip", 0.0),
            weight_decay=spec["weight_decay"]),
        data=dataclasses.replace(cfg.data, image_size=spec["size"],
                                 global_batch_size=spec["batch"]))


def checkpoint_config(spec: dict, case: dict):
    """The spec's narrow VGG-F (dropout and augment off) on the step
    schedule, ZeRO-2 over `bucket_mb` buckets, checkpoints in
    `case["checkpoint"]` every `case["every"]` steps; the same fields as
    the JAX config tests/test_torch_checkpoint_jax.py builds. With
    `case["preset"]`, that preset with the checkpoint fields."""
    train = dict(steps=case["steps"], seed=0, log_every=1,
                 checkpoint_dir=case["checkpoint"],
                 checkpoint_every_steps=case.get("every", 2))
    if "preset" in case:
        cfg = tcfg.get_config(case["preset"])
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, **train))
    return tcfg.ExperimentConfig(
        name="checkpoint_test",
        model=tcfg.ModelConfig(name="vggf", num_classes=spec["classes"],
                               compute_dtype="float32", dropout_rate=0.0,
                               extra=dict(spec["widths"])),
        optim=tcfg.OptimConfig(base_lr=spec["lr"],
                               reference_batch_size=spec["batch"],
                               momentum=0.9,
                               weight_decay=spec["weight_decay"]),
        data=tcfg.DataConfig(name="synthetic", image_size=spec["size"],
                             global_batch_size=spec["batch"],
                             num_train_examples=4 * spec["batch"]),
        mesh=tcfg.MeshConfig(
            shard_opt_state=True,
            shard_gradients=not case.get("zero1_only", False),
            shard_params=case.get("zero3", False),
            comm_bucket_mb=case.get("bucket_mb", 0.0)),
        train=tcfg.TrainConfig(ema_decay=case.get("ema", 0.0), **train))


def state_values(state) -> dict:
    """The model's state_dict; a ZeRO-3 state's parameters gathered into
    it (collective)."""
    tree = state.params_tree() if state.shard_params else {}
    return {k: tree.get(k, v) for k, v in state.model.state_dict().items()}


def state_digests(state, num_shards: int, comm_bucket_mb: float) -> dict:
    """SHA-256 of the params (state_dict order) and of the (T,) momentum
    in the `num_shards`-rank layout: one card's restore is held to a
    group's with them."""
    out = {"params_sha": _sha(state_values(state).values())}
    if state.param_shard is not None:
        out["momentum_sha"] = _sha([state.momentum_global()])
    else:
        lay = zero_layout(state.model, num_shards, comm_bucket_mb)
        out["momentum_sha"] = _sha([lay.to_global(lay.leaves(
            state.momentum()))])
    return out


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _state_out(prefix: str, trainer, state, digest: bool = False) -> dict:
    restores = [r["step"] for r in trainer.records if r["event"] == "restore"]
    out = {f"{prefix}/restored_step": np.array(restores[-1] if restores
                                                else -1),
           f"{prefix}/step": np.array(state.step),
           f"{prefix}/opt_count": np.array(state.opt_count),
           f"{prefix}/loss": np.array([r["loss"] for r in trainer.records
                                       if r["event"] == "train"])}
    if digest:
        n = torch.distributed.get_world_size()
        for k, v in state_digests(state, n, trainer.cfg.mesh.comm_bucket_mb
                                  ).items():
            out[f"{prefix}/{k}"] = np.array(v)
        out[f"{prefix}/shard_sha"] = np.array(_sha([state.momentum_shard()]))
        return out
    for k, v in state_values(state).items():
        out[f"{prefix}/params/{k}"] = v.cpu().numpy()
    if state.ema_params is not None:
        for k, v in state.params_tree(ema=True).items():
            out[f"{prefix}/ema/{k}"] = v.cpu().numpy()
    out[f"{prefix}/shard_params"] = np.array(state.shard_params)
    if state.param_shard is not None:
        out[f"{prefix}/shard"] = state.momentum_shard().cpu().numpy()
        out[f"{prefix}/momentum"] = state.momentum_global().cpu().numpy()
    else:
        for k, v in state.momentum().items():
            out[f"{prefix}/momentum/{k}"] = v.cpu().numpy()
    return out


def every_rank_records(trainer, log=None):
    """A Trainer records on rank 0 only; the worker keeps every rank's
    records (and calls `log`) so each rank can report its own."""
    def record(event, payload):
        trainer.records.append({"event": event, **payload})
        if log is not None:
            log(event, payload)
    trainer.log = record
    return trainer


def run_checkpoint(case: dict, spec: dict, data, rank: int, world: int,
                   dev: torch.device) -> dict:
    """Trainer.fit() with no state over a checkpoint directory, then, with
    `reload`, a fresh Trainer's restore of what it left."""
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = checkpoint_config(spec, case)
    local = spec["batch"] // world
    first = int(case.get("first_batch", 0))
    batches = []
    for i in range(first, case["steps"]):
        image, label = global_batch(spec, data, i)
        batches.append({"image": image[rank * local:(rank + 1) * local],
                        "label": label[rank * local:(rank + 1) * local]})
    trainer = every_rank_records(Trainer(cfg, device=dev.type))
    state = (trainer.restore_or_init() if case.get("restore_only")
             else trainer.fit(None, batches, num_steps=case["steps"]))
    digest = case.get("digest", False)
    out = _state_out(case["name"], trainer, state, digest)
    if case.get("reload"):
        again = every_rank_records(Trainer(cfg, device=dev.type))
        out.update(_state_out(f"{case['name']}/reload", again,
                              again.restore_or_init(), digest))
    return out


def preset_config(case: dict):
    """`preset` (default the flagship) with the case's dotted overrides."""
    return tcfg.apply_overrides(
        tcfg.get_config(case.get("preset", "vggf_imagenet_dp")),
        case.get("overrides", {}))


def run_fit(case: dict, rank: int, dev: torch.device) -> dict:
    """Trainer.fit() with no state and no dataset, SIGTERMed on request;
    every rank's records kept."""
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    name = case["name"]
    trainer = every_rank_records(Trainer(preset_config(case),
                                         device=dev.type))
    seen = []
    inner = trainer.train_step

    def step(state, batch, seed):
        seen.append((np.array(batch["image"]), np.array(batch["label"])))
        state, metrics = inner(state, batch, seed)
        if case.get("sigterm") == [rank, state.step]:
            os.kill(os.getpid(), signal.SIGTERM)
        return state, metrics

    step.comm_meta = inner.comm_meta
    trainer.train_step = step
    state = trainer.fit()
    train = [r for r in trainer.records if r["event"] == "train"]
    return {
        f"{name}/loss": np.array([r["loss"] for r in train]),
        f"{name}/steps": np.array([r["step"] for r in train]),
        f"{name}/preempted_at": np.array(trainer.preempted_at or -1),
        f"{name}/events": np.array(json.dumps(
            [r for r in trainer.records if r["event"] != "train"])),
        f"{name}/images": np.stack([i for i, _ in seen]),
        f"{name}/labels": np.stack([la for _, la in seen]),
        f"{name}/params_sha": np.array(_sha(state_values(state).values()))}


def run_eval(case: dict, dev: torch.device) -> dict:
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    trainer = Trainer(preset_config(case), device=dev.type)
    result = trainer.evaluate(trainer.init_state(),
                              trainer.make_dataset("eval"))
    return {f"{case['name']}/eval": np.array(json.dumps(result))}


def run_best_view(case: dict, rank: int, world: int,
                  dev: torch.device) -> dict:
    """`fit` on this rank's own copy of a checkpoint directory
    (`dirs[rank]`), on seeded batches with an eval split; writes the
    CheckpointIntegrityError it raised, or "" (`<case>/error`)."""
    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.resilience.errors import \
        CheckpointIntegrityError
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = tcfg.apply_overrides(preset_config(case), {
        "train.checkpoint_dir": case["dirs"][rank]})
    rows = cfg.data.global_batch_size // world
    size, classes = cfg.data.image_size, cfg.model.num_classes
    trainer = Trainer(cfg, device=dev.type)
    error = ""
    try:
        trainer.fit(None, SyntheticU8(rows, size, classes, seed=1 + rank),
                    num_steps=case["steps"],
                    eval_dataset=SyntheticU8(rows, size, classes))
    except CheckpointIntegrityError as e:
        error = str(e)
    return {f"{case['name']}/error": np.array(error)}


def run_hp_timing(case: dict, dev: torch.device) -> dict:
    """Fits of `steps` steps from one state on the trainer-owned feed,
    with train.handle_preemption per fit as `pattern` lists ("true",
    "false"): the ms a step of each record's window, the first window of
    each fit (its warm-up) left out (`<case>/ms_true`, `<case>/ms_false`)."""
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = preset_config(case)
    trainer = every_rank_records(Trainer(cfg, device=dev.type))
    state = trainer.init_state()
    ms = {"true": [], "false": []}
    for flag in case["pattern"]:
        trainer.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, handle_preemption=flag == "true"))
        seen = len(trainer.records)
        state = trainer.fit(state, num_steps=state.step + case["steps"])
        train = [r for r in trainer.records[seen:] if r["event"] == "train"]
        ms[flag].extend(1e3 / r["steps_per_sec"] for r in train[1:])
    return {f"{case['name']}/ms_{k}": np.array(v) for k, v in ms.items()}


def run_consensus(case: dict, rank: int, dev: torch.device) -> dict:
    from distributed_vgg_f_tpu_torch.parallel.preempt import \
        PreemptConsensus
    consensus = PreemptConsensus(dev)
    stop = -1
    for i in range(case["polls"]):
        flag = rank == case["flag_rank"] and i >= case["flag_step"]
        if consensus.poll(flag):
            stop = i
            break
    return {f"{case['name']}/stop": np.array(stop)}


def make_model(spec: dict, tree: dict, dropout: float = 0.0):
    dtype = getattr(torch, spec.get("compute_dtype", "float32"))
    return load_params(VGGF(spec["classes"], compute_dtype=dtype,
                            image_size=spec["size"], dropout_rate=dropout,
                            **spec["widths"]), tree)


def initial_tree(spec: dict, data) -> dict:
    if "init_seed" in spec:     # full width: weights.init_params
        return init_params(tcfg.ModelConfig(num_classes=spec["classes"]),
                           spec["init_seed"], image_size=spec["size"])
    return tree_from(data, "params")


def global_batch(spec: dict, data, i: int):
    """Global batch i: seeded u8 rows with `u8_seed`, else the spec's."""
    if "u8_seed" in spec:
        rng = np.random.default_rng(spec["u8_seed"] + i)
        b, s = spec["batch"], spec["size"]
        return (rng.integers(0, 256, (b, s, s, 3), np.uint8),
                rng.integers(0, spec["classes"], b))
    return data[f"batch{i}/image"], data[f"batch{i}/label"]


def make_step_finish(spec: dict):
    if "u8_seed" not in spec:
        return None
    data_cfg = tcfg.DataConfig()
    return make_device_finish(data_cfg.mean_rgb, data_cfg.stddev_rgb)


def tree_from(data, prefix: str) -> dict:
    """The Flax tree stored under ``<prefix>/<layer>/<leaf>``."""
    tree: dict = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            layer, leaf = key[len(prefix) + 1:].split("/")
            tree.setdefault(layer, {})[leaf] = data[key]
    return tree


def _flat(tensors) -> np.ndarray:
    return np.concatenate([t.detach().float().reshape(-1).cpu().numpy()
                           for t in tensors])


def run_case(case: dict, spec: dict, data, rank: int, world: int,
             dev: torch.device) -> dict:
    name = case["name"]
    dropout = case.get("dropout", 0.0)
    cfg = make_config(spec, dropout)
    resume = case.get("resume")
    tree = (tree_from(data, f"{resume}/params") if resume
            else initial_tree(spec, data))
    model = make_model(spec, tree, dropout).to(dev)
    zero1 = case.get("zero1", False)
    zero3 = case.get("zero3", False)
    ema = case.get("ema", 0.0)
    bucket_mb = case.get("bucket_mb", 0.0)
    if zero1:
        state = TrainState.create_sharded(
            model, lambda ps: build_optimizer(cfg, ps)[0],
            zero_layout(model, world, bucket_mb), ema=ema > 0,
            shard_params=zero3)
    else:
        state = TrainState.create(
            model, build_optimizer(cfg, model.parameters())[0], ema=ema > 0)
    schedule = lambda s: float(spec["lr"])  # noqa: E731
    if resume:
        trace = types.SimpleNamespace(trace=data[f"{resume}/trace"])
        state.load_momentum_shard(momentum_shard_from_optax(
            (trace,), rank, world))
        state.step = state.opt_count = int(case["resume_step"])
    events = [] if case.get("events") else None
    step = build_train_step(
        schedule, cfg.optim.weight_decay,
        grad_clip_norm=cfg.optim.grad_clip_norm,
        skip_nonfinite=case.get("skip_nonfinite", False), zero1=zero1,
        shard_gradients=case.get("zero2", False) or zero3,
        shard_params=zero3, ema_decay=ema, comm_bucket_mb=bucket_mb,
        grad_accum_steps=case.get("accum", 1),
        grad_accum_shard=case.get("accum_shard", False),
        reduce_dtype=case.get("reduce_dtype", "float32"), event_log=events,
        device_finish=make_step_finish(spec), device=dev.type)
    masks = []
    if case.get("masks"):
        drop = model._dropout

        def recorded(x, generator):
            y = drop(x, generator)
            masks.append((y != 0).cpu().numpy())
            return y
        model._dropout = recorded
    out = {}
    comm0 = _comm_counts()
    resident = []
    losses, norms, bad = [], [], []
    local = spec["batch"] // world
    nan = case.get("nan")
    first = int(case.get("first_batch", 0))
    for i in range(case["steps"]):
        image, label = global_batch(spec, data, first + i)
        image = image[rank * local:(rank + 1) * local].copy()
        label = label[rank * local:(rank + 1) * local]
        if nan is not None and nan == [rank, i]:
            image[0, 0, 0, 0] = np.nan
        state, m = step(state, {"image": image, "label": label},
                        case.get("seed", 0))
        if events is not None and i == 0:
            out[f"{name}/events"] = np.array(json.dumps(events))
            events = None
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        bad.append(float(m.get("bad_step", 0.0)))
        if zero3:
            resident.append(sum(p.untyped_storage().nbytes()
                                for p in model.parameters()))
        if nan is not None:
            mom = (state.momentum_shard() if zero1
                   else torch.cat([v.reshape(-1) for v in
                                   state.momentum().values()]))
            held = ([state.param_shard] + ([state.ema_params] if ema else [])
                    if zero3 else list(model.parameters()))
            out[f"{name}/snap{i}"] = np.concatenate(
                [_flat(held), _flat([mom]), [state.opt_count]])
    out[f"{name}/loss"] = np.array(losses)
    out[f"{name}/grad_norm"] = np.array(norms)
    out[f"{name}/bad_step"] = np.array(bad)
    out[f"{name}/comm"] = np.array(json.dumps(
        {k: v - comm0[k] for k, v in _comm_counts().items()}))
    if zero3:
        out[f"{name}/resident"] = np.array(resident + [
            state.param_shard.numel(),
            state.ema_params.numel() if ema else 0])
    values = state_values(state)
    out[f"{name}/param_sum"] = np.array(sum(
        float(values[k].double().sum()) for k, _ in
        state.shapes.named_parameters()))
    for k, v in values.items():
        if rank == 0 or not spec.get("rank0_params"):
            out[f"{name}/params/{k}"] = v.cpu().numpy()
    if ema:
        for k, v in state.params_tree(ema=True).items():
            out[f"{name}/ema/{k}"] = v.cpu().numpy()
    if spec.get("rank0_params"):
        pass
    elif zero1:
        out[f"{name}/momentum"] = state.momentum_global().cpu().numpy()
    else:
        for k, v in state.momentum().items():
            out[f"{name}/momentum/{k}"] = v.cpu().numpy()
    for i, mask in enumerate(masks):
        out[f"{name}/mask{i}"] = mask
    out[f"{name}/comm_meta"] = np.array(json.dumps(step.comm_meta))
    return out


def _comm_counts() -> dict:
    from distributed_vgg_f_tpu_torch.telemetry import get_registry
    from distributed_vgg_f_tpu_torch.telemetry.registry import COMM_COUNTERS
    return {k: get_registry().counter_value(k, 0) for k in COMM_COUNTERS}


def run_trainer(case: dict, spec: dict, rank: int, world: int,
                dev: torch.device) -> dict:
    """Trainer.fit on the preset, its own mesh, over the group."""
    import time

    from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
    from distributed_vgg_f_tpu_torch.ops import lrn_cuda
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = tcfg.apply_overrides(tcfg.get_config(case["trainer"]),
                               case.get("overrides", {}))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=1))
    stamps = []
    trainer = every_rank_records(
        Trainer(cfg, device=dev.type),
        log=lambda e, p: stamps.append(time.perf_counter()))
    data = SyntheticU8(trainer.local_batch_size, cfg.data.image_size,
                       cfg.model.num_classes, seed=rank, pin=True)
    state = trainer.init_state(0)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    state = trainer.fit(state, data, num_steps=case["steps"])
    torch.cuda.synchronize(dev)
    stamps.insert(0, t0)
    recs = [r for r in trainer.records if r["event"] == "train"]
    peak = torch.cuda.max_memory_allocated(dev)
    launches = [lrn_cuda.LAUNCHES, lrn_cuda.BWD_LAUNCHES]
    name = case["name"]
    return {
        f"{name}/profile": np.array(json.dumps(_profile(trainer, state,
                                                        data, dev))),
        f"{name}/step_ms": np.diff(stamps) * 1e3,
        f"{name}/loss": np.array([r["loss"] for r in recs]),
        f"{name}/bad_step": np.array([r["bad_step"] for r in recs]),
        f"{name}/peak_memory_bytes": np.array(peak),
        f"{name}/local_batch": np.array(trainer.local_batch_size),
        f"{name}/lrn_launches": np.array(launches),
        f"{name}/images_per_sec": np.array(recs[-1]["images_per_sec"]),
        f"{name}/comm_meta": np.array(json.dumps(
            trainer.train_step.comm_meta)),
        f"{name}/sharded": np.array(state.param_shard is not None),
        f"{name}/device": np.array(torch.cuda.get_device_name(dev)),
    }


def _profile(trainer, state, data, dev, steps: int = 3) -> dict:
    """torch.profiler over `steps` more steps: the traced window, the
    device's busy time (the union of its kernels' and copies' spans),
    NCCL's kernels and the copies, each a step, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    batch = next(iter(data))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch, 0)
        torch.cuda.synchronize(dev)
    events = list(prof.events())
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, cur = 0.0, None
    for s0, e0 in sorted((e.time_range.start, e.time_range.end)
                         for e in device):
        if cur is None or s0 > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s0, e0]
        else:
            cur[1] = max(cur[1], e0)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_us": window / steps, "busy_us": busy / steps,
            "idle_share": 1.0 - busy / window,
            "nccl_us": sum(v for k, v in by_name.items()
                           if "nccl" in k.lower()) / steps,
            "copy_us": sum(v for k, v in by_name.items()
                           if "copy" in k.lower() or "memcpy" in k.lower())
            / steps,
            "top_us": [[k[:70], v / steps] for k, v in top]}


def main(rank: int, world: int, port: int, spec_path: str, out_dir: str,
         device: str = "cpu") -> None:
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device=device,
                           timeout=120.0)
    dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}"
                       if device == "cuda" else "cpu")
    if device == "cuda":   # fp32 in full fp32, as the one-card reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    data = np.load(spec_path)
    spec = json.loads(str(data["spec"]))
    results = {}
    for case in spec["cases"]:
        if "trainer" in case:
            results.update(run_trainer(case, spec, rank, world, dev))
        elif "fit" in case:
            results.update(run_fit(case, rank, dev))
        elif "eval" in case:
            results.update(run_eval(case, dev))
        elif "hp_timing" in case:
            results.update(run_hp_timing(case, dev))
        elif "best_view" in case:
            results.update(run_best_view(case, rank, world, dev))
        elif "consensus" in case:
            results.update(run_consensus(case, rank, dev))
        elif "checkpoint" in case:
            results.update(run_checkpoint(case, spec, data, rank, world,
                                          dev))
        else:
            results.update(run_case(case, spec, data, rank, world, dev))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(world: int, spec: dict, arrays: dict, tmp_dir: str,
              timeout: float = 240.0, device: str = "cpu") -> list:
    """Run `spec`'s cases (with the params and batches in `arrays`) in
    `world` processes; returns each rank's outputs, in rank order."""
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

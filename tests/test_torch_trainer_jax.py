"""The acceptance test of the port's main path (ROADMAP A10) and its exact
eval, against the JAX package's `Trainer`.

The flagship preset (`vggf_imagenet_dp`), narrowed (stem 8, convs 16,
FC 32, 10 classes, 32 px, fp32, global batch 16, ZeRO-2 over ~0.5 KB
buckets, its LR at a reference batch of 16), trains on 2 gloo ranks
(tests/_torch_dp_worker.py) through `Trainer.fit()` with no state and no
dataset: the trainer-owned native feed over TFRecord shards of the JPEG
fixture. Rank 1 is SIGTERMed after step 3, both ranks stop at step 5
(the consensus reads the flag 2 steps later), force a save and return;
a fresh 2-rank group resumes through the iterator blob and trains to
step 10. Dropout, flip and mixup are off on both sides (torch cannot
reproduce threefry; the host decoder's flips stay, and JAX is fed the
batches the port took). JAX's `Trainer.fit` runs the same 10 steps
uninterrupted on a 2-device CPU mesh, from the port's initial weights,
fed the same global batches (the two ranks' local batches
concatenated). Tolerance: losses rtol 1e-5 — tests/test_torch_zero_jax.py
holds 3 steps to 2e-6; the two frameworks' fp32 convolutions round
differently and the difference compounds through 10 updates.

Exact eval: `Trainer.evaluate` of the port over validation shards of 13
and 8 records (21: two full batches of 8 and a partial one of 5) at 1
rank, and at 2 ranks with uneven shards (13 and 8 records, one rank a
file), against JAX's `Trainer.evaluate` over the same shards on a
2-device mesh, on the same weights: equal top-1 and top-5 counts and
eval_examples equal to the split's 21.

Every augment op (the slice of ROADMAP A4): the same narrowed flagship
with flip, crop jitter 2, mixup 0.2, cutmix 1.0 and two rounds of
RandAugment-lite at magnitude 0.5, trained 10 steps by the port's
`Trainer.fit` on one process and by JAX's on a one-device mesh, from the
same weights, on the same seeded u8 batches. The port's stage is handed
JAX's draws for each step's key (tests/_torch_jax_draws.py), as torch
cannot reproduce JAX's generator. Tolerance: losses rtol 1e-5, as
above. Beside the convolutions, RandAugment's posterize moves a few
pixels by one step between the two (tests/test_torch_augment.py: XLA
fuses multiply-adds the port computes as two ops), which changes a loss
by far less than the bound."""

import io
import json
import os
import sys

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch

from _torch_dp_worker import run_group
from _torch_jax_draws import jax_augment_draws, jax_draws_for_port_key, \
    jax_step_augment_key
from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu import telemetry as jtelemetry
from distributed_vgg_f_tpu.data import imagenet as jimagenet
from distributed_vgg_f_tpu.data import native_jpeg as jjpeg
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.train.trainer import Trainer as JaxTrainer
from distributed_vgg_f_tpu.utils.logging import MetricLogger as JaxLogger
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.data import augment as paug
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.weights import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.tfrecord_write import write_shards  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
BATCH, STEPS, STOP = 16, 10, 5


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_found():
    """JAX's process-wide telemetry switches (the registry's and the
    recorder's `enabled`) as this module found them, given back at its
    end. A JAX `Trainer` built with `telemetry.enabled=false` switches
    both off for the whole process and nothing switches them back, so a
    later test in the same worker would read JAX's counters as zeros."""
    found = (jtelemetry.get_registry().enabled,
             jtelemetry.get_recorder().enabled)
    yield found
    _give_back_jax_telemetry(found)


@pytest.fixture(autouse=True)
def _jax_telemetry_given_back(_jax_telemetry_found):
    """The same switches given back after every test (a module-scoped
    fixture may have built a JAX `Trainer` before the first one)."""
    yield
    _give_back_jax_telemetry(_jax_telemetry_found)


def _give_back_jax_telemetry(found):
    jtelemetry.configure(enabled=found[0])
    jtelemetry.get_recorder().enabled = found[1]

#: The narrowing, as dotted keys both packages take (config.apply_overrides)
NARROW = {"model.num_classes": "10", "model.compute_dtype": "float32",
          "model.dropout_rate": "0.0",
          "model.extra.stem_features": "8", "model.extra.conv_features": "16",
          "model.extra.fc_features": "32",
          "data.image_size": "32", "data.global_batch_size": str(BATCH),
          "data.num_train_examples": "48", "data.native_threads": "2",
          "data.augment.enabled": "false",
          "optim.reference_batch_size": str(BATCH),
          "mesh.comm_bucket_mb": "0.0005",
          "train.seed": "0", "train.log_every": "1"}


def _jpegs():
    out = []
    for f in sorted(os.listdir(FIXTURE)):
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            out.append(fh.read())
    return out


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """4 train shards of 12 records; validation shards of 13 and 8."""
    root = str(tmp_path_factory.mktemp("a10_tfrecords"))
    jpegs = _jpegs()
    labels = [1 + k % 10 for k in range(len(jpegs))]
    write_shards(root, jpegs, labels, shards=4, per_shard=12)
    write_shards(root, jpegs, labels[3:] + labels[:3], shards=1,
                 per_shard=13, prefix="validation-a")
    write_shards(root, jpegs[5:], labels[5:], shards=1, per_shard=8,
                 prefix="validation-b")
    return root


def _port_cfg(data_dir, **extra):
    return tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"),
                                {**NARROW, "data.data_dir": data_dir,
                                 **extra})


def _jax_trainer(data_dir, jsonl, steps=STEPS):
    cfg = jcfg.apply_overrides(jcfg.get_config("vggf_imagenet_dp"), {
        **NARROW, "data.data_dir": data_dir, "data.name": "synthetic",
        "train.steps": str(steps), "telemetry.enabled": "false",
        "data.autotune.enabled": "false", "mesh.num_data": "0"})
    mesh = build_mesh(MeshSpec(("data",), (2,)), devices=jax.devices()[:2])
    tr = JaxTrainer(cfg, mesh=mesh,
                    logger=JaxLogger(jsonl_path=jsonl, stream=io.StringIO()))
    return tr


def _with_port_params(tr, state, port_cfg):
    """JAX's state holding the port's initial weights (weights.init_params
    gives the Flax tree)."""
    tree = init_params(port_cfg.model, port_cfg.train.seed,
                       image_size=port_cfg.data.image_size)
    params = jax.device_put(tree, NamedSharding(tr.mesh, P()))
    return state.replace(params=params)


def _train_losses(jsonl):
    with open(jsonl) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r["event"] == "train"]


@pytest.fixture(scope="module")
def preempted_run(data_dir, tmp_path_factory):
    """The port on 2 ranks: SIGTERM on rank 1 after step 3, then a fresh
    group's resume to 10; and JAX's uninterrupted 10 steps on its
    batches."""
    tmp = tmp_path_factory.mktemp("a10")
    ckpt = str(tmp / "ckpt")
    overrides = {**NARROW, "data.data_dir": data_dir,
                 "train.steps": str(STEPS),
                 "train.checkpoint_dir": ckpt,
                 "train.checkpoint_every_steps": "1000"}
    first = run_group(2, {"cases": [dict(name="run", fit=True,
                                         overrides=overrides,
                                         sigterm=[1, 3])]}, {},
                      str(tmp / "first"))
    second = run_group(2, {"cases": [dict(name="run", fit=True,
                                          overrides=overrides)]}, {},
                       str(tmp / "second"))
    port_cfg = _port_cfg(data_dir)
    batches = []
    for run in (first, second):
        for i in range(len(run[0]["run/images"])):
            batches.append({
                "image": np.concatenate([r["run/images"][i] for r in run]),
                "label": np.concatenate([r["run/labels"][i] for r in run])})
    jsonl = str(tmp / "jax.jsonl")
    tr = _jax_trainer(data_dir, jsonl)
    state = _with_port_params(tr, tr.init_state(), port_cfg)
    tr.fit(state, dataset=iter(batches), num_steps=STEPS)
    return first, second, np.array(_train_losses(jsonl)), len(batches)


def test_both_ranks_stop_at_one_step_and_save_it(preempted_run):
    first, _, _, _ = preempted_run
    for rank, out in enumerate(first):
        assert int(out["run/preempted_at"]) == STOP, rank
        events = json.loads(str(out["run/events"]))
        assert {"event": "preempt", "step": STOP,
                "checkpointed": True} in events
        assert list(out["run/steps"]) == list(range(1, STOP + 1))


def test_resume_goes_through_the_blob_on_both_ranks(preempted_run):
    _, second, _, n = preempted_run
    assert n == STEPS
    for rank, out in enumerate(second):
        events = json.loads(str(out["run/events"]))
        assert {"event": "restore", "step": STOP, "best": False} in events
        blob = [e for e in events if e["event"] == "iterator_state_restore"]
        assert blob and blob[0]["replayed_batches"] == 0, events
        assert not any(e["event"] == "data_fast_forward" for e in events)
        assert int(out["run/preempted_at"]) == -1
        assert list(out["run/steps"]) == list(range(STOP + 1, STEPS + 1))
    assert str(second[0]["run/params_sha"]) == str(
        second[1]["run/params_sha"])


def test_preempted_and_resumed_losses_match_the_jax_trainer(preempted_run):
    first, second, jax_losses, _ = preempted_run
    port = np.concatenate([first[0]["run/loss"], second[0]["run/loss"]])
    assert len(jax_losses) == len(port) == STEPS
    np.testing.assert_allclose(port, jax_losses, rtol=1e-5)
    # both ranks log the same group-mean loss
    np.testing.assert_array_equal(first[1]["run/loss"], first[0]["run/loss"])


# ------------------------------------------------------------- exact eval
@pytest.fixture(scope="module")
def jax_eval(data_dir, tmp_path_factory):
    """JAX's evaluate over the validation shards on a 2-device mesh, the
    port's initial weights."""
    tmp = tmp_path_factory.mktemp("a10_eval")
    port_cfg = _port_cfg(data_dir)
    tr = _jax_trainer(data_dir, str(tmp / "eval.jsonl"))
    state = _with_port_params(tr, tr.init_state(), port_cfg)
    files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                   if f.startswith("validation-"))
    path_idx, offsets, lengths, labels = jimagenet._tfrecord_items(
        tr.cfg.data, files, 1)
    ds = jjpeg.NativeJpegEvalIterator(
        files, labels, batch=BATCH // 2, image_size=32,
        mean=np.asarray(tr.cfg.data.mean_rgb, np.float32),
        std=np.asarray(tr.cfg.data.stddev_rgb, np.float32),
        ranges=(path_idx, offsets, lengths))
    result = tr.evaluate(state, ds)
    ds.close()
    return result


def _counts(result):
    n = result["eval_examples"]
    return (round(result["eval_top1"] * n), round(result["eval_top5"] * n),
            n)


def test_exact_eval_on_one_rank_matches_jax(data_dir, jax_eval):
    cfg = _port_cfg(data_dir, **{"data.global_batch_size": str(BATCH // 2)})
    tr = Trainer(cfg, device="cpu")
    ds = tr.make_dataset("eval")
    assert ds.is_finite
    result = tr.evaluate(tr.init_state(), ds)
    assert result["eval_examples"] == 21
    assert _counts(result) == _counts(jax_eval)
    assert tr.records[-1]["event"] == "eval"


def test_exact_eval_on_two_ranks_with_uneven_shards_matches_jax(
        data_dir, jax_eval, tmp_path):
    overrides = {**NARROW, "data.data_dir": data_dir,
                 "data.global_batch_size": str(BATCH // 2)}
    out = run_group(2, {"cases": [dict(name="ev", eval=True,
                                       overrides=overrides)]}, {},
                    str(tmp_path / "group"))
    results = [json.loads(str(o["ev/eval"])) for o in out]
    # one file a rank: 13 records in 4 batches of 4, and 8 in 2
    for r in results:
        assert r["eval_examples"] == 21
        assert _counts(r) == _counts(jax_eval)
    assert results[0]["eval_top1"] == results[1]["eval_top1"]


# ------------------------------------------------------ every augment op
#: Every op of JAX's augment stage, as dotted keys both packages take
AUGMENT_ALL = {"data.augment.enabled": "true", "data.augment.hflip": "true",
               "data.augment.crop_jitter": "2",
               "data.augment.mixup_alpha": "0.2",
               "data.augment.cutmix_alpha": "1.0",
               "data.augment.rand_ops": "2",
               "data.augment.rand_magnitude": "0.5"}


def test_every_augment_op_matches_the_jax_trainer(data_dir, tmp_path,
                                                  monkeypatch):
    rng = np.random.default_rng(23)
    batches = [{"image": rng.integers(0, 256, (BATCH, 32, 32, 3),
                                      dtype=np.uint8),
                "label": rng.integers(0, 10, (BATCH,), dtype=np.int32)}
               for _ in range(STEPS)]
    jax_cfg = jcfg.apply_overrides(jcfg.get_config("vggf_imagenet_dp"), {
        **NARROW, **AUGMENT_ALL, "data.data_dir": data_dir,
        "data.name": "synthetic", "train.steps": str(STEPS),
        "telemetry.enabled": "false", "data.autotune.enabled": "false",
        "mesh.num_data": "0"})
    impl = jax_cfg.train.dropout_rng_impl
    # the steps take both mix branches and posterize
    draws = [jax_augment_draws(jax_cfg.data.augment,
                               jax_step_augment_key(0, s, 0, impl),
                               BATCH, 32, 32) for s in range(STEPS)]
    assert {d.mix.use_cut for d in draws} == {True, False}
    assert any((d.rand[0] == 3).any() for d in draws)

    monkeypatch.setattr(paug, "draw_augment", jax_draws_for_port_key(impl))
    cfg = _port_cfg(data_dir, **AUGMENT_ALL)
    port = Trainer(cfg, device="cpu")
    port.fit(port.init_state(),
             [{k: torch.from_numpy(v) for k, v in b.items()}
              for b in batches], num_steps=STEPS)
    records = [r for r in port.records if r["event"] == "train"]
    got = np.array([r["loss"] for r in records])
    assert records[-1]["augment"] == cfg.data.augment.describe()

    jsonl = str(tmp_path / "jax.jsonl")
    mesh = build_mesh(MeshSpec(("data",), (1,)), devices=jax.devices()[:1])
    tr = JaxTrainer(jax_cfg, mesh=mesh,
                    logger=JaxLogger(jsonl_path=jsonl, stream=io.StringIO()))
    state = _with_port_params(tr, tr.init_state(), cfg)
    tr.fit(state, dataset=iter(batches), num_steps=STEPS)
    want = _train_losses(jsonl)
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               err_msg=f"gap {np.abs(got / want - 1)}")

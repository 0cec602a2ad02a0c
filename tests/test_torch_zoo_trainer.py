"""The zoo presets through the port's trainer, against the JAX package's
`Trainer`: BatchNorm's statistics through the state, the step, the EMA,
the non-finite skip, grad accumulation, checkpoints, eval and the CLI.

The ResNet is `resnet50_imagenet` narrowed by dotted keys both packages
take (NARROW: 10 classes, 32 px, fp32, augment off, global batch 16, LR
0.002 at a reference batch of 16 without warmup, ZeRO-2 over ~0.5 KB
buckets) and `model.extra.stage_sizes` (1, 1, 1, 1); it has no dropout.
The LR is small because at 0.01 the loss on these random labels rises
from step 5, and there the two frameworks' roundings part by up to 1e-3
in the statistics at step 6 (measured); at 0.002 they stay within 2e-6.
Batches are finished float images (standard normal; rows 8-15 shifted by
1 and scaled by 1.5, so rank 1's statistics are not rank 0's), which the
device finish passes as they are on both sides. The port starts from
weights.init_params and init_batch_stats; JAX's state is given the same
params (and EMA params).

- ZeRO-2 with sync-BN on 2 gloo ranks (tests/_torch_zoo_worker.py)
  against JAX's `Trainer.fit` on a 2-device mesh fed the same global
  batches, train.ema_decay 0.9, 6 steps: losses rtol 1e-5, the running
  statistics and their EMA rtol 1e-4 / atol 1e-5 (statistics of
  activations that two frameworks' fp32 convolutions round differently,
  after 6 updates), the statistics bit-equal on both ranks.
- grad_accum_steps=2 (the sharded accumulator under ZeRO-2): 3 steps on
  2 ranks against JAX's, the same tolerances; each step moves the
  statistics twice, so they differ from the k=1 run's.
- The non-finite skip (one process): a step on a batch holding a NaN is
  skipped, and the statistics and their EMA are bitwise what they were.
- A checkpoint and resume (one process, with the EMA) are bit-equal to an
  uninterrupted run, statistics and EMA included.
- JAX's checkpoint of the same run at step 3 (tools/orbax_to_port.py)
  restores into the port bit for bit (params, statistics, their EMA) and
  resumes on one process to JAX's losses and statistics at step 6 (one
  rank's local statistics over the global batch are JAX's pmean over two
  halves). Exact eval of JAX's step-6 checkpoint (the EMA weights and
  statistics) over 21 examples in batches of 8 (the last padded and
  masked): the port's top-1 and top-5 counts equal JAX's.
- `cli.main` (a narrow-ResNet preset registered for the test) in train,
  eval and predict modes on TFRecords of the JPEG fixture: the saved
  statistics are the trained ones, `--mode eval` equals the fit's eval
  at the same step, predict reads them.
- VGG-16 narrowed (block_sizes (1, 1, 1, 1, 1), block_features 8-16,
  fp32, dropout off, 10 classes, 32 px) for 5 steps on one process
  against JAX's one-device `Trainer.fit`: losses rtol 1e-5."""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_zoo_worker import run_group
from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.data.eval_pad import FiniteEvalIterable
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.train.trainer import Trainer as JaxTrainer
from distributed_vgg_f_tpu.utils.logging import MetricLogger as JaxLogger
from distributed_vgg_f_tpu_torch import cli
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.weights import (init_params,
                                                  params_to_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.orbax_to_port import convert  # noqa: E402
from tools.tfrecord_write import write_shards  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
BATCH, STEPS, SIZE = 16, 6, 32
EXTRA = {"stage_sizes": (1, 1, 1, 1)}
#: the narrowing, as dotted keys both packages take
NARROW = {"model.num_classes": "10", "model.compute_dtype": "float32",
          "data.image_size": str(SIZE), "data.global_batch_size": str(BATCH),
          "data.name": "synthetic", "data.num_train_examples": "160",
          "data.augment.enabled": "false", "data.autotune.enabled": "false",
          "optim.reference_batch_size": str(BATCH),
          "optim.warmup_epochs": "0", "optim.base_lr": "0.002",
          "mesh.comm_bucket_mb": "0.0005",
          "train.seed": "0", "train.log_every": "1",
          "train.ema_decay": "0.9"}
#: JAX-only switches the port has not (its planes, the mesh's axis size)
JAX_ONLY = {"telemetry.enabled": "false", "mesh.num_data": "0"}


def _with_extra(cfg, extra):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, extra=dict(extra)))


def _port_cfg(preset="resnet50_imagenet", extra=EXTRA, **over):
    return _with_extra(tcfg.apply_overrides(tcfg.get_config(preset),
                                            {**NARROW, **over}), extra)


def _jax_cfg(preset="resnet50_imagenet", extra=EXTRA, **over):
    return _with_extra(jcfg.apply_overrides(jcfg.get_config(preset),
                                            {**NARROW, **JAX_ONLY, **over}),
                       extra)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        image = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
            np.float32)
        image[BATCH // 2:] = image[BATCH // 2:] * 1.5 + 1.0
        out.append({"image": image,
                    "label": rng.integers(0, 10, BATCH).astype(np.int32)})
    return out


def _jax_fit(cfg, batches, devices=2, steps=None):
    """JAX's Trainer.fit from the port's initial weights; (trainer,
    losses, final state)."""
    import tempfile
    mesh = build_mesh(MeshSpec(("data",), (devices,)),
                      devices=jax.devices()[:devices])
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "jax.jsonl")
        tr = JaxTrainer(cfg, mesh=mesh, logger=JaxLogger(
            jsonl_path=jsonl, stream=io.StringIO()))
        state = tr.init_state()
        m = cfg.model
        tree = init_params(tcfg.ModelConfig(
            name=m.name, num_classes=m.num_classes,
            compute_dtype=m.compute_dtype, dropout_rate=m.dropout_rate,
            extra=dict(m.extra)), cfg.train.seed,
            image_size=cfg.data.image_size)
        rep = NamedSharding(tr.mesh, P())
        state = state.replace(
            params=jax.device_put(tree, rep),
            ema_params=(None if state.ema_params is None
                        else jax.device_put(tree, rep)))
        state = tr.fit(state, dataset=iter(batches),
                       num_steps=steps or len(batches))
        with open(jsonl) as f:
            losses = [r["loss"] for r in map(json.loads, f)
                      if r["event"] == "train"]
    return tr, np.array(losses), state


def _flat_stats(tree):
    """A Flax statistics tree -> {'<layer>.<leaf>': array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[".".join(str(k.key) for k in path)] = np.asarray(leaf)
    return out


def _worker_arrays(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def zero2_runs(tmp_path_factory):
    """The port on 2 ranks (k=1 and k=2) and JAX's runs of the same:
    k=1 with checkpoints at 3 and 6."""
    tmp = tmp_path_factory.mktemp("zoo_trainer")
    batches = _batches(STEPS)
    arrays = {}
    for i, b in enumerate(batches):
        arrays[f"batch{i}/image"] = b["image"]
        arrays[f"batch{i}/label"] = b["label"]
    cases = [{"name": "k1", "overrides": NARROW, "extra": EXTRA,
              "steps": STEPS},
             {"name": "k2", "overrides": {**NARROW,
                                          "train.grad_accum_steps": "2"},
              "extra": EXTRA, "steps": 3}]
    port = run_group(2, {"cases": cases}, arrays, str(tmp / "group"))
    ck = str(tmp / "jax_ck")
    jax_k1 = _jax_fit(_jax_cfg(**{"train.checkpoint_dir": ck,
                                  "train.checkpoint_every_steps": "3"}),
                      batches)
    jax_k2 = _jax_fit(_jax_cfg(**{"train.grad_accum_steps": "2"}),
                      batches[:3])
    yield port, jax_k1, jax_k2, ck, batches, tmp
    shutil.rmtree(tmp, ignore_errors=True)


def test_zero2_sync_bn_on_two_ranks_matches_jax(zero2_runs):
    port, (_, losses, state), _, _, _, _ = zero2_runs
    assert len(losses) == STEPS
    for r, out in enumerate(port):
        np.testing.assert_allclose(out["k1/loss"], losses, rtol=1e-5)
        assert json.loads(str(out["k1/comm_meta"]))["sharding"] == "zero2"
        _close(_worker_arrays(out, "k1/stats/"),
               _flat_stats(state.batch_stats), f"rank {r} stats")
    assert str(port[0]["k1/stats_sha"]) == str(port[1]["k1/stats_sha"])
    # the statistics moved off their init
    assert np.abs(port[0]["k1/stats/bn_init.mean"]).max() > 1e-2


def test_ema_of_the_statistics_follows_jax(zero2_runs):
    port, (_, _, state), _, _, _, _ = zero2_runs
    want = _flat_stats(state.ema_batch_stats)
    for r, out in enumerate(port):
        got = _worker_arrays(out, "k1/ema_stats/")
        _close(got, want, f"rank {r} ema stats")
        # the EMA lags the statistics
        assert not np.allclose(got["bn_init.mean"],
                               out["k1/stats/bn_init.mean"])


def test_grad_accumulation_moves_the_statistics_as_jax(zero2_runs):
    port, (_, losses1, _), (_, losses, state), _, _, _ = zero2_runs
    for r, out in enumerate(port):
        np.testing.assert_allclose(out["k2/loss"], losses, rtol=1e-5)
        _close(_worker_arrays(out, "k2/stats/"),
               _flat_stats(state.batch_stats), f"rank {r} k=2 stats")
    assert not np.allclose(port[0]["k2/loss"][1:], losses1[1:3])


def test_jax_checkpoint_restores_and_resumes_in_the_port(zero2_runs):
    _, (_, losses, state), _, ck, batches, tmp = zero2_runs
    dst = str(tmp / "port_ck")
    assert convert(ck, dst, step=3) == 3
    cfg = _port_cfg(**{"train.checkpoint_dir": dst})
    tr = Trainer(cfg, device="cpu")
    restored = tr.restore_or_init()
    assert restored.step == 3
    from distributed_vgg_f_tpu_torch.checkpoint.manager import \
        CheckpointManager
    saved, _ = CheckpointManager(dst).restore(3)
    for prefix, stats in (("batch_stats", restored.batch_stats),
                          ("ema_batch_stats", restored.ema_batch_stats)):
        for k, v in stats.items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(saved[f"{prefix}/"
                                            f"{k.replace('.', '/')}"]))
    state_p = tr.fit(restored, batches[3:], num_steps=STEPS)
    got = [r["loss"] for r in tr.records if r["event"] == "train"]
    np.testing.assert_allclose(got, losses[3:], rtol=1e-5)
    _close({k: v.numpy() for k, v in state_p.batch_stats.items()},
           _flat_stats(state.batch_stats), "resumed stats")
    _close({k: v.numpy() for k, v in state_p.ema_batch_stats.items()},
           _flat_stats(state.ema_batch_stats), "resumed ema stats")


class _Finite:
    """A finite eval split in batches of `b`, the last padded and masked
    (the port's `evaluate` scores such a dataset to its end)."""
    is_finite = True

    def __init__(self, images, labels, b):
        self.images, self.labels, self.b = images, labels, b

    def __iter__(self):
        for s in range(0, len(self.labels), self.b):
            n = min(self.b, len(self.labels) - s)
            image = np.zeros((self.b,) + self.images.shape[1:], np.float32)
            label = np.zeros((self.b,), np.int32)
            image[:n], label[:n] = self.images[s:s + n], self.labels[s:s + n]
            yield {"image": image, "label": label,
                   "valid": np.arange(self.b) < n}


def test_exact_eval_of_a_jax_checkpoint_counts_as_jax(zero2_runs):
    _, (jtr, _, state), _, ck, _, tmp = zero2_runs
    rng = np.random.default_rng(5)
    images = rng.standard_normal((21, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 21).astype(np.int32)

    def factory():
        for s in range(0, 21, 4):
            yield {"image": images[s:s + 4], "label": labels[s:s + 4]}

    want = jtr.evaluate(state, FiniteEvalIterable(
        factory, 4, (SIZE, SIZE, 3), np.float32))
    dst = str(tmp / "port_eval_ck")
    assert convert(ck, dst, step=STEPS) == STEPS
    tr = Trainer(_port_cfg(**{"train.checkpoint_dir": dst,
                              "data.global_batch_size": "8"}), device="cpu")
    got = tr.evaluate(tr.restore_or_init(), _Finite(images, labels, 8))
    assert got["eval_examples"] == want["eval_examples"] == 21
    for key in ("eval_top1", "eval_top5"):
        assert round(got[key] * 21) == round(want[key] * 21), key


def _one_process(steps, batches, ck=None, every=1000, state=None,
                 trainer=None, **over):
    extra = {"train.checkpoint_dir": ck or "",
             "train.checkpoint_every_steps": str(every), **over}
    tr = trainer or Trainer(_port_cfg(**extra), device="cpu")
    state = tr.fit(state if state is not None or ck else tr.init_state(),
                   batches, num_steps=steps)
    return tr, state


def _snapshot(state):
    return ({k: v.clone() for k, v in state.batch_stats.items()},
            {k: v.clone() for k, v in state.ema_batch_stats.items()},
            {k: p.detach().clone() for k, p in
             state.model.named_parameters()})


def test_nonfinite_skip_leaves_statistics_and_their_ema():
    batches = _batches(3, seed=2)
    batches[1]["image"][3, 0, 0, 0] = np.nan
    tr = Trainer(_port_cfg(), device="cpu")
    state = tr.fit(tr.init_state(), batches[:1], num_steps=1)
    before = _snapshot(state)
    state = tr.fit(state, batches[1:2], num_steps=2)
    after = _snapshot(state)
    recs = [r for r in tr.records if r["event"] == "train"]
    assert [r["bad_step"] for r in recs] == [0.0, 1.0]
    assert state.step == 2 and state.opt_count == 1
    for a, b in zip(before, after):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    state = tr.fit(state, batches[2:], num_steps=3)
    assert not torch.equal(state.batch_stats["bn_init.mean"],
                           before[0]["bn_init.mean"])


def test_checkpoint_and_resume_are_bit_equal_with_statistics(tmp_path):
    batches = _batches(4, seed=3)
    _, full = _one_process(4, batches)
    ck = str(tmp_path / "ck")
    _one_process(2, batches[:2], ck=ck, every=2)
    tr = Trainer(_port_cfg(**{"train.checkpoint_dir": ck,
                              "train.checkpoint_every_steps": "2"}),
                 device="cpu")
    resumed = tr.fit(None, batches[2:], num_steps=4)
    assert [r["step"] for r in tr.records if r["event"] == "restore"] == [2]
    for a, b in zip(_snapshot(resumed), _snapshot(full)):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    assert resumed.ema_batch_stats.keys() == full.batch_stats.keys()


# ------------------------------------------------------------------- CLI
def _narrow_preset():
    return _port_cfg(**{"data.name": "imagenet", "data.native_threads": "2",
                        "data.global_batch_size": "8",
                        "optim.reference_batch_size": "8",
                        "data.num_train_examples": "32"})


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_cli")
    data = str(root / "data")
    jpegs = [open(os.path.join(FIXTURE, f), "rb").read()
             for f in sorted(os.listdir(FIXTURE))]
    labels = [1 + k % 10 for k in range(len(jpegs))]
    write_shards(data, jpegs, labels, shards=2, per_shard=16)
    write_shards(data, jpegs, labels, shards=1, per_shard=21,
                 prefix="validation")
    ck = str(root / "ck")
    argv = ["--config", "resnet_narrow", "--set", f"data.data_dir={data}",
            "--set", f"train.checkpoint_dir={ck}", "--set", "train.steps=4",
            "--set", "train.eval_every_steps=4",
            "--set", "train.checkpoint_every_steps=4"]
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tcfg.PRESETS, "resnet_narrow", _narrow_preset)
        for extra in ([], ["--mode", "eval"],
                      ["--mode", "predict", "--images", FIXTURE]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(argv + extra, device="cpu")
            outs.append(out.getvalue())
        cfg = tcfg.apply_overrides(_narrow_preset(), {
            "train.checkpoint_dir": ck, "data.data_dir": data})
        restored = Trainer(cfg, device="cpu").restore_or_init()
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    yield ck, recs, outs, restored
    shutil.rmtree(root, ignore_errors=True)


def test_cli_trains_evaluates_and_predicts_with_the_statistics(cli_run):
    ck, recs, outs, restored = cli_run
    assert restored.step == 4
    saved = {}
    for layer, leaves in params_to_flax(restored.batch_stats).items():
        for sub, arr in jax.tree_util.tree_leaves_with_path(leaves):
            path = "/".join((layer,) + tuple(str(k.key) for k in sub))
            saved[path] = np.load(os.path.join(
                ck, "4", "state", "batch_stats", path + ".npy"))
            np.testing.assert_array_equal(arr, saved[path])
    assert np.abs(saved["bn_init/mean"]).max() > 1e-3     # trained, not init
    evals = [r for r in recs if r["event"] == "eval"]
    assert [r["step"] for r in evals] == [4, 4]
    assert all(r["eval_examples"] == 21 for r in evals)
    assert {k: evals[0][k] for k in ("eval_top1", "eval_top5")} == \
        {k: evals[1][k] for k in ("eval_top1", "eval_top5")}
    predicted = [json.loads(line) for line in outs[2].splitlines()
                 if line.startswith("{")]
    assert len(predicted) == 16 and all(len(p["top_k"]) == 5
                                        for p in predicted)


def test_cli_predict_reads_the_ema_statistics(cli_run, monkeypatch):
    """Predict swaps in the EMA weights and the EMA statistics together
    (JAX `train/predict.py:76–77`)."""
    ck, _, _, restored = cli_run
    from distributed_vgg_f_tpu_torch.train.predict import \
        restore_predict_params
    monkeypatch.setitem(tcfg.PRESETS, "resnet_narrow", _narrow_preset)
    cfg = tcfg.apply_overrides(_narrow_preset(),
                               {"train.checkpoint_dir": ck})
    model = restore_predict_params(Trainer(cfg, device="cpu"))
    stats = {k: v for k, v in model.named_buffers()}
    for k, v in restored.ema_batch_stats.items():
        assert torch.equal(stats[k], v), k
    assert not torch.equal(stats["bn_init.mean"],
                           restored.batch_stats["bn_init.mean"])


# ---------------------------------------------------------------- VGG-16
def test_narrow_vgg16_trajectory_matches_jax():
    extra = {"block_sizes": (1, 1, 1, 1, 1),
             "block_features": (8, 8, 16, 16, 16)}
    over = {"model.dropout_rate": "0.0", "train.ema_decay": "0.0"}
    batches = _batches(5, seed=4)
    _, losses, _ = _jax_fit(_jax_cfg("vgg16_imagenet", extra, **over),
                            batches, devices=1)
    tr = Trainer(_port_cfg("vgg16_imagenet", extra, **over), device="cpu")
    tr.fit(tr.init_state(), batches, num_steps=5)
    got = [r["loss"] for r in tr.records if r["event"] == "train"]
    assert len(losses) == 5
    np.testing.assert_allclose(got, losses, rtol=1e-5)


def test_packed_layout_on_another_model_raises_as_jax():
    """`--set model.name=resnet50` on the flagship keeps its packed
    layout, which only VGG-F's stem takes: both trainers refuse it."""
    over = {"model.name": "resnet50"}
    cfg = tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"), over)
    jax_cfg = jcfg.apply_overrides(jcfg.get_config("vggf_imagenet_dp"),
                                   over)
    assert cfg.data.space_to_depth and jax_cfg.data.space_to_depth
    with pytest.raises(ValueError, match="space_to_depth"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="space_to_depth"):
        JaxTrainer(jax_cfg)

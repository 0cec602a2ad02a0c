"""The port's command line (distributed_vgg_f_tpu_torch/cli.py), its
config overrides, JSONL records and predict, against the JAX package's.

- `parse_cli` against JAX's on the same argv: every field both configs
  have takes the same value, on the flagship and on every preset both
  packages have (the zoo's `vgg16_imagenet` and `resnet50_imagenet`
  among them), and both refuse the same malformed items;
  keys the port has not raise, naming their ROADMAP item.
- `MetricLogger`: non-finite floats written as null with a sibling
  `<key>_nonfinite`, a schema_version on every record; the port's
  validator agrees with JAX's on good and bad records.
- The CLI on the CPU at narrow widths (stem 8, convs 16, FC 32, 10
  classes, 32 px, fp32) over TFRecords of the JPEG fixture: train with
  the eval cadence and the best slot, a SIGTERM stop, the resume, `--mode
  eval` (from the latest and from the best slot) and `--mode predict`;
  its metrics.jsonl passes both packages' `validate_metrics_jsonl`. The
  refusals: eval or predict without a checkpoint, serve, no eval split.
- Under torchrun with 4 gloo ranks (tests/_torch_cli_run.py): SIGTERM to
  rank 2 alone stops every rank at one committed step, a restart resumes
  it, and a one-process `--mode eval` equals the 4-rank eval.
- `run_predict`'s probabilities against JAX's `build_forward` on the same
  params (weights.params_to_flax) and the same decoded batch: within
  1e-5 (fp32; the two frameworks' convolutions round differently)."""

import contextlib
import dataclasses
import io
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cli_run import cli_scenario
from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.data.device_ingest import \
    make_device_finish as jax_finish
from distributed_vgg_f_tpu.models.vggf import VGGF as JaxVGGF
from distributed_vgg_f_tpu.telemetry import schema as jschema
from distributed_vgg_f_tpu.train.predict import build_forward as jax_forward
from distributed_vgg_f_tpu_torch import cli
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.data.native_jpeg import \
    NativeJpegEvalIterator
from distributed_vgg_f_tpu_torch.telemetry import schema as tschema
from distributed_vgg_f_tpu_torch.train.predict import run_predict
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.utils.logging import MetricLogger
from distributed_vgg_f_tpu_torch.weights import params_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.tfrecord_write import write_shards  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
NARROW = ["--set", "model.num_classes=10",
          "--set", "model.compute_dtype=float32",
          "--set", "model.extra.stem_features=8",
          "--set", "model.extra.conv_features=16",
          "--set", "model.extra.fc_features=32",
          "--set", "data.image_size=32", "--set", "data.global_batch_size=8",
          "--set", "data.num_train_examples=32",
          "--set", "data.native_threads=2"]


def _fields(cfg, path=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{path}{f.name}."))
        else:
            out[path + f.name] = tuple(v) if isinstance(v, list) else v
    return out


# ------------------------------------------------------------- overrides
@pytest.mark.parametrize("sets", [
    [],
    ["data.global_batch_size=512", "train.steps=7", "train.seed=3"],
    ["optim.decay_epochs=20,40", "optim.base_lr=0.5",
     "optim.nesterov=yes"],
    ["train.handle_preemption=off", "train.track_best_eval=0",
     "train.restore_from_best=true", "train.eval_every_steps=10"],
    ["data.num_eval_examples=1200",
     "data.augment.mixup_alpha=0.4", "data.augment.hflip=false"],
    ["model.extra.stem_features=8", "model.extra.flag=true",
     "model.extra.ratio=0.5", "mesh.comm_bucket_mb=2",
     "mesh.reduce_dtype=bfloat16"],
    ["data.autotune.enabled=false"],
])
def test_parse_cli_matches_jax_on_every_shared_field(sets):
    argv = ["--config", "vggf_imagenet_dp", "--mode", "eval"]
    for item in sets:
        argv += ["--set", item]
    ours, args = tcfg.parse_cli(argv, with_mode=True)
    ref, jargs = jcfg.parse_cli(argv, with_mode=True)
    assert (args.mode, args.images) == (jargs.mode, jargs.images)
    a, b = _fields(ours), _fields(ref)
    shared = set(a) & set(b)
    assert len(shared) > 60
    for key in sorted(shared):
        assert a[key] == b[key], key


@pytest.mark.parametrize("sets", [[], ["model.name=resnet50"],
                                  ["model.extra.stem=space_to_depth",
                                   "train.ema_decay=0.999"]])
@pytest.mark.parametrize("preset", sorted(set(tcfg.PRESETS)
                                          & set(jcfg.PRESETS)))
def test_every_shared_preset_matches_jax_field_by_field(preset, sets):
    argv = ["--config", preset]
    for item in sets:
        argv += ["--set", item]
    a = _fields(tcfg.parse_cli(argv))
    b = _fields(jcfg.parse_cli(argv))
    shared = set(a) & set(b)
    assert len(shared) > 60
    for key in sorted(shared):
        assert a[key] == b[key], key


def test_the_zoo_presets_are_shared():
    assert {"vgg16_imagenet", "resnet50_imagenet", "vit_s16_imagenet",
            "vggf_imagenet_dp", "vggf_teacher"} <= set(tcfg.PRESETS) \
        & set(jcfg.PRESETS)


def test_parse_cli_defaults_to_the_flagship():
    assert tcfg.parse_cli([]).name == "vggf_imagenet_dp"


@pytest.mark.parametrize("item", ["train.steps", "=3"])
def test_both_refuse_a_malformed_item(item, capsys):
    for parse in (tcfg.parse_cli, jcfg.parse_cli):
        with pytest.raises(SystemExit):
            parse(["--config", "vggf_imagenet_dp", "--set", item])


@pytest.mark.parametrize("item", ["train.bogus=1", "model.bogus.x=1",
                                  "train.handle_preemption=maybe",
                                  "train.steps=many"])
def test_both_refuse_an_unknown_key_or_a_bad_value(item):
    for parse in (tcfg.parse_cli, jcfg.parse_cli):
        with pytest.raises((KeyError, AttributeError, ValueError,
                            SystemExit)):
            parse(["--config", "vggf_imagenet_dp", "--set", item])


@pytest.mark.parametrize("key,item", [
    ("train.tensorboard_dir=/tb", "A14"), ("telemetry.enabled=false", "A14"),
    ("data.wire=host_f32", "A17"),
    ("mesh.elastic.min_survivors=3", "A13"), ("serving.enabled=true", "A11"),
    ("data.augment.rand_magnitude=0.3", "A4"),
    ("train.checkpoint_save_retries=5", "A14"),
    ("train.resume_data_fast_forward=false", "A14"),
    ("data.iterator_state.enabled=false", "A14"),
    ("data.autotune.k_windows=5", "A14b"), ("data.prefetch=4", "A14b"),
    ("data.autotune.max_restart_fanout=4", "A14b"),
    ("data.snapshot_cache.validate=false", "A14b")])
def test_keys_the_port_has_not_raise_naming_their_item(key, item):
    jcfg.parse_cli(["--config", "vggf_imagenet_dp", "--set", key])
    with pytest.raises(KeyError, match=f"ROADMAP {item}"):
        tcfg.parse_cli(["--set", key])


@pytest.mark.parametrize("items,error", [
    (["data.snapshot_cache.enabled=true"], None),
    (["data.snapshot_cache.enabled=true", "data.snapshot_cache.dir=/s",
      "data.snapshot_cache.capacity_bytes=4096"], None),
    (["data.snapshot_cache.capacity_bytes=0"],
     "data.snapshot_cache.capacity_bytes must be > 0, got 0")])
def test_snapshot_cache_keys_behave_as_jax(items, error, capsys):
    argv = ["--config", "vggf_imagenet_dp"]
    for item in items:
        argv += ["--set", item]
    if error is None:
        port, ref = tcfg.parse_cli(argv), jcfg.parse_cli(argv)
        # JAX's `validate` is refused in the port: warm reads are checked
        assert dataclasses.asdict(port.data.snapshot_cache) == {
            k: v for k, v in dataclasses.asdict(
                ref.data.snapshot_cache).items() if k != "validate"}
        assert ref.data.snapshot_cache.validate
        assert port.data.snapshot_cache.enabled
        return
    for parse in (tcfg.parse_cli, jcfg.parse_cli):
        with pytest.raises(SystemExit):
            parse(argv)
        assert error in capsys.readouterr().err


def test_new_train_fields_validate():
    train, ref = tcfg.TrainConfig(), jcfg.TrainConfig()
    for name in ("eval_every_steps", "track_best_eval", "restore_from_best",
                 "handle_preemption"):
        assert getattr(train, name) == getattr(ref, name), name
    # the retry budget is the manager's constant, not a field the port
    # would accept and ignore
    with pytest.raises(TypeError, match="checkpoint_save_retries"):
        tcfg.TrainConfig(checkpoint_save_retries=2)
    assert tcfg.get_config("vggf_teacher").train.eval_every_steps == 256


# ------------------------------------------------------------- the logger
def test_metric_logger_writes_nonfinite_as_null_with_a_name(tmp_path):
    path = str(tmp_path / "m.jsonl")
    out = io.StringIO()
    with MetricLogger(jsonl_path=path, stream=out) as logger:
        logger.log("train", {"step": 1, "loss": float("nan"),
                             "grad_norm": float("inf"),
                             "top1": torch.tensor(0.5),
                             "nested": {"x": float("-inf"), "y": 1.0},
                             "list": [1.0, float("nan")]})
    rec = json.loads(open(path).read())
    assert rec["event"] == "train" and rec["schema_version"] == "1.0"
    assert rec["loss"] is None and rec["loss_nonfinite"] == "nan"
    assert rec["grad_norm"] is None and rec["grad_norm_nonfinite"] == "inf"
    assert rec["nested"] == {"x": None, "x_nonfinite": "-inf", "y": 1.0}
    assert rec["list"] == [1.0, None] and rec["top1"] == 0.5
    assert out.getvalue().startswith("[train] step=1 loss=nan")
    assert "nested" not in out.getvalue()
    assert tschema.validate_metrics_jsonl(path) == []
    assert jschema.validate_metrics_jsonl(path) == []
    logger.close()  # a second close is a no-op


@pytest.mark.parametrize("record", [
    {"event": "train", "loss": 1.0},
    {"event": "train", "schema_version": "1.3", "loss": 1.0},
    {"event": "train", "schema_version": "2.0"},
    {"event": "", "x": 1},
    {"event": "train", "loss": float("nan")},
    {"event": "train", "comm": {"sharding": "dp", "bucketed": False,
                                "buckets": 1, "bucket_mb": 0.0,
                                "wire_bytes": 10}},
    {"event": "train", "comm": {"sharding": "zero9", "bucketed": 1}},
    {"event": "train", "augment": {"enabled": True,
                                   "host_flips_disabled": True,
                                   "mixup_alpha": -1}},
    {"event": "train", "iterator_state": {"cursor": 1, "source_cursor": 3,
                                          "in_flight": 2, "epoch": 0,
                                          "rebuilds": 0, "wire": "u8"}},
    {"event": "train", "iterator_state": {"cursor": -1}},
])
def test_record_validator_agrees_with_jax(record):
    ours = tschema.validate_metrics_record(record)
    ref = jschema.validate_metrics_record(record)
    assert bool(ours) == bool(ref), (ours, ref)


# ---------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """2 train shards of 16 records and a validation shard of 21 (8, 8
    and a partial 5 at batch 8)."""
    root = str(tmp_path_factory.mktemp("cli_tfrecords"))
    jpegs = [open(os.path.join(FIXTURE, f), "rb").read()
             for f in sorted(os.listdir(FIXTURE))]
    labels = [1 + k % 10 for k in range(len(jpegs))]
    write_shards(root, jpegs, labels, shards=2, per_shard=16)
    write_shards(root, jpegs, labels, shards=1, per_shard=21,
                 prefix="validation")
    return root


def _argv(data_dir, ck, *extra):
    return ["--set", f"data.data_dir={data_dir}",
            "--set", f"train.checkpoint_dir={ck}", *NARROW,
            "--set", "train.steps=12", "--set", "train.eval_every_steps=4",
            "--set", "train.log_every=2",
            "--set", "train.checkpoint_every_steps=4", *extra]


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv, device="cpu")
    return out.getvalue()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class _SigtermAfter:
    """Trainer whose step SIGTERMs this process after step `k`."""

    def __init__(self, monkeypatch, k):
        import signal

        from distributed_vgg_f_tpu_torch.train import trainer as mod
        base = mod.Trainer

        class Signalling(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                inner = self.train_step

                def step(state, batch, seed):
                    state, metrics = inner(state, batch, seed)
                    if state.step == k:
                        os.kill(os.getpid(), signal.SIGTERM)
                    return state, metrics

                step.comm_meta = inner.comm_meta
                self.train_step = step

        monkeypatch.setattr(mod, "Trainer", Signalling)


@pytest.fixture(scope="module")
def cli_run(data_dir, tmp_path_factory):
    """Train (SIGTERM after step 5), resume to 12, eval from the latest
    and from the best slot, predict the fixture."""
    ck = str(tmp_path_factory.mktemp("cli") / "ck")
    argv = _argv(data_dir, ck)
    with pytest.MonkeyPatch.context() as mp:
        _SigtermAfter(mp, 5)
        _main(argv)
    first = _records(os.path.join(ck, "metrics.jsonl"))
    _main(argv)
    _main(argv + ["--mode", "eval"])
    _main(argv + ["--mode", "eval", "--set", "train.restore_from_best=true"])
    predicted = _main(argv + ["--mode", "predict", "--images", FIXTURE])
    return ck, argv, first, _records(os.path.join(ck, "metrics.jsonl")), \
        predicted


def test_cli_stops_on_sigterm_with_a_forced_save_and_resumes(cli_run):
    ck, _, first, recs, _ = cli_run
    assert first[-1] == {"event": "preempt", "schema_version": "1.0",
                         "step": 5, "checkpointed": True}
    second = recs[len(first):]
    assert {"event": "restore", "schema_version": "1.0", "step": 5,
            "best": False} in second
    assert any(r["event"] == "iterator_state_restore"
               and r["replayed_batches"] == 0 for r in second)
    steps = [r["step"] for r in recs if r["event"] == "train"]
    assert steps == [2, 4, 6, 8, 10, 12]   # no record at the stop, as in JAX


def test_cli_evaluates_exactly_at_the_cadence_and_keeps_the_best(cli_run):
    ck, _, _, recs, _ = cli_run
    evals = [r for r in recs if r["event"] == "eval"]
    assert [r["step"] for r in evals] == [4, 8, 12, 12, evals[-1]["step"]]
    assert all(r["eval_examples"] == 21 for r in evals)
    best = [r for r in recs if r["event"] == "best_checkpoint"]
    assert best and best[0]["step"] == 4
    # the best slot's eval gives the score it was saved with
    assert evals[-1]["step"] == best[-1]["step"]
    assert evals[-1]["eval_top1"] == best[-1]["eval_top1"]
    # --mode eval of the latest gives the in-fit eval at 12
    assert {k: evals[3][k] for k in ("eval_top1", "eval_top5")} == \
        {k: evals[2][k] for k in ("eval_top1", "eval_top5")}
    train = [r for r in recs if r["event"] == "train"]
    assert all({"augment", "comm", "iterator_state"} <= set(r)
               for r in train)
    assert train[-1]["comm"]["sharding"] == "dp"   # one process


def test_cli_jsonl_passes_both_validators(cli_run):
    ck = cli_run[0]
    path = os.path.join(ck, "metrics.jsonl")
    assert tschema.validate_metrics_jsonl(path) == []
    assert jschema.validate_metrics_jsonl(path) == []


def test_cli_predict_prints_one_record_a_jpeg(cli_run):
    predicted = [json.loads(line) for line in cli_run[4].splitlines()
                 if line.startswith("{")]
    assert len(predicted) == 16
    for rec in predicted:
        assert rec["file"].startswith(FIXTURE) and len(rec["top_k"]) == 5
        probs = [e["prob"] for e in rec["top_k"]]
        assert probs == sorted(probs, reverse=True)


def test_cli_refusals(data_dir, tmp_path):
    empty = str(tmp_path / "empty")
    for mode in ("eval", "predict"):
        with pytest.raises(SystemExit, match="no checkpoint"):
            _main(_argv(data_dir, empty, "--mode", mode))
    with pytest.raises(SystemExit, match="ROADMAP A11"):
        _main(_argv(data_dir, empty, "--mode", "serve"))
    # no validation split: logged, and training goes on without evals
    train_only = str(tmp_path / "train_only")
    os.makedirs(train_only)
    for f in os.listdir(data_dir):
        if f.startswith("train-"):
            os.symlink(os.path.join(data_dir, f), os.path.join(train_only, f))
    ck = str(tmp_path / "ck")
    _main(_argv(train_only, ck, "--set", "train.steps=2"))
    recs = _records(os.path.join(ck, "metrics.jsonl"))
    assert recs[0]["event"] == "eval_dataset_unavailable"
    assert "validation-*" in recs[0]["error"]
    assert not any(r["event"] == "eval" for r in recs)


def test_cli_across_four_gloo_ranks(tmp_path):
    out = cli_scenario(tmp_path, device="cpu")
    assert out["preempted_at"] - out["signal_after_step"] <= 3


# ---------------------------------------------------------------- predict
def test_run_predict_matches_jax_build_forward(cli_run, tmp_path):
    ck, argv, _, _, _ = cli_run
    cfg = tcfg.parse_cli(argv)
    tr = Trainer(cfg, device="cpu")
    files = sorted(os.path.join(FIXTURE, f) for f in os.listdir(FIXTURE))
    recs = run_predict(tr, files, top_k=10, stream=io.StringIO())
    state = tr.restore_or_init()
    params = params_to_flax({k: v for k, v in
                             state.model.state_dict().items()})
    dec = NativeJpegEvalIterator(
        files, [0] * len(files), len(files), cfg.data.image_size,
        mean=np.asarray(cfg.data.mean_rgb, np.float32),
        std=np.asarray(cfg.data.stddev_rgb, np.float32))
    batch = next(iter(dec))
    dec.close()
    model = JaxVGGF(num_classes=10, dropout_rate=0.0,
                    compute_dtype=jnp.float32, stem_features=8,
                    conv_features=16, fc_features=32)
    forward = jax_forward(model, jax.tree_util.tree_map(jnp.asarray, params),
                          None, jax_finish(cfg.data.mean_rgb,
                                           cfg.data.stddev_rgb))
    want = np.asarray(jax.jit(forward)(jnp.asarray(batch["image"])))
    assert len(recs) == len(files)
    for rec, row in zip(recs, want):
        got = np.zeros(10, np.float32)
        for e in rec["top_k"]:
            got[e["class"]] = e["prob"]
        # the JPEG path rounds to 6 digits, as the JAX package's does
        np.testing.assert_allclose(got, row, atol=1e-5 + 5e-7)
        assert math.isclose(sum(got), 1.0, abs_tol=1e-5)


def test_run_predict_arrays_go_through_the_serving_engine(cli_run, tmp_path):
    """.npy u8 inputs run the engine's bucketed path at full precision;
    mixed with JPEGs they raise."""
    from distributed_vgg_f_tpu_torch.serving.engine import PredictEngine
    ck, argv, _, _, _ = cli_run
    cfg = tcfg.parse_cli(argv)
    rng = np.random.default_rng(0)
    files = []
    for i in range(3):
        files.append(str(tmp_path / f"a{i}.npy"))
        np.save(files[-1], rng.integers(0, 256, (32, 32, 3), np.uint8))
    tr = Trainer(cfg, device="cpu")
    recs = run_predict(tr, files, top_k=3, batch=2, stream=io.StringIO())
    model = tr.restore_or_init().model
    engine = PredictEngine(model_name="vggf", model=model, image_size=32,
                           num_classes=10, buckets=(2,), max_batch=2,
                           mean_rgb=cfg.data.mean_rgb,
                           stddev_rgb=cfg.data.stddev_rgb, device="cpu")
    probs = np.concatenate([
        engine.run(np.stack([np.load(f) for f in files[:2]]))[0],
        engine.run(np.stack([np.load(files[2])]))[0]])
    for rec, row in zip(recs, probs):
        top = np.argsort(row)[::-1][:3]
        assert [e["class"] for e in rec["top_k"]] == list(top)
        assert [e["prob"] for e in rec["top_k"]] == [float(row[c])
                                                     for c in top]
    with pytest.raises(ValueError, match="cannot mix"):
        run_predict(tr, files + [os.path.join(FIXTURE, "img_00.jpg")],
                    stream=io.StringIO())

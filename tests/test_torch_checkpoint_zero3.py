"""ZeRO-3 checkpoints: the flat params through the port's manager, its
any-topology restore (checkpoint/retopology.py, the params half), JAX's
ZeRO-3 checkpoints through tools/orbax_to_port.py, and the command line.

- The retopology gates (JAX `tests/test_zero3.py:404`), with the narrow
  VGG-F of tests/test_torch_checkpoint_jax.py (fp32, dropout and augment
  off, ~0.5 KB buckets, EMA 0.9) through `Trainer.fit()` on 4 gloo ranks
  (tests/_torch_dp_worker.py), 2 steps and a save each: (a) ZeRO-3
  written, ZeRO-3 restored: params, EMA, momentum shard and count
  bit-equal to what was saved, and a resume to step 4 bit-equal to an
  uninterrupted run; (b) ZeRO-3 written, ZeRO-2 restored (flat -> tree);
  (c) ZeRO-2 written, ZeRO-3 restored (tree -> flat, the way back);
  (d) a ZeRO-1-era checkpoint (tree params, the canonical flat momentum,
  no receipt) restored into bucketed ZeRO-3. Then N -> M: the ZeRO-3
  step restored on 2 ranks (ZeRO-3 and ZeRO-2) and in one process
  (replicated SGD). Every restore holds the saved values bit for bit.
- The typed refusals: a `param_layout` receipt whose length disagrees
  with the saved vector, a `bucketed_flat` one with no `opt_layout` to
  name the buckets, one beside tree params, and an unknown kind each
  raise GeometryReceiptError from the arrays' headers, before any array
  is read or anything written.
- JAX's ZeRO-3 `Trainer` (2 of the 8 virtual CPU devices, bucketed and
  canonical flat) saves at step 2; tools/orbax_to_port.py converts it
  with its receipts; the port resumes it on 2 gloo ranks under ZeRO-3 to
  step 4 and is held against JAX's own 4 steps at
  tests/test_torch_zero_jax.py's tolerances (losses rtol 2e-6, params
  and the (T,) momentum atol 1e-6 + rtol 1e-5).
- The command line under torchrun with 4 gloo ranks and
  `--set mesh.shard_params=true` over ~0.5 KB buckets
  (tests/_torch_cli_run.py
  `cli_scenario`): train with an eval cadence, SIGTERM, the forced save,
  the resume, `--mode eval` in one process equal to the 4-rank eval; then
  `--mode predict` and `--mode serve` from that checkpoint answer alike."""

import contextlib
import io
import json
import os
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

from _torch_cli_run import cli_scenario
from _torch_dp_worker import checkpoint_config, run_group
from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu import telemetry as jtelemetry
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.train.trainer import Trainer as JaxTrainer
from distributed_vgg_f_tpu.utils.logging import MetricLogger
from distributed_vgg_f_tpu_torch.checkpoint.manager import (CheckpointManager,
                                                            LeafMeta)
from distributed_vgg_f_tpu_torch.checkpoint.retopology import \
    restore_any_topology
from distributed_vgg_f_tpu_torch.parallel.zero import (convert_opt_state,
                                                       zero_layout)
from distributed_vgg_f_tpu_torch.resilience.errors import \
    GeometryReceiptError
from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
from distributed_vgg_f_tpu_torch.train.state import TrainState
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.weights import params_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.orbax_to_port import convert  # noqa: E402

WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
SIZE, CLASSES, BATCH, LR, WD = 32, 10, 16, 0.05, 1e-4
BUCKET_MB = 0.0005
SPEC = {"widths": WIDTHS, "size": SIZE, "classes": CLASSES, "batch": BATCH,
        "lr": LR, "weight_decay": WD}


@pytest.fixture(scope="module", autouse=True)
def _jax_telemetry_found():
    """JAX's process-wide telemetry switches as this module found them,
    given back at its end: a JAX `Trainer` built with
    `telemetry.enabled=false` switches them off for the whole process."""
    found = (jtelemetry.get_registry().enabled,
             jtelemetry.get_recorder().enabled)
    yield found
    _give_back_jax_telemetry(found)


@pytest.fixture(autouse=True)
def _jax_telemetry_given_back(_jax_telemetry_found):
    yield
    _give_back_jax_telemetry(_jax_telemetry_found)


def _give_back_jax_telemetry(found):
    jtelemetry.configure(enabled=found[0])
    jtelemetry.get_recorder().enabled = found[1]


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"image": rng.standard_normal(
                 (BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)}
            for _ in range(n)]


def _arrays(batches):
    out = {}
    for i, b in enumerate(batches):
        out[f"batch{i}/image"] = b["image"]
        out[f"batch{i}/label"] = b["label"]
    return out


def _of(rank_out, case, what):
    prefix = f"{case}/{what}/"
    return {k[len(prefix):]: v for k, v in rank_out.items()
            if k.startswith(prefix)}


def _model():
    """The narrow VGG-F (its shapes; seeded init)."""
    from distributed_vgg_f_tpu_torch.models.vggf import VGGF
    return VGGF(CLASSES, compute_dtype=torch.float32, image_size=SIZE,
                dropout_rate=0.0, **WIDTHS)


def _equal(got, want, what):
    assert set(got) == set(want) and want, what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


# ------------------------------------------------------ the retopology gates
@pytest.fixture(scope="module")
def gates(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("z3_gates")
    arrays = _arrays(_batches(4))
    d = {k: str(tmp / k) for k in ("z3", "z2", "z1", "half", "full")}
    ema = dict(ema=0.9, bucket_mb=BUCKET_MB)
    four = [
        dict(name="z3", checkpoint=d["z3"], zero3=True, steps=2, every=2,
             reload=True, **ema),
        dict(name="z2", checkpoint=d["z2"], steps=2, every=2, **ema),
        dict(name="z1", checkpoint=d["z1"], zero1_only=True, steps=2,
             every=2),
        dict(name="full", checkpoint=d["full"], zero3=True, steps=4, every=4,
             **ema),
        dict(name="half", checkpoint=d["half"], zero3=True, steps=2,
             every=2, **ema),
        dict(name="resumed", checkpoint=d["half"], zero3=True, steps=4,
             every=2, first_batch=2, **ema),
        # (b) zero3 -> zero2, (c) zero2 -> zero3, (d) zero1-era -> zero3
        dict(name="b", checkpoint=d["z3"], steps=2, restore_only=True, **ema),
        dict(name="c", checkpoint=d["z2"], zero3=True, steps=2,
             restore_only=True, **ema),
        dict(name="d", checkpoint=d["z1"], zero3=True, steps=2,
             restore_only=True, bucket_mb=BUCKET_MB)]
    out = {"dirs": d, 4: run_group(4, dict(SPEC, cases=four), arrays,
                                   str(tmp / "four"))}
    two = [dict(name="z3_on2", checkpoint=d["z3"], zero3=True, steps=2,
                restore_only=True, **ema),
           dict(name="z2_on2", checkpoint=d["z3"], steps=2,
                restore_only=True, **ema)]
    out[2] = run_group(2, dict(SPEC, cases=two), arrays, str(tmp / "two"))
    cfg = checkpoint_config(SPEC, dict(two[0], checkpoint=d["z3"]))
    one = Trainer(cfg, device="cpu")
    out[1] = one.restore_or_init()
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def test_a_zero3_round_trip_and_resume(gates):
    for r, o in enumerate(gates[4]):
        assert bool(o["z3/shard_params"]) and bool(
            o["z3/reload/shard_params"])
        assert int(o["z3/reload/restored_step"]) == 2
        assert int(o["z3/reload/opt_count"]) == int(o["z3/opt_count"]) == 2
        for what in ("params", "ema"):
            _equal(_of(o, "z3/reload", what), _of(o, "z3", what), what)
        np.testing.assert_array_equal(o["z3/reload/shard"], o["z3/shard"])
        np.testing.assert_array_equal(o["z3/reload/momentum"],
                                      o["z3/momentum"])
        # a resumed run is the uninterrupted one, bit for bit
        np.testing.assert_array_equal(o["resumed/loss"], o["full/loss"][2:])
        for what in ("params", "ema"):
            _equal(_of(o, "resumed", what), _of(o, "full", what), what)
        np.testing.assert_array_equal(o["resumed/momentum"],
                                      o["full/momentum"])
    mgr = CheckpointManager(gates["dirs"]["z3"])
    meta, extra = mgr.state_metadata(2), mgr.extra_at(2)
    receipt = extra["param_layout"]
    assert receipt == {"kind": "bucketed_flat", "num_shards": 4,
                       "total_padded": extra["opt_layout"]["total_padded"]}
    assert meta["params"].shape == meta["ema_params"].shape == \
        meta["opt/trace"].shape == (receipt["total_padded"],)
    assert not any(k.startswith("params/") for k in meta)
    assert mgr.verify_step(2)


def test_b_zero3_checkpoint_restores_under_zero2(gates):
    for o in gates[4]:
        assert not bool(o["b/shard_params"])
        assert int(o["b/restored_step"]) == 2
        for what in ("params", "ema"):
            _equal(_of(o, "b", what), _of(o, "z3", what), what)
        np.testing.assert_array_equal(o["b/momentum"], o["z3/momentum"])


def test_c_zero2_checkpoint_restores_under_zero3(gates):
    for o in gates[4]:
        assert bool(o["c/shard_params"])
        for what in ("params", "ema"):
            _equal(_of(o, "c", what), _of(o, "z2", what), what)
        np.testing.assert_array_equal(o["c/momentum"], o["z2/momentum"])
        np.testing.assert_array_equal(o["c/shard"], o["z2/shard"])


def test_d_zero1_era_checkpoint_restores_into_bucketed_zero3(gates):
    model = _model()
    canon, bucketed = (zero_layout(model, 4, mb) for mb in (0.0, BUCKET_MB))
    mgr = CheckpointManager(gates["dirs"]["z1"])
    assert "param_layout" not in mgr.extra_at(2)
    assert "opt_layout" not in mgr.extra_at(2)
    assert mgr.state_metadata(2)["opt/trace"].shape == (canon.total_padded,)
    for o in gates[4]:
        assert bool(o["d/shard_params"])
        _equal(_of(o, "d", "params"), _of(o, "z1", "params"), "params")
        want = convert_opt_state(
            torch.from_numpy(o["z1/momentum"]), model, bucketed.total_padded,
            target_bucket_layout=bucketed)
        np.testing.assert_array_equal(o["d/momentum"], want.numpy())


def test_n_to_m_restores(gates):
    want = gates[4][0]
    for o in gates[2]:
        assert bool(o["z3_on2/shard_params"])
        assert not bool(o["z2_on2/shard_params"])
        for case in ("z3_on2", "z2_on2"):
            for what in ("params", "ema"):
                _equal(_of(o, case, what), _of(want, "z3", what),
                       f"{case} {what}")
            assert int(o[f"{case}/opt_count"]) == 2
    # one process: replicated SGD, the tree
    state = gates[1]
    assert state.param_shard is None and not state.shard_params
    _equal({k: v.detach().numpy() for k, v in state.model.named_parameters()},
           _of(want, "z3", "params"), "params")
    _equal({k: v.numpy() for k, v in state.ema_params.items()},
           _of(want, "z3", "ema"), "ema")
    # its per-leaf momentum in the 4-rank bucket-major frame
    lay = zero_layout(state.model, 4, BUCKET_MB)
    got = convert_opt_state(state.momentum(), state.model, lay.total_padded,
                            target_bucket_layout=lay)
    np.testing.assert_array_equal(got.numpy(), want["z3/momentum"])


# ------------------------------------------------------- the typed refusals
def _zero3_state():
    from _torch_dp_worker import make_config
    model = _model()
    return TrainState.create_sharded(
        model, lambda ps: build_optimizer(make_config(SPEC), ps)[0],
        zero_layout(model, 1, BUCKET_MB), ema=True, shard_params=True)


def _fake_manager(meta, extra):
    def restore(step):
        raise AssertionError("restore reached before the receipt check")
    return types.SimpleNamespace(
        best_step=lambda: 1, extra_at=lambda step: extra,
        state_metadata=lambda step: meta, restore=restore)


def test_wrong_param_receipts_refuse_before_anything_is_read():
    state = _zero3_state()
    padded = state.layout.total_padded
    flat = {"params": LeafMeta((padded,), np.float32),
            "opt/trace": LeafMeta((padded,), np.float32),
            "step": LeafMeta((), np.int32)}
    tree = {f"params/{k}": LeafMeta(tuple(s), np.float32)
            for k, s in zip(state.layout.names, state.layout.leaf_shapes)}
    before = (state.param_shard.clone(), state.ema_params.clone())
    opt = state.layout.describe()
    for meta, extra, match in (
            (flat, {"param_layout": {"kind": "canonical_flat",
                                     "num_shards": 1,
                                     "total_padded": padded + 8}},
             "total_padded"),
            (flat, {"param_layout": {"kind": "bucketed_flat",
                                     "num_shards": 1,
                                     "total_padded": padded}}, "bucket"),
            (tree, {"param_layout": {"kind": "canonical_flat",
                                     "num_shards": 1,
                                     "total_padded": padded},
                    "opt_layout": opt}, "tree"),
            (flat, {"param_layout": {"kind": "sharded_tree",
                                     "num_shards": 1,
                                     "total_padded": padded}}, "kind")):
        with pytest.raises(GeometryReceiptError, match=match):
            restore_any_topology(_fake_manager(meta, extra), state)
    assert torch.equal(state.param_shard, before[0])
    assert torch.equal(state.ema_params, before[1])
    assert state.step == 0 and state._gathered is None


# ------------------------------------------------ JAX's ZeRO-3 checkpoints
def _jax_cfg(ckpt_dir, steps, bucket_mb):
    return jcfg.ExperimentConfig(
        name="checkpoint_test",
        model=jcfg.ModelConfig(name="vggf", num_classes=CLASSES,
                               compute_dtype="float32", dropout_rate=0.0,
                               extra=dict(WIDTHS)),
        optim=jcfg.OptimConfig(base_lr=LR, reference_batch_size=BATCH,
                               momentum=0.9, weight_decay=WD),
        data=jcfg.DataConfig(name="synthetic", image_size=SIZE,
                             global_batch_size=BATCH,
                             num_train_examples=4 * BATCH),
        mesh=jcfg.MeshConfig(num_data=0, shard_opt_state=True,
                             shard_gradients=True, shard_params=True,
                             comm_bucket_mb=bucket_mb),
        train=jcfg.TrainConfig(steps=steps, seed=0, log_every=1,
                               checkpoint_dir=ckpt_dir,
                               checkpoint_every_steps=2),
        telemetry=jcfg.TelemetryConfig(enabled=False))


def _jax_fit(ckpt_dir, batches, jsonl, bucket_mb):
    mesh = build_mesh(MeshSpec(("data",), (2,)), devices=jax.devices()[:2])
    tr = JaxTrainer(_jax_cfg(ckpt_dir, len(batches), bucket_mb), mesh=mesh,
                    logger=MetricLogger(jsonl_path=jsonl,
                                        stream=io.StringIO()))
    state = tr.fit(dataset=iter(batches), num_steps=len(batches))
    with open(jsonl) as f:
        losses = [r["loss"] for r in map(json.loads, f)
                  if r["event"] == "train"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(
        tr.params_tree(state.params)))
    return (np.array(losses), params,
            np.asarray(jax.device_get(state.opt_state[0].trace)))


@pytest.fixture(scope="module", params=[BUCKET_MB, 0.0],
                ids=["bucketed", "canonical"])
def jax_resumed(request, tmp_path_factory):
    mb = request.param
    tmp = tmp_path_factory.mktemp("z3_jax")
    batches = _batches(4)
    _jax_fit(str(tmp / "jax_ckpt"), batches[:2], str(tmp / "half.jsonl"), mb)
    full = _jax_fit("", batches, str(tmp / "full.jsonl"), mb)
    port_dir = str(tmp / "port")
    assert convert(str(tmp / "jax_ckpt"), port_dir) == 2
    case = dict(name="resumed", checkpoint=port_dir, zero3=True, steps=4,
                first_batch=2, bucket_mb=mb, every=2)
    port = run_group(2, dict(SPEC, cases=[case]), _arrays(batches),
                     str(tmp / "group"))
    yield mb, full, port, port_dir
    shutil.rmtree(tmp, ignore_errors=True)


def test_jax_zero3_checkpoint_converts_with_its_receipts(jax_resumed):
    mb, _, _, port_dir = jax_resumed
    mgr = CheckpointManager(port_dir)
    meta, extra = mgr.state_metadata(2), mgr.extra_at(2)
    receipt = extra["param_layout"]
    assert receipt["kind"] == ("bucketed_flat" if mb else "canonical_flat")
    assert receipt["num_shards"] == 2
    assert meta["params"].shape == (receipt["total_padded"],)
    assert meta["opt/trace"].shape == meta["params"].shape
    assert ("opt_layout" in extra) == bool(mb)
    assert mgr.verify_step(2)


def test_port_resumes_jax_zero3_to_jax_losses(jax_resumed):
    _, (losses, params, trace), port, _ = jax_resumed
    np.testing.assert_allclose(port[0]["resumed/loss"], losses[2:],
                               rtol=2e-6)
    for o in port:
        assert int(o["resumed/restored_step"]) == 2
        assert bool(o["resumed/shard_params"])
        got = params_to_flax({k: torch.from_numpy(v) for k, v in
                              _of(o, "resumed", "params").items()})
        for layer in params:
            for leaf in ("kernel", "bias"):
                np.testing.assert_allclose(got[layer][leaf],
                                           params[layer][leaf], rtol=1e-5,
                                           atol=1e-6,
                                           err_msg=f"{layer}/{leaf}")
    got = port[0]["resumed/momentum"]
    assert got.shape == trace.shape
    np.testing.assert_allclose(got, trace, atol=1e-6, rtol=1e-5)


# --------------------------------------------------------- the command line
def test_cli_zero3_across_four_gloo_ranks_then_predict_and_serve(tmp_path):
    import queue
    import signal
    import subprocess
    import threading
    import urllib.request

    from _torch_cli_run import NARROW
    from distributed_vgg_f_tpu_torch import cli
    sets = ["--set", "mesh.shard_params=true",
            "--set", f"mesh.comm_bucket_mb={BUCKET_MB}"]
    out = cli_scenario(tmp_path, device="cpu", sets=sets)
    assert out["comm"]["sharding"] == "zero3"
    assert out["comm"]["gathers"] == out["comm"]["buckets"] > 1
    assert out["preempted_at"] - out["signal_after_step"] <= 3
    ck = str(tmp_path / "ck")
    mgr = CheckpointManager(ck)
    assert mgr.extra_at(40)["param_layout"]["kind"] == "bucketed_flat"
    argv = ["--config", "vggf_imagenet_dp",
            "--set", f"data.data_dir={tmp_path / 'data'}",
            "--set", f"train.checkpoint_dir={ck}", "--set", "train.seed=0",
            *sets, *NARROW]
    img = np.random.default_rng(3).integers(0, 256, (32, 32, 3), np.uint8)
    npy = str(tmp_path / "img.npy")
    np.save(npy, img)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv + ["--mode", "predict", "--images", npy],
                 device="cpu")
    predicted = [json.loads(x) for x in buf.getvalue().splitlines()
                 if x.startswith("{")]
    assert len(predicted) == 1 and len(predicted[0]["top_k"]) == 5
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_cli_run.py"),
         *argv, "--mode", "serve", "--set", "serving.enabled=true",
         "--set", "serving.max_batch=4"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        line = ""
        while not line.startswith("serving on "):
            try:
                line = lines.get(timeout=180)
            except queue.Empty:
                pytest.fail("no 'serving on' line: "
                            + (proc.stderr.read() if proc.poll() is not None
                               else "still starting"))
        req = urllib.request.Request(
            f"http://{line.split()[-1]}/v1/predict/vggf?k=5",
            data=img.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        want = predicted[0]["top_k"]
        assert [r["class"] for r in body["top_k"]] == [r["class"]
                                                       for r in want]
        np.testing.assert_allclose([r["prob"] for r in body["top_k"]],
                                   [r["prob"] for r in want], rtol=0,
                                   atol=1e-6)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=120) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

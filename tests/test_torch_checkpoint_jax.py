"""The checkpoint slice against the JAX package end to end: JAX's `Trainer`
runs ZeRO-2 over buckets on 2 of the 8 virtual CPU devices and fits 2
steps from explicit batches (narrow VGG-F: stem 8, convs 16, FC 32, 10
classes, 32 px, fp32, dropout and augment off) with checkpoints on;
tools/orbax_to_port.py converts its step 2; the port resumes it through
`Trainer.fit()` with no state in a 2-process gloo group
(tests/_torch_dp_worker.py) and in one process (replicated SGD, through
the layout migration) for 2 more steps on the same batches. Both are held
against JAX's own 4-step run at tests/test_torch_zero_jax.py's
tolerances: losses rtol 2e-6, params and the (T,) momentum atol 1e-6 +
rtol 1e-5 (the two frameworks' fp32 convolutions round differently)."""

import io
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_dp_worker import checkpoint_config, run_group
from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.train.trainer import Trainer as JaxTrainer
from distributed_vgg_f_tpu.utils.logging import MetricLogger
from distributed_vgg_f_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_vgg_f_tpu_torch.parallel.zero import (convert_opt_state,
                                                       zero_layout)
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.weights import params_to_flax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.orbax_to_port import convert  # noqa: E402

WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
SIZE, CLASSES, BATCH, LR, WD = 32, 10, 16, 0.05, 1e-4
BUCKET_MB = 0.0005
SPEC = {"widths": WIDTHS, "size": SIZE, "classes": CLASSES, "batch": BATCH,
        "lr": LR, "weight_decay": WD}


def _jax_cfg(ckpt_dir, steps):
    """checkpoint_config's fields, in the JAX package's config."""
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
                             shard_gradients=True, comm_bucket_mb=BUCKET_MB),
        train=jcfg.TrainConfig(steps=steps, seed=0, log_every=1,
                               checkpoint_dir=ckpt_dir,
                               checkpoint_every_steps=2))


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"image": rng.standard_normal(
                 (BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)}
            for _ in range(n)]


def _jax_fit(ckpt_dir, batches, jsonl):
    mesh = build_mesh(MeshSpec(("data",), (2,)), devices=jax.devices()[:2])
    tr = JaxTrainer(_jax_cfg(ckpt_dir, len(batches)), mesh=mesh,
                    logger=MetricLogger(jsonl_path=jsonl,
                                        stream=io.StringIO()))
    state = tr.fit(dataset=iter(batches), num_steps=len(batches))
    with open(jsonl) as f:
        losses = [r["loss"] for r in map(json.loads, f)
                  if r["event"] == "train"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    return (np.array(losses), params,
            np.asarray(jax.device_get(state.opt_state[0].trace)))


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_jax")
    batches = _batches(4)
    # JAX: 2 steps with checkpoints, then its own uninterrupted 4 steps
    _jax_fit(str(tmp / "jax_ckpt"), batches[:2], str(tmp / "half.jsonl"))
    full = _jax_fit("", batches, str(tmp / "full.jsonl"))
    converted = {}
    for name in ("two", "one"):
        converted[name] = str(tmp / f"port_{name}")
        assert convert(str(tmp / "jax_ckpt"), converted[name]) == 2
    arrays = {}
    for i, b in enumerate(batches):
        arrays[f"batch{i}/image"] = b["image"]
        arrays[f"batch{i}/label"] = b["label"]
    case = dict(name="resumed", checkpoint=converted["two"], steps=4,
                first_batch=2, bucket_mb=BUCKET_MB, every=2)
    port2 = run_group(2, dict(SPEC, cases=[case]), arrays,
                      str(tmp / "group"))
    cfg1 = checkpoint_config(SPEC, dict(case, checkpoint=converted["one"]))
    tr = Trainer(cfg1, device="cpu")
    state = tr.fit(None, [{"image": b["image"], "label": b["label"]}
                          for b in batches[2:]], num_steps=4)
    yield full, port2, (tr, state), converted
    shutil.rmtree(tmp, ignore_errors=True)


def _assert_params(got_state_dict, want):
    got = params_to_flax({k: torch.as_tensor(v)
                          for k, v in got_state_dict.items()})
    for layer in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{layer}/{leaf}")


def test_converted_step_holds_jax_arrays_and_receipt(slice_run):
    _, _, _, converted = slice_run
    mgr = CheckpointManager(converted["one"])
    meta = mgr.state_metadata(2)
    extra = mgr.extra_at(2)
    assert meta["params/conv1/kernel"].shape == (11, 11, 3, 8)
    assert meta["opt/trace"].shape == (extra["opt_layout"]["total_padded"],)
    assert meta["opt/count"].shape == () and meta["step"].shape == ()
    assert extra["opt_layout"]["num_shards"] == 2
    assert extra["examples_seen"] == 2 * BATCH
    assert mgr.verify_step(2)


def test_port_resumes_jax_zero2_on_two_ranks(slice_run):
    (losses, params, trace), port2, _, _ = slice_run
    for r, out in enumerate(port2):
        assert int(out["resumed/restored_step"]) == 2
        assert int(out["resumed/step"]) == int(out["resumed/opt_count"]) == 4
        _assert_params({k[len("resumed/params/"):]: v for k, v in out.items()
                        if k.startswith("resumed/params/")}, params)
    np.testing.assert_allclose(port2[0]["resumed/loss"], losses[2:],
                               rtol=2e-6)
    got = port2[0]["resumed/momentum"]
    assert got.shape == trace.shape
    np.testing.assert_allclose(got, trace, atol=1e-6, rtol=1e-5)
    assert np.abs(trace).max() > 0


def test_port_resumes_jax_zero2_on_one_process(slice_run):
    (losses, params, trace), _, (tr, state), _ = slice_run
    assert state.param_shard is None        # replicated SGD at one rank
    assert [r for r in tr.records if r["event"] == "restore"] == [
        {"event": "restore", "step": 2, "best": False}]
    assert state.step == state.opt_count == 4
    _assert_params(state.model.state_dict(), params)
    np.testing.assert_allclose(
        [r["loss"] for r in tr.records if r["event"] == "train"],
        losses[2:], rtol=2e-6)
    # the per-leaf momentum in JAX's 2-shard bucket-major frame
    lay = zero_layout(state.model, 2, BUCKET_MB)
    got = convert_opt_state(state.momentum(), state.model, lay.total_padded,
                            target_bucket_layout=lay)
    np.testing.assert_allclose(got.numpy(), trace, atol=1e-6, rtol=1e-5)

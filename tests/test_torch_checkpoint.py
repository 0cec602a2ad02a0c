"""The port's checkpoint manager (distributed_vgg_f_tpu_torch/checkpoint/
manager.py) and the trainer's checkpoint and resume, on the CPU at a small
size: the cases of the JAX package's tests/test_checkpoint.py,
tests/test_best_checkpoint.py and tests/test_resilience.py:258–392 (a
bit-exact round trip, interval and retention, collision replacement,
write retries, the newest-intact fallback, every step corrupt, an
explicit corrupt step, a step without a manifest, orphaned manifests),
each step's manifest written by the writer thread before any wait(), a
save not torn by an in-place step right after it, and `Trainer.fit()` resuming 2 + 2 steps bit-equal to 4
straight (fp32 on the CPU repeats its arithmetic exactly) through the
trainer-owned feed over TFRecords (the iterator blob, no batch replayed)
and through a caller's dataset. Models are narrow VGG-F (stem 8, convs 16,
FC 32, 10 classes, 32 px); a step is under 1 MB."""

import dataclasses
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.checkpoint import manager as manager_mod
from distributed_vgg_f_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_vgg_f_tpu_torch.checkpoint.retopology import \
    migrate_momentum
from distributed_vgg_f_tpu_torch.config import (ModelConfig, TrainConfig,
                                                get_config)
from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
from distributed_vgg_f_tpu_torch.resilience.errors import (
    CheckpointIntegrityError, GeometryReceiptError)
from distributed_vgg_f_tpu_torch.resilience.integrity import (
    list_manifest_steps, manifest_path, step_dir)
from distributed_vgg_f_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.tfrecord_write import write_shards  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
CLASSES, SIZE, BATCH = 10, 32, 4


def _cfg(ckpt_dir="", data_dir="", **train):
    """The flagship preset cut to narrow VGG-F in fp32, 32 px, batch 4;
    flip and mixup stay on."""
    cfg = get_config("vggf_imagenet_dp")
    return dataclasses.replace(
        cfg,
        model=ModelConfig(num_classes=CLASSES, compute_dtype="float32",
                          extra=WIDTHS),
        data=dataclasses.replace(cfg.data, data_dir=data_dir,
                                 image_size=SIZE, global_batch_size=BATCH,
                                 num_train_examples=14, native_threads=2),
        train=dataclasses.replace(cfg.train, log_every=1, seed=3,
                                  checkpoint_dir=ckpt_dir,
                                  checkpoint_every_steps=2, **train))


def _tree(step, value=0.0):
    """A small raw checkpoint tree: exact bit patterns included."""
    special = np.array([-0.0, 1e-45, -1e-40, 3.4e38, np.nan, np.inf],
                       np.float32)
    return {"step": np.asarray(step, np.int32),
            "params/a/kernel": np.arange(12, dtype=np.float32).reshape(3, 4)
            + value,
            "opt/trace": np.concatenate([special, [value]]).astype(
                np.float32),
            "opt/count": np.asarray(step, np.int32)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


def _damage(root, step):
    """Flip one byte of the step's largest file."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(step_dir(root, step))
             for f in fs]
    path = max(files, key=os.path.getsize)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x10]))
    return path


@pytest.fixture(autouse=True)
def _remove_what_the_test_wrote(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# ------------------------------------------------------------- the manager
def test_state_round_trip_is_bit_exact(tmp_path):
    tr = Trainer(_cfg(ema_decay=0.9), device="cpu")
    state = tr.fit(tr.init_state(), SyntheticU8(BATCH, SIZE, CLASSES),
                   num_steps=2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state, extra={"examples_seen": 8}, force=True)
    mgr.wait()
    arrays, extra = mgr.restore()
    assert extra == {"examples_seen": 8}
    _assert_tree(arrays, {k: v.numpy()
                          for k, v in state.checkpoint_tree().items()})
    assert arrays["params/conv1/kernel"].shape == (11, 11, 3, 8)   # HWIO
    assert arrays["params/fc6/kernel"].shape[1] == 32             # (in, out)
    fresh = tr.init_state(seed=7)
    fresh.load_checkpoint_tree(arrays, migrate_momentum(fresh, arrays,
                                                        extra, 2))
    assert (fresh.step, fresh.opt_count) == (2, 2)
    for (k, a), b in zip(state.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(a, b), k
    for k, v in state.momentum().items():
        assert torch.equal(v, fresh.momentum()[k]), k
    for k, v in state.ema_params.items():
        assert torch.equal(v, fresh.ema_params[k]), k
    raw = CheckpointManager(str(tmp_path / "raw"))
    assert raw.save(_tree(5), force=True)
    _assert_tree(raw.restore(5)[0], _tree(5))
    assert raw.state_metadata(5)["params/a/kernel"] == ((3, 4),
                                                       np.dtype("float32"))


def test_interval_and_retention(tmp_path):
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, max_to_keep=2, save_interval_steps=2)
    taken = [s for s in range(1, 8) if mgr.save(_tree(s))]
    assert taken == [1, 2, 4, 6]       # the first save, then the interval
    mgr.wait()
    assert mgr.all_steps() == [4, 6] == sorted(
        int(n) for n in os.listdir(root) if n.isdigit())
    assert set(list_manifest_steps(root)) <= {4, 6}
    assert not mgr.save(_tree(6))      # not past the latest
    assert not mgr.save(_tree(6), force=True)   # a collision, not replaced
    reopened = CheckpointManager(root, max_to_keep=2, save_interval_steps=2)
    assert reopened.all_steps() == [4, 6] and reopened.latest_step() == 6
    _assert_tree(reopened.restore()[0], _tree(6))


def test_collision_replacement(tmp_path):
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, save_interval_steps=2)
    for s in (2, 4):
        assert mgr.save(_tree(s), force=True)
    mgr.wait()
    # a branched run in a fresh process re-reaches step 4 with new state
    branch = CheckpointManager(root, save_interval_steps=2)
    assert branch.save(_tree(4, value=1.0), replace_on_collision=True)
    _assert_tree(branch.restore(4)[0], _tree(4, value=1.0))
    assert not branch.save(_tree(3, value=1.0), replace_on_collision=True)
    # a forced re-save of a step this manager saved is a no-op
    newest = max(os.stat(os.path.join(d, f)).st_mtime_ns
                 for d, _, fs in os.walk(root) for f in fs)
    assert branch.save(_tree(4, value=2.0), force=True,
                       replace_on_collision=True)
    branch.wait()
    assert newest == max(os.stat(os.path.join(d, f)).st_mtime_ns
                         for d, _, fs in os.walk(root) for f in fs)
    _assert_tree(branch.restore(4)[0], _tree(4, value=1.0))


def test_write_retries_an_injected_oserror(tmp_path, monkeypatch):
    telemetry.reset()
    write = manager_mod.CheckpointManager._write_step
    fails = {"n": 2}

    def flaky(self, *args):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient I/O blip")
        return write(self, *args)

    monkeypatch.setattr(manager_mod.CheckpointManager, "_write_step", flaky)
    assert manager_mod.SAVE_RETRIES == 2
    mgr = CheckpointManager(str(tmp_path / "flaky"))
    assert mgr.save(_tree(0), force=True)
    mgr.wait()
    assert mgr.latest_step() == 0 and mgr.verify_step(0)
    reg = telemetry.get_registry()
    assert reg.counter_value("checkpoint/save_retries") == 2
    assert reg.counter_value("checkpoint/save_failures") == 0
    assert not [n for n in os.listdir(tmp_path / "flaky") if ".tmp-" in n]

    monkeypatch.setattr(
        manager_mod.CheckpointManager, "_write_step",
        lambda self, *a: (_ for _ in ()).throw(OSError("disk is gone")))
    dead = CheckpointManager(str(tmp_path / "dead"))
    assert dead.save(_tree(0), force=True)
    with pytest.raises(OSError, match="disk is gone"):
        dead.wait()
    assert dead.all_steps() == []
    assert reg.counter_value("checkpoint/save_retries") == 4
    assert reg.counter_value("checkpoint/save_failures") == 1


def test_newest_intact_fallback_and_refusals(tmp_path):
    telemetry.reset()
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root)
    for s in (2, 4):
        mgr.save(_tree(s), force=True)
    mgr.wait()
    assert mgr.verify_step(4)
    _damage(root, 4)
    fresh = CheckpointManager(root)
    arrays, _ = fresh.restore()
    _assert_tree(arrays, _tree(2))
    fb = fresh.last_integrity_fallback
    assert fb["chosen"] == 2 and [s for s, _ in fb["skipped"]] == [4]
    assert fb["skipped"][0][1].startswith("checksum mismatch")
    assert telemetry.get_registry().counter_value(
        "checkpoint/integrity_fallbacks") == 1
    with pytest.raises(CheckpointIntegrityError, match="step 4"):
        fresh.restore(4)            # asked for exactly that state
    _damage(root, 2)
    with pytest.raises(CheckpointIntegrityError, match="every checkpoint"):
        CheckpointManager(root).restore()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_step_without_manifest_restores(tmp_path):
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root)
    mgr.save(_tree(4), force=True)
    mgr.wait()
    shutil.rmtree(os.path.join(root, "integrity"))
    fresh = CheckpointManager(root)
    assert fresh.verify_step(4)
    _assert_tree(fresh.restore()[0], _tree(4))


def test_orphaned_manifests_are_pruned(tmp_path):
    root = str(tmp_path / "gc")
    mgr = CheckpointManager(root, max_to_keep=2)
    for s in range(4):
        assert mgr.save(_tree(s), force=True)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert set(list_manifest_steps(root)) <= {2, 3}
    # a stale manifest for retired step 0, as if the process died between
    # the retention and the prune: a re-save of 0 must verify clean
    shutil.copyfile(manifest_path(root, 3), manifest_path(root, 0))
    mgr2 = CheckpointManager(root, max_to_keep=2)
    assert mgr2.save(_tree(0, 5.0), force=True)
    mgr2.wait()
    assert mgr2.all_steps() == [0, 3] and mgr2.verify_step(0)
    _assert_tree(mgr2.restore(0)[0], _tree(0, 5.0))


def _await_manifest(root, step, timeout_s=60.0):
    """Poll for a step's manifest, never calling the manager."""
    deadline = time.monotonic() + timeout_s
    while step not in list_manifest_steps(root):
        assert time.monotonic() < deadline, f"no manifest of step {step}"
        time.sleep(0.01)


def test_the_writer_manifests_each_step_before_wait(tmp_path):
    """No save waits for a later flush: the writer thread writes a step's
    manifest right after its commit, whatever its size, so a run that
    crashes before any wait() still has its retained steps verified."""
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, max_to_keep=2)
    for s in (1, 2, 3):
        assert mgr.save(_tree(s), force=True)
        _await_manifest(root, s)
    assert mgr.timings["write_s"] > 0 and mgr.timings["manifest_s"] > 0
    deadline = time.monotonic() + 60.0   # step 1's retired after 3's commit
    while list_manifest_steps(root) != [2, 3]:
        assert time.monotonic() < deadline, list_manifest_steps(root)
        time.sleep(0.01)
    _damage(root, 3)                     # a crash now: no wait() was called
    fresh = CheckpointManager(root)
    assert fresh.best_step() == 2
    assert fresh.last_integrity_fallback["skipped"][0][0] == 3
    mgr.close()


def test_a_stale_manifest_never_judges_a_new_write(tmp_path, monkeypatch):
    """A re-save at an index whose old manifest survived: the manifest is
    removed before the new files are committed, and the new one matches
    them."""
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root)
    assert mgr.save(_tree(4), force=True)
    mgr.wait()
    with open(manifest_path(root, 4)) as f:
        stale = f.read()
    seen = []
    replace = os.replace

    def watched(src, dst):
        if dst == step_dir(root, 4):
            seen.append(os.path.exists(manifest_path(root, 4)))
        return replace(src, dst)

    monkeypatch.setattr(manager_mod.os, "replace", watched)
    shutil.rmtree(step_dir(root, 4))     # the step gone, its manifest kept
    again = CheckpointManager(root)
    assert again.save(_tree(4, 2.0), force=True)
    again.wait()
    assert seen == [False]
    with open(manifest_path(root, 4)) as f:
        assert f.read() != stale
    assert again.verify_step(4)
    _assert_tree(again.restore(4)[0], _tree(4, 2.0))


def test_save_is_not_torn_by_an_in_place_step(tmp_path):
    tr = Trainer(_cfg(), device="cpu")
    state = tr.fit(tr.init_state(), SyntheticU8(BATCH, SIZE, CLASSES),
                   num_steps=1)
    want = {k: v.clone() for k, v in state.checkpoint_tree().items()}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state, force=True)
    with torch.no_grad():           # the next step's in-place update
        for p in state.model.parameters():
            p.add_(1.0)
        for buf in state.momentum().values():
            buf.mul_(-3.0)
    mgr.wait()
    _assert_tree(mgr.restore()[0], {k: v.numpy() for k, v in want.items()})


def test_back_to_back_saves_under_thread_switching_stay_whole(tmp_path):
    """30 saves of a tensor stepped in place right after each, the writer
    thread racing the next dispatch at a 1 µs switch interval: every step
    on disk holds exactly the values at its save."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=None)
        live = torch.arange(4096, dtype=torch.float32)
        for s in range(1, 31):
            assert mgr.save({"step": torch.tensor(s, dtype=torch.int32),
                             "params/a/kernel": live})
            live.add_(1.0)
        mgr.wait()
    finally:
        sys.setswitchinterval(old)
    for s in range(1, 31):
        got = mgr.restore(s)[0]["params/a/kernel"]
        np.testing.assert_array_equal(got, np.arange(4096) + (s - 1))
    mgr.close()


# ------------------------------------------------------------- the trainer
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_tfrecords")
    jpegs = []
    for f in sorted(os.listdir(FIXTURE))[:6]:
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            jpegs.append(fh.read())
    write_shards(str(root), jpegs, [1 + k for k in range(6)],
                 shards=2, per_shard=7)
    yield str(root)
    shutil.rmtree(root, ignore_errors=True)


def _spy(trainer):
    seen = []
    step = trainer.train_step

    def spy(state, batch, seed):
        seen.append({k: torch.as_tensor(v).clone() for k, v in batch.items()})
        return step(state, batch, seed)

    trainer.train_step = spy
    return seen


def _assert_same_state(a, b):
    assert (a.step, a.opt_count) == (b.step, b.opt_count)
    for (k, x), y in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(x, y), k
    for k, v in a.momentum().items():
        assert torch.equal(v, b.momentum()[k]), k


def _losses(trainer):
    return [r["loss"] for r in trainer.records if r["event"] == "train"]


def test_fit_resumes_through_the_blob_bit_equal(data_dir, tmp_path):
    """4 steps straight against 2, then a new Trainer's fit() for 2 more,
    on the trainer-owned feed over TFRecords."""
    straight = Trainer(_cfg(data_dir=data_dir), device="cpu")
    seen_straight = _spy(straight)
    want = straight.fit(num_steps=4)

    cfg = _cfg(str(tmp_path / "ck"), data_dir)
    first = Trainer(cfg, device="cpu")
    seen = _spy(first)
    first.fit(num_steps=2)
    assert first.checkpoints.all_steps() == [1, 2]
    blob = first.checkpoints.iterator_state_at(2)
    assert blob["cursor"] == 2 and blob["kind"] == "ingest_iterator_state"
    assert first.checkpoints.extra_at(2)["examples_seen"] == 2 * BATCH
    assert telemetry.get_registry().counter_value("ingest_state/saves") >= 2

    second = Trainer(cfg, device="cpu")
    seen += _spy(second)
    got = second.fit(num_steps=4)
    events = [r for r in second.records if r["event"] != "train"]
    assert events[0] == {"event": "restore", "step": 2, "best": False}
    assert events[1]["event"] == "iterator_state_restore"
    assert events[1]["replayed_batches"] == 0
    assert events[1]["cursor"] == 2
    assert events[2] == {"event": "data_iterator_restore", "step": 2,
                         "restored": True}
    assert "data_fast_forward" not in [e["event"] for e in events]
    for a, b in zip(seen, seen_straight):
        assert torch.equal(a["image"], b["image"])
    _assert_same_state(got, want)
    assert _losses(first) + _losses(second) == _losses(straight)
    assert second.checkpoints.all_steps() == [1, 2, 4]


def test_fit_resumes_a_caller_dataset_bit_equal(tmp_path):
    batches = [SyntheticU8(BATCH, SIZE, CLASSES, seed=s).batch
               for s in range(4)]
    straight = Trainer(_cfg(), device="cpu")
    want = straight.fit(straight.init_state(), batches, num_steps=4)
    cfg = _cfg(str(tmp_path / "ck"))
    Trainer(cfg, device="cpu").fit(None, batches[:2], num_steps=2)
    second = Trainer(cfg, device="cpu")
    got = second.fit(None, batches[2:], num_steps=4)
    _assert_same_state(got, want)
    assert second.checkpoints.extra_at(4).get("iterator_state") is None


def test_trainer_falls_back_then_refuses(tmp_path):
    cfg = _cfg(str(tmp_path / "ck"))
    tr = Trainer(cfg, device="cpu")
    tr.fit(None, SyntheticU8(BATCH, SIZE, CLASSES), num_steps=4)
    assert tr.checkpoints.all_steps() == [1, 2, 4]
    _damage(str(tmp_path / "ck"), 4)
    again = Trainer(cfg, device="cpu")
    assert again.restore_or_init().step == 2
    fallback = [r for r in again.records
                if r["event"] == "checkpoint_integrity_fallback"]
    assert fallback and fallback[0]["chosen"] == 2
    for step in (1, 2):
        _damage(str(tmp_path / "ck"), step)
    with pytest.raises(CheckpointIntegrityError, match="none passed"):
        Trainer(cfg, device="cpu").restore_or_init()


def test_ema_is_seeded_or_dropped_across_a_restore(tmp_path):
    cfg = _cfg(str(tmp_path / "ck"))
    tr = Trainer(cfg, device="cpu")
    state = tr.fit(None, SyntheticU8(BATCH, SIZE, CLASSES), num_steps=2)
    ema_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.9))
    seeded = Trainer(ema_cfg, device="cpu")
    restored = seeded.restore_or_init()
    assert {"event": "ema_seeded_from_params", "step": 2} in seeded.records
    for k, p in state.model.named_parameters():
        assert torch.equal(restored.ema_params[k], p)
    seeded.fit(restored, SyntheticU8(BATCH, SIZE, CLASSES), num_steps=3)
    dropped = Trainer(cfg, device="cpu")
    assert dropped.restore_or_init().ema_params is None
    assert {"event": "ema_dropped_on_restore", "step": 3} in dropped.records


def test_a_receipt_that_does_not_fit_raises(tmp_path):
    tr = Trainer(_cfg(), device="cpu")
    state = tr.init_state()
    arrays = {k: v.numpy() for k, v in state.checkpoint_tree().items()}
    total = sum(p.numel() for p in state.model.parameters())
    arrays["opt/trace"] = np.zeros(total + 2, np.float32)
    for k in [k for k in arrays if k.startswith("opt/trace/")]:
        del arrays[k]
    receipt = {"kind": "bucketed_flat", "num_shards": 2,
               "bucket_bytes": 524, "num_buckets": 3,
               "total_padded": total + 2, "bucket_elems": [1, 2, 3]}
    with pytest.raises(GeometryReceiptError, match="does not describe"):
        migrate_momentum(state, arrays, {"opt_layout": receipt}, 0)
    with pytest.raises(GeometryReceiptError, match="tree, not a flat"):
        migrate_momentum(state, {k: v.numpy() for k, v in
                                 state.checkpoint_tree().items()},
                         {"opt_layout": receipt}, 0)
    arrays["params/conv1/kernel"] = np.zeros((3, 3, 3, 8), np.float32)
    with pytest.raises(GeometryReceiptError, match="conv1/kernel"):
        state.load_checkpoint_tree(arrays, state.momentum())


def test_checkpoint_fields_validate():
    assert TrainConfig().checkpoint_dir == ""
    assert (TrainConfig().checkpoint_every_steps,
            TrainConfig().keep_checkpoints) == (1000, 3)
    # the retry count is the manager's constant, not a field the port
    # would accept and ignore
    with pytest.raises(TypeError, match="checkpoint_save_retries"):
        TrainConfig(checkpoint_save_retries=2)

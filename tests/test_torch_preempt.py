"""Preemption in the port: parallel/preempt.py `PreemptConsensus` in 2-
and 4-process gloo groups (tests/_torch_dp_worker.py), and the trainer's
SIGTERM stop on one process.

- The consensus: a flag raised on one rank from poll k stops every rank
  at poll k + 2 (LAG = 2), the same poll on every rank; no flag, no stop.
- One process: a SIGTERM during step k stops the run after step k with a
  forced, committed save and a `preempt` record; a fresh Trainer resumes
  it, and the resumed run equals the uninterrupted one bit for bit on
  the CPU (the flagship narrowed with dropout, flip and mixup on, fed by
  the trainer-owned native feed over TFRecords of the JPEG fixture). The
  handler is restored after `fit`; off the main thread, and with
  `train.handle_preemption` false, none is installed."""

import hashlib
import os
import signal
import sys
import threading

import pytest

from _torch_dp_worker import run_group
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_vgg_f_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.tfrecord_write import write_shards  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")


@pytest.mark.parametrize("world", [2, 4])
def test_consensus_stops_every_rank_two_polls_after_the_flag(world,
                                                             tmp_path):
    cases = [dict(name="none", consensus=True, polls=8, flag_rank=-1,
                  flag_step=0),
             dict(name="first", consensus=True, polls=8, flag_rank=0,
                  flag_step=0),
             dict(name="last", consensus=True, polls=12,
                  flag_rank=world - 1, flag_step=5)]
    out = run_group(world, {"cases": cases}, {}, str(tmp_path))
    for r in range(world):
        assert int(out[r]["none/stop"]) == -1, r
        assert int(out[r]["first/stop"]) == 2, r
        assert int(out[r]["last/stop"]) == 7, r


# ------------------------------------------------------- one process
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("preempt_tfrecords"))
    jpegs = [open(os.path.join(FIXTURE, f), "rb").read()
             for f in sorted(os.listdir(FIXTURE))]
    write_shards(root, jpegs, [1 + k % 10 for k in range(len(jpegs))],
                 shards=2, per_shard=12)
    return root


def _cfg(data_dir, ckpt="", **train):
    """The flagship narrowed (dropout, flip and mixup on)."""
    return tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"), {
        "model.num_classes": "10", "model.compute_dtype": "float32",
        "model.extra.stem_features": "8", "model.extra.conv_features": "16",
        "model.extra.fc_features": "32", "data.image_size": "32",
        "data.global_batch_size": "8", "data.num_train_examples": "24",
        "data.native_threads": "2", "data.data_dir": data_dir,
        "optim.reference_batch_size": "8", "train.steps": "8",
        "train.log_every": "1", "train.checkpoint_dir": ckpt,
        "train.checkpoint_every_steps": "1000",
        **{f"train.{k}": str(v) for k, v in train.items()}})


def _sigterm_after(trainer, k, seen=None):
    inner = trainer.train_step

    def step(state, batch, seed):
        state, metrics = inner(state, batch, seed)
        if seen is not None:
            seen.append(signal.getsignal(signal.SIGTERM))
        if state.step == k:
            os.kill(os.getpid(), signal.SIGTERM)
        return state, metrics

    step.comm_meta = inner.comm_meta
    trainer.train_step = step
    return trainer


def _digest(state):
    h = hashlib.sha256()
    for t in list(state.model.state_dict().values()) + list(
            state.momentum().values()):
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def test_sigterm_stops_after_the_step_saves_and_resumes_bit_equal(
        data_dir, tmp_path):
    ck = str(tmp_path / "ck")
    before = signal.getsignal(signal.SIGTERM)
    first = _sigterm_after(Trainer(_cfg(data_dir, ck), device="cpu"), 3)
    state = first.fit()
    assert signal.getsignal(signal.SIGTERM) is before
    assert first.preempted_at == 3 and state.step == 3
    assert first.records[-1] == {"event": "preempt", "step": 3,
                                 "checkpointed": True}
    mgr = CheckpointManager(ck)
    assert mgr.latest_step() == 3 and mgr.verify_step(3)
    assert "iterator_state" in mgr.extra_at(3)

    resumed = Trainer(_cfg(data_dir, ck), device="cpu")
    state = resumed.fit()
    assert state.step == 8 and resumed.preempted_at is None
    assert any(r["event"] == "iterator_state_restore"
               and r["replayed_batches"] == 0 for r in resumed.records)
    straight = Trainer(_cfg(data_dir), device="cpu")
    want = straight.fit()
    assert _digest(state) == _digest(want)
    losses = [r["loss"] for r in first.records + resumed.records
              if r["event"] == "train"]
    assert losses == [r["loss"] for r in straight.records
                      if r["event"] == "train"]


def test_no_handler_when_preemption_is_off_or_off_the_main_thread(
        data_dir):
    before = signal.getsignal(signal.SIGTERM)
    seen = []
    off = Trainer(_cfg(data_dir, handle_preemption="false"), device="cpu")
    inner = off.train_step

    def step(state, batch, seed):
        seen.append(signal.getsignal(signal.SIGTERM))
        return inner(state, batch, seed)

    step.comm_meta = inner.comm_meta
    off.train_step = step
    off.fit(off.init_state(), num_steps=2)
    assert seen == [before, before]

    seen.clear()
    errors = []
    threaded = Trainer(_cfg(data_dir), device="cpu")
    inner2 = threaded.train_step

    def step2(state, batch, seed):
        seen.append(signal.getsignal(signal.SIGTERM))
        return inner2(state, batch, seed)

    step2.comm_meta = inner2.comm_meta
    threaded.train_step = step2

    def run():
        try:
            threaded.fit(threaded.init_state(), num_steps=2)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and errors == []
    assert seen == [before, before]

"""The ingest autotuner wired into the port's `Trainer.fit`
(distributed_vgg_f_tpu_torch/train/trainer.py), on the CPU with the
flagship preset narrowed as in tests/test_torch_trainer_jax.py (stem 8,
convs 16, FC 32, 32 px, fp32, global batch 8, dropout, flip and mixup
off), a record every step:

- a trainer-owned feed slowed by a sleep it cannot read ahead of names
  every window `infeed_bound` and moves the first knob only at window
  `k_windows`, then one step each `k_windows` windows, as the controller's
  rules allow (hysteresis restarts after a move, the cooldown is
  shorter), and the same rules replayed over the recorded verdicts make
  the same records;
- the seeded feed (`data.name="synthetic"`) names every window
  `compute_bound` and moves nothing;
- with the autotuner disabled (`data.autotune.enabled=false`) or killed
  (DVGGF_AUTOTUNE=0) the feed has no host stage, no record has an
  `autotune` block, no `autotune/*` counter moves, and the losses are bit
  for bit those of the armed run and of the same batches fed as a
  caller's dataset (no stage between the decoder and the step: the
  trainer's path before it had the autotuner);
- the `autotune_armed` receipt binds the knobs JAX's trainer binds on
  the same config and TFRecords, with the same rails and values, except
  the wire knob, which the port names unbound;
- a run whose host depth and device ring have grown, preempted by a
  checkpoint at step 6 and resumed by a fresh trainer, is bit-equal to
  the uninterrupted run: the blob's cursor, not the read-ahead, sets the
  resumed stream. The controller is fed `infeed_bound` for every window
  there (`_recorded_verdicts`), so the growth does not hang on the host's
  load: a step slower than three times the feed's sleep used to read
  `compute_bound` on a loaded host and leave the device ring where it
  was."""

import io
import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.train.trainer import Trainer as JaxTrainer
from distributed_vgg_f_tpu.utils.logging import MetricLogger as JaxLogger
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.data import autotune
from distributed_vgg_f_tpu_torch.telemetry import get_registry, schema
from distributed_vgg_f_tpu_torch.train.trainer import (WIRE_KNOB_UNBOUND,
                                                       Trainer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.tfrecord_write import write_shards  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
BATCH = 8

NARROW = {"model.num_classes": "10", "model.compute_dtype": "float32",
          "model.dropout_rate": "0.0",
          "model.extra.stem_features": "8", "model.extra.conv_features": "16",
          "model.extra.fc_features": "32",
          "data.image_size": "32", "data.global_batch_size": str(BATCH),
          "data.num_train_examples": "48", "data.native_threads": "2",
          "data.augment.enabled": "false",
          "optim.reference_batch_size": str(BATCH),
          "train.seed": "0", "train.log_every": "1"}

AUTOTUNE_COUNTERS = ("autotune/windows", "autotune/actuations",
                     "autotune/blocked_hysteresis",
                     "autotune/blocked_cooldown", "autotune/blocked_rail",
                     "autotune/oscillation_freezes")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("autotune_tfrecords"))
    jpegs = []
    for f in sorted(os.listdir(FIXTURE)):
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            jpegs.append(fh.read())
    write_shards(root, jpegs, [1 + k % 10 for k in range(16)], shards=4,
                 per_shard=12)
    return root


def _cfg(**extra):
    return tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"),
                                {**NARROW, **extra})


class Slow:
    """The source in lockstep with the trainer: batch n is drawn only
    after the steps of batches 0..n-1 have run (or the feed is closing),
    then after a sleep, so no read-ahead can hide the sleep and every
    step waits for it, however long the step takes on a loaded host."""

    def __init__(self, inner, delay_s, taken):
        self.inner, self.delay_s, self.taken = inner, delay_s, taken
        self.drawn = 0

    def __iter__(self):
        return self

    def __getattr__(self, name):
        # the seek, the pool and the counters, never `next_into` (which
        # would skip the sleep)
        if name in ("supports_state", "restore_state", "num_threads",
                    "set_num_threads", "decode_errors", "close"):
            return getattr(self.inner, name)
        raise AttributeError(name)

    def __next__(self):
        with self.taken["cond"]:
            self.taken["cond"].wait_for(
                lambda: self.taken["n"] >= self.drawn or self.taken["done"],
                timeout=60.0)
        time.sleep(self.delay_s)
        self.drawn += 1
        return next(self.inner)


def _slowed(trainer, delay_s):
    taken = {"n": 0, "done": False, "cond": threading.Condition()}
    make, step = trainer.make_dataset, trainer.train_step
    close_feed = trainer._close_feed

    def closing(feed):
        # the read-ahead workers may wait at the gate: open it for good
        with taken["cond"]:
            taken["done"] = True
            taken["cond"].notify_all()
        close_feed(feed)

    def counted(state, batch, seed):
        out = step(state, batch, seed)
        with taken["cond"]:
            taken["n"] += 1
            taken["cond"].notify_all()
        return out

    trainer.make_dataset = lambda split="train", data_cfg=None: Slow(
        make(split, data_cfg), delay_s, taken)
    trainer.train_step = counted
    trainer._close_feed = closing
    counted.comm_meta = getattr(step, "comm_meta", None)
    return trainer


def _train(trainer):
    return [r for r in trainer.records if r["event"] == "train"]


def _valid(trainer):
    for r in trainer.records:
        assert schema.validate_metrics_record(r) == [], r


class Target:
    def __init__(self, value):
        self.value = value

    def apply(self, n):
        self.value = n
        return n


def _replayed(armed, stalls):
    """The armed controller's rules over the recorded verdicts: a fresh
    IngestAutotuner with knobs that start where the trainer's did."""
    knobs = []
    for k in armed["knobs"]:
        t = Target(k["value"])
        knobs.append(autotune.Knob(k["name"], lambda t=t: t.value, t.apply,
                                   k["min"], k["max"],
                                   geometric=k["name"] == "native_threads"))
    tuner = autotune.IngestAutotuner(knobs, clock=lambda: 0.0)
    assert tuner.describe()["config"] == armed["config"]
    return [tuner.observe(s) for s in stalls]


def _untimed(record):
    return {**record, "actuations": [
        {k: v for k, v in a.items() if k != "ts_unix"}
        for a in record.get("actuations", [])]}


def test_a_slowed_feed_is_infeed_bound_and_actuates_after_k_windows():
    cfg = _cfg(**{"data.name": "synthetic"})
    assert (autotune.K_WINDOWS, autotune.COOLDOWN_WINDOWS) == (3, 2)
    tr = _slowed(Trainer(cfg, device="cpu"), 1.0)
    tr.fit(tr.init_state(), num_steps=7)
    armed = [r for r in tr.records if r["event"] == "autotune_armed"]
    assert len(armed) == 1
    # the seeded source has no decode pool: no thread knob
    assert [k["name"] for k in armed[0]["knobs"]] == [
        "host_prefetch", "prefetch_to_device"]
    assert armed[0]["unbound"] == {"wire_u8": WIRE_KNOB_UNBOUND}
    recs = _train(tr)
    for r in recs:
        assert r["stall"]["verdict"] == "infeed_bound", r["stall"]
        assert r["stall"]["infeed_fraction"] >= 0.25
    # every move is one the controller's rules make of these verdicts
    got = [_untimed(r["autotune"]) for r in recs]
    assert got == [_untimed(r) for r in _replayed(
        armed[0], [r["stall"] for r in recs])]
    moves = [(a["window"], a["knob"], a["from"], a["to"])
             for r in got for a in r["actuations"]]
    assert moves == [(3, "host_prefetch", 2, 3), (6, "host_prefetch", 3, 4)]
    assert [r.get("blocked") for r in got] == [
        "hysteresis", "hysteresis", None] * 2 + ["hysteresis"]
    assert tr.host_prefetch.depth == 4
    _valid(tr)


def test_the_seeded_feed_is_compute_bound_and_moves_nothing():
    tr = Trainer(_cfg(**{"data.name": "synthetic"}), device="cpu")
    tr.fit(tr.init_state(), num_steps=6)
    recs = _train(tr)
    assert [r["stall"]["verdict"] for r in recs] == ["compute_bound"] * 6
    assert all("actuations" not in r["autotune"] for r in recs)
    assert tr.autotuner.actuations_total == 0
    _valid(tr)


def _counters():
    reg = get_registry()
    return [reg.counter_value(n) for n in AUTOTUNE_COUNTERS]


def test_disabled_or_killed_autotuner_is_the_plain_feed(data_dir,
                                                        monkeypatch):
    losses = {}
    base = _cfg(**{"data.data_dir": data_dir})
    for name in ("armed", "disabled", "killed"):
        cfg = (tcfg.apply_overrides(base, {"data.autotune.enabled": "false"})
               if name == "disabled" else base)
        if name == "killed":
            monkeypatch.setenv(autotune.ENV_KILL, "0")
        before = _counters()
        tr = Trainer(cfg, device="cpu")
        tr.fit(tr.init_state(), num_steps=4)
        losses[name] = [r["loss"] for r in _train(tr)]
        _valid(tr)
        if name == "armed":
            assert tr.autotuner is not None
            assert all("autotune" in r for r in _train(tr))
            continue
        assert tr.autotuner is None and tr.host_prefetch is None
        assert not any(r["event"] == "autotune_armed" for r in tr.records)
        assert not any("autotune" in r for r in tr.records)
        assert _counters() == before
    # the same batches as a caller's dataset: no stage at all
    tr = Trainer(base, device="cpu")
    src = tr.make_dataset("train")
    batches = [next(src) for _ in range(4)]
    src.close()
    tr.fit(tr.init_state(), batches, num_steps=4)
    losses["caller"] = [r["loss"] for r in _train(tr)]
    assert losses["armed"] == losses["disabled"] == losses["killed"] == \
        losses["caller"]


def test_armed_receipt_binds_the_knobs_jax_binds(data_dir, tmp_path):
    port = Trainer(_cfg(**{"data.data_dir": data_dir}), device="cpu")
    port.fit(port.init_state(), num_steps=1)
    got = [r for r in port.records if r["event"] == "autotune_armed"][0]
    jsonl = str(tmp_path / "jax.jsonl")
    cfg = jcfg.apply_overrides(jcfg.get_config("vggf_imagenet_dp"), {
        **NARROW, "data.data_dir": data_dir, "train.steps": "1",
        "mesh.num_data": "0"})
    mesh = build_mesh(MeshSpec(("data",), (1,)), devices=jax.devices()[:1])
    ref = JaxTrainer(cfg, mesh=mesh,
                     logger=JaxLogger(jsonl_path=jsonl, stream=io.StringIO()))
    ref.fit(ref.init_state(), num_steps=1)
    with open(jsonl) as f:
        want = [r for r in map(json.loads, f)
                if r["event"] == "autotune_armed"][0]
    assert [k["name"] for k in want["knobs"]][-1] == "wire_u8"
    want_knobs = [k for k in want["knobs"] if k["name"] != "wire_u8"]
    assert got["knobs"] == want_knobs
    assert [k["name"] for k in got["knobs"]] == [
        "native_threads", "host_prefetch", "prefetch_to_device"]
    for key in ("enabled", "live", "windows", "settled", "actuations_total",
                "streak", "config"):
        assert got[key] == want[key], key
    assert got["unbound"] == {"wire_u8": WIRE_KNOB_UNBOUND}


def _recorded_verdicts(monkeypatch, verdict="infeed_bound"):
    """Every window's stall verdict, as the controller sees it, is
    `verdict`: the records keep the measured `stall` block."""
    observe = autotune.IngestAutotuner.observe
    monkeypatch.setattr(
        autotune.IngestAutotuner, "observe",
        lambda self, stall=None: observe(self, {**(stall or {}),
                                                "verdict": verdict}))


def test_resume_after_the_read_ahead_grew_is_bit_equal(data_dir, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(autotune, "K_WINDOWS", 1)
    monkeypatch.setattr(autotune, "COOLDOWN_WINDOWS", 0)
    monkeypatch.setattr(autotune, "MAX_THREADS", 2)  # the pool starts railed
    monkeypatch.setattr(autotune, "MAX_PREFETCH", 3)
    _recorded_verdicts(monkeypatch)
    sets = {"data.data_dir": data_dir, "train.checkpoint_every_steps": "3"}
    straight = _slowed(Trainer(_cfg(**sets), device="cpu"), 0.05)
    want = straight.fit(straight.init_state(), num_steps=10)
    ck = {**sets, "train.checkpoint_dir": str(tmp_path / "ck")}
    first = _slowed(Trainer(_cfg(**ck), device="cpu"), 0.05)
    first.fit(num_steps=6)
    grown = _train(first)[-1]["autotune"]["knobs"]
    assert grown["native_threads"] == 2      # railed from the start
    assert grown["host_prefetch"] == 3 and grown["prefetch_to_device"] > 2
    blob = first.checkpoints.iterator_state_at(6)
    assert blob["cursor"] == 6 and blob["source_cursor"] >= 6
    second = _slowed(Trainer(_cfg(**ck), device="cpu"), 0.05)
    got = second.fit(num_steps=10)
    events = [r["event"] for r in second.records]
    assert "iterator_state_restore" in events
    assert "data_fast_forward" not in events
    assert [r["loss"] for r in _train(first) + _train(second)] == \
        [r["loss"] for r in _train(straight)]
    for (k, a), b in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(a, b), k

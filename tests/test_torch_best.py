"""The best-eval slot of the port: checkpoint/manager.py's `best_metric`
mode and the trainer's eval cadence over it (JAX `manager.py:113–214`,
`trainer.py:418–450, 861–884, 1404–1443`; mirrors
tests/test_best_checkpoint.py of the JAX package).

- The manager: retention and `best_step()` by the recorded score (max),
  the score in the step's `metrics.json` under the checksum manifest, a
  fresh manager reading the scores back, `latest_extra()`; a collision
  staged at an unused index, the old entry on disk until the new one is
  durable.
- The trainer (narrow VGG-F, 32 px, fp32, synthetic batches, evals
  scripted): the slot is saved only when eval_top1 improves, holds one
  step, and a resumed run does not regress it; `restore_from_best`
  restores it and, in `fit`, deletes the main chain's steps ahead of it
  (`branch_truncate`); a bare restore (eval, predict) keeps them; without
  a slot the latest is restored (`restore_from_best_unavailable`);
  `track_best_eval` false makes no slot.
- Under a 2-rank gloo group each rank reads the slot's threshold from its
  own view of the directory: views that differ (one rank's slot
  damaged) raise CheckpointIntegrityError on every rank before the
  collective best-slot save could split them; equal views train on."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu_torch.checkpoint import manager as manager_mod
from distributed_vgg_f_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_vgg_f_tpu_torch.config import get_config
from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
from distributed_vgg_f_tpu_torch.resilience.integrity import step_dir
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from _torch_dp_worker import run_group


def _tree(step, value=0.0):
    return {"step": np.array(step, np.int32),
            "params/fc/kernel": np.full((4, 3), value, np.float32)}


# ------------------------------------------------------------ the manager
def test_best_manager_retains_and_chooses_by_score(tmp_path):
    root = str(tmp_path / "best")
    mgr = CheckpointManager(root, max_to_keep=2, best_metric="eval_top1")
    for step, score in ((2, 0.3), (4, 0.5), (6, 0.4)):
        assert mgr.save(_tree(step), extra={"step": step}, force=True,
                        metrics={"eval_top1": score})
    mgr.wait()
    assert mgr.all_steps() == [4, 6]          # 2 scored worst
    assert mgr.best_step() == 4               # not the newest
    assert mgr.latest_extra() == {"step": 4}
    assert mgr.metrics_at(6) == {"eval_top1": 0.4}
    assert mgr.verify_step(4)
    again = CheckpointManager(root, max_to_keep=2, best_metric="eval_top1")
    assert again.best_step() == 4             # scores read from disk
    # a damaged metrics.json fails the manifest: the next step is chosen
    with open(os.path.join(step_dir(root, 4), "metrics.json"), "w") as f:
        f.write('{"eval_top1": 0.9}')
    third = CheckpointManager(root, max_to_keep=2, best_metric="eval_top1")
    assert third.best_step() == 6
    assert third.last_integrity_fallback["chosen"] == 6


def test_best_collision_is_staged_and_never_empties_the_slot(tmp_path,
                                                             monkeypatch):
    root = str(tmp_path / "best")
    first = CheckpointManager(root, max_to_keep=1, best_metric="eval_top1")
    assert first.save(_tree(10, 1.0), extra={"eval_top1": 0.5}, force=True,
                      metrics={"eval_top1": 0.5})
    first.wait()
    seen = []
    write = manager_mod.CheckpointManager._write_step

    def watched(self, idx, *args):
        seen.append((idx, sorted(os.listdir(root))))
        return write(self, idx, *args)

    monkeypatch.setattr(manager_mod.CheckpointManager, "_write_step",
                        watched)
    # a branched run re-reaches step 10 with a better score
    branch = CheckpointManager(root, max_to_keep=1, best_metric="eval_top1")
    assert branch.save(_tree(10, 2.0), extra={"eval_top1": 0.7}, force=True,
                       metrics={"eval_top1": 0.7},
                       replace_on_collision=True)
    branch.wait()
    assert seen[0][0] == 11 and "10" in seen[0][1]
    assert branch.all_steps() == [11] and branch.best_step() == 11
    arrays, extra = branch.restore()
    assert int(arrays["step"]) == 10 and extra == {"eval_top1": 0.7}
    np.testing.assert_array_equal(arrays["params/fc/kernel"],
                                  np.full((4, 3), 2.0, np.float32))
    assert sorted(os.listdir(root)) == ["11", "integrity"]


# ------------------------------------------------------------ the trainer
def _cfg(tmp_path, steps=10, **train):
    cfg = get_config("vggf_teacher")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, num_classes=10,
                                  extra={"stem_features": 8,
                                         "conv_features": 16,
                                         "fc_features": 32}),
        data=dataclasses.replace(cfg.data, image_size=32,
                                 global_batch_size=8, num_train_examples=64,
                                 num_eval_examples=16),
        train=dataclasses.replace(
            cfg.train, steps=steps, log_every=2, eval_every_steps=2,
            checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_steps=2,
            keep_checkpoints=10, **train))


def _scripted(trainer, scores):
    """The trainer's evals return `scores` in turn (and log as evaluate
    does)."""
    it = iter(scores)

    def evaluate(state, dataset, num_batches=None, use_ema=None, step=None):
        top1 = next(it)
        result = {"eval_top1": top1, "eval_top5": top1,
                  "eval_examples": 16, "eval_seconds": 0.0}
        trainer.log("eval", {"step": step, **result})
        return result

    trainer.evaluate = evaluate
    return trainer


def _fit(trainer, steps=None):
    return trainer.fit(None, SyntheticU8(8, 32, 10, seed=1),
                       num_steps=steps, eval_dataset=SyntheticU8(8, 32, 10))


def _events(trainer, event):
    return [r for r in trainer.records if r["event"] == event]


def test_best_slot_saved_only_on_improvement(tmp_path):
    tr = _scripted(Trainer(_cfg(tmp_path), device="cpu"),
                   [0.2, 0.5, 0.5, 0.3, 0.6])
    assert tr.best_checkpoints is None
    _fit(tr)
    assert [r["step"] for r in _events(tr, "best_checkpoint")] == [2, 4, 10]
    best = tr.best_checkpoints
    assert best.all_steps() == [10]
    extra = best.latest_extra()
    assert (extra["eval_top1"], extra["step"]) == (0.6, 10)
    assert "examples_seen" in extra
    assert best.metrics_at(10) == {"eval_top1": 0.6}

    # a resumed run seeds its threshold from the slot: 0.55 and 0.58 do
    # not replace 0.6
    again = _scripted(Trainer(_cfg(tmp_path, steps=14), device="cpu"),
                      [0.55, 0.58])
    _fit(again)
    assert _events(again, "best_checkpoint") == []
    assert again.best_checkpoints.latest_extra() == extra


def test_restore_from_best_truncates_the_branch_in_fit_only(tmp_path):
    tr = _scripted(Trainer(_cfg(tmp_path), device="cpu"),
                   [0.2, 0.9, 0.5, 0.3, 0.4])
    _fit(tr)
    # step 1: a manager's first save is always taken (Orbax's policy)
    assert tr.checkpoints.all_steps() == [1, 2, 4, 6, 8, 10]
    best_cfg = _cfg(tmp_path, restore_from_best=True)
    # eval and predict restore the slot and keep the chain
    reader = Trainer(best_cfg, device="cpu")
    state = reader.restore_or_init()
    assert state.step == 4
    assert _events(reader, "restore") == [{"event": "restore", "step": 4,
                                           "best": True}]
    assert reader.checkpoints.all_steps() == [1, 2, 4, 6, 8, 10]
    # training from it abandons the chain beyond it
    branch = _scripted(Trainer(best_cfg, device="cpu"), [0.1])
    state = _fit(branch, steps=6)
    assert _events(branch, "branch_truncate") == [
        {"event": "branch_truncate", "from_step": 4,
         "deleted_steps": [6, 8, 10]}]
    assert state.step == 6
    assert branch.checkpoints.all_steps() == [1, 2, 4, 6]
    assert not os.path.isdir(os.path.join(best_cfg.train.checkpoint_dir,
                                          "best", "best"))


def test_restore_from_best_without_a_slot_falls_back_to_the_latest(
        tmp_path):
    tr = _scripted(Trainer(_cfg(tmp_path, track_best_eval=False),
                           device="cpu"), [0.2, 0.5, 0.5, 0.3, 0.6])
    _fit(tr)
    assert tr.best_checkpoints is None
    assert not os.path.isdir(os.path.join(str(tmp_path / "ck"), "best"))
    again = Trainer(_cfg(tmp_path, restore_from_best=True), device="cpu")
    state = again.restore_or_init()
    assert state.step == 10
    assert [r["event"] for r in again.records] == [
        "restore_from_best_unavailable", "restore"]
    assert again.records[0] == {"event": "restore_from_best_unavailable",
                                "fallback": "latest"}


def test_best_slot_holds_the_evaluated_weights(tmp_path):
    """The real evaluate inside fit: the slot's weights score what was
    recorded."""
    cfg = _cfg(tmp_path, steps=4)
    tr = Trainer(cfg, device="cpu")
    _fit(tr)
    best = _events(tr, "best_checkpoint")[-1]
    reader = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, restore_from_best=True)), device="cpu")
    state = reader.restore_or_init()
    assert state.step == best["step"]
    result = reader.evaluate(state, SyntheticU8(8, 32, 10))
    assert result["eval_top1"] == best["eval_top1"]
    assert result["eval_examples"] == 16
    assert torch.equal(
        state.model.state_dict()["conv1.weight"],
        reader.restore_or_init().model.state_dict()["conv1.weight"])


#: `_cfg` as the dotted overrides the group's worker applies
_CFG_SETS = {"model.num_classes": "10", "model.extra.stem_features": "8",
             "model.extra.conv_features": "16",
             "model.extra.fc_features": "32", "data.image_size": "32",
             "data.global_batch_size": "8", "data.num_train_examples": "64",
             "data.num_eval_examples": "16", "train.log_every": "2",
             "train.eval_every_steps": "2",
             "train.checkpoint_every_steps": "2",
             "train.keep_checkpoints": "10"}


@pytest.mark.parametrize("damaged", [False, True])
def test_ranks_agree_on_the_best_threshold_or_raise(tmp_path, damaged):
    tr = _scripted(Trainer(_cfg(tmp_path), device="cpu"),
                   [0.2, 0.5, 0.5, 0.3, 0.6])
    _fit(tr)
    dirs = [str(tmp_path / f"view{r}") for r in range(2)]
    for d in dirs:
        shutil.copytree(tr.cfg.train.checkpoint_dir, d)
    if damaged:   # rank 1 sees the slot's score fail its manifest
        with open(os.path.join(step_dir(os.path.join(dirs[1], "best"), 10),
                               "metrics.json"), "w") as f:
            f.write('{"eval_top1": 0.9}')
    case = dict(name="view", best_view=True, preset="vggf_teacher",
                overrides=_CFG_SETS, dirs=dirs, steps=12)
    out = run_group(2, {"cases": [case]}, {}, str(tmp_path / "group"),
                    timeout=180.0)
    errors = [str(out[r]["view/error"]) for r in range(2)]
    if damaged:
        for e in errors:
            assert "best-slot eval_top1 thresholds [0.6, -inf]" in e
    else:
        assert errors == ["", ""]
        # the real evals at step 12 do not beat 0.6: the slot stays
        for d in dirs:
            assert CheckpointManager(os.path.join(d, "best"),
                                     best_metric="eval_top1"
                                     ).all_steps() == [10]

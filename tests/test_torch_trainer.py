"""The port's core training loop (distributed_vgg_f_tpu_torch/train/
trainer.py), its guard and meter, on the CPU at a small size: records
carry the JAX trainer's keys (train/trainer.py:1210-1228 in the JAX
package), the flagship preset trains with its one-shard ZeRO and bucket
settings downgraded, the guard aborts a run of non-finite batches, and
the entry point refuses to run without a GPU unless asked for the CPU."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu_torch.config import ElasticConfig, get_config
from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
from distributed_vgg_f_tpu_torch.resilience.guard import NonFiniteStepError
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.utils.meter import ThroughputMeter

#: Keys of a JAX train record that the port writes (the step metrics,
#: the meter's snapshot, the host-wait share, the `stall` verdict and the
#: `comm` block the step fills on its first call).
JAX_TRAIN_KEYS = {"step", "loss", "l2_loss", "top1", "grad_norm", "lr",
                  "bad_step", "images_per_sec", "images_per_sec_per_chip",
                  "steps_per_sec", "window_images_per_sec",
                  "host_wait_fraction", "stall", "comm"}


def _small(name="vggf_teacher", batch=8, **train):
    cfg = get_config(name)
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, num_classes=10),
        data=dataclasses.replace(cfg.data, image_size=32,
                                 global_batch_size=batch,
                                 num_train_examples=batch * 16),
        train=dataclasses.replace(cfg.train, **train))


def test_fit_three_steps_writes_records_with_the_jax_keys():
    cfg = _small(log_every=2)
    seen = []
    tr = Trainer(cfg, device="cpu", log=lambda e, p: seen.append(e))
    state = tr.init_state()
    state = tr.fit(state, SyntheticU8(8, 32, 10, seed=0), num_steps=3)
    assert state.step == 3 and state.opt_count == 3
    train = [r for r in tr.records if r["event"] == "train"]
    assert [r["step"] for r in train] == [2, 3]  # every 2nd and the last
    for r in train:
        assert set(r) - {"event"} == JAX_TRAIN_KEYS
        assert all(math.isfinite(v) for k, v in r.items()
                   if k not in ("event", "comm", "stall"))
    assert seen == ["train", "train"]
    result = tr.evaluate(state, SyntheticU8(8, 32, 10, seed=1), 2)
    assert result["eval_examples"] == 16
    assert 0.0 <= result["eval_top1"] <= result["eval_top5"] <= 1.0


def test_each_state_owns_its_model():
    tr = Trainer(_small(log_every=10), device="cpu")
    a, b = tr.init_state(), tr.init_state()
    assert a.model is not b.model
    before = {k: v.clone() for k, v in b.model.state_dict().items()}
    tr.fit(a, SyntheticU8(8, 32, 10), num_steps=1)
    assert a.opt_count == 1 and b.step == 0
    for k, v in b.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_flagship_preset_trains_with_augment_and_packed_stem():
    cfg = _small("vggf_imagenet_dp", batch=4, log_every=1)
    tr = Trainer(cfg, device="cpu")
    assert tr.device_augment is not None
    state = tr.fit(tr.init_state(), SyntheticU8(4, 32, 10), num_steps=2)
    losses = [r["loss"] for r in tr.records]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_nonfinite_batches_are_counted_then_abort_the_run():
    cfg = _small(log_every=1, max_nonfinite_steps=3)
    good = SyntheticU8(8, 32, 10).batch
    bad = {"image": torch.full((8, 32, 32, 3), float("nan")),
           "label": good["label"]}
    tr = Trainer(cfg, device="cpu")
    state = tr.fit(tr.init_state(), [good, bad, good, good], num_steps=4)
    assert state.opt_count == 3
    assert [r.get("nonfinite_skips") for r in tr.records
            if r["event"] == "train"] == [None, None, None, 1]
    with pytest.raises(NonFiniteStepError, match="3 consecutive"):
        tr.fit(tr.init_state(), [bad] * 6, num_steps=6)


@pytest.mark.parametrize("preset,section,field,value,error,match", [
    ("vggf_imagenet_dp", "mesh", "shard_params", True, NotImplementedError,
     "ROADMAP A13"),
    ("vggf_teacher", "mesh", "elastic", ElasticConfig(enabled=True),
     NotImplementedError, "ROADMAP A13"),
    ("vggf_imagenet_dp", "train", "grad_accum_shard", True, ValueError,
     "grad_accum_steps > 1")])
def test_unported_options_are_refused(preset, section, field, value, error,
                                      match):
    """ZeRO-3 and elastic resize are not ported; a sharded accumulator
    needs ZeRO and k > 1."""
    cfg = _small(preset)
    cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **{field: value})})
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu")


def test_trainer_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_small())


@pytest.mark.parametrize("name", ["vggf_imagenet_dp", "vggf_teacher",
                                  "vit_s16_imagenet"])
def test_presets_match_the_jax_presets(name):
    """Every field the port's config keeps has the JAX preset's value, and
    the derived LR and step counts agree."""
    from distributed_vgg_f_tpu import config as jcfg
    ours, ref = get_config(name), jcfg.get_config(name)

    def same(a, b, path):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(va):
                same(va, vb, f"{path}.{f.name}")
            else:
                assert va == vb or (isinstance(va, (tuple, list))
                                    and tuple(va) == tuple(vb)), \
                    f"{path}.{f.name}: {va!r} != {vb!r}"

    for section in ("model", "optim", "data", "mesh", "train"):
        same(getattr(ours, section), getattr(ref, section), section)
    assert (ours.scaled_lr, ours.steps_per_epoch, ours.total_steps) \
        == (ref.scaled_lr, ref.steps_per_epoch, ref.total_steps)


def test_meter_rates_with_an_injected_clock():
    t = [0.0]
    meter = ThroughputMeter(num_chips=2, clock=lambda: t[0], window=2)
    assert meter.window_images_per_sec is None
    for dt in (1.0, 1.0, 2.0):
        t[0] += dt
        meter.update(10)
    snap = meter.snapshot()
    assert snap["images_per_sec"] == pytest.approx(30 / 4)
    assert snap["images_per_sec_per_chip"] == pytest.approx(30 / 8)
    assert snap["steps_per_sec"] == pytest.approx(3 / 4)
    assert snap["window_images_per_sec"] == pytest.approx(20 / 3)


def test_synthetic_batches_are_seeded_and_cycled():
    a = SyntheticU8(2, 8, 5, seed=3)
    b = SyntheticU8(2, 8, 5, seed=3)
    c = SyntheticU8(2, 8, 5, seed=4)
    it = iter(a)
    first, second = next(it), next(it)
    assert first["image"].dtype == torch.uint8
    assert first["image"].shape == (2, 8, 8, 3)
    assert torch.equal(first["image"], b.batch["image"])
    assert torch.equal(first["label"], b.batch["label"])
    assert not torch.equal(first["image"], c.batch["image"])
    assert second is first


def test_train_records_cover_their_own_window():
    """Each train record's rates and host_wait_fraction cover the steps
    since the previous record (the JAX trainer resets its meter and
    host-wait clock after each record, trainer.py:1400-1401): two windows
    at different speeds, on an injected clock."""
    t = [0.0]
    # window 1: each step waits 0.5 s for its batch and computes 0.5 s;
    # window 2: waits 0.1 s and computes 0.15 s
    costs = [(0.5, 0.5)] * 2 + [(0.1, 0.15)] * 2

    class Timed:
        def __init__(self):
            self.i = 0
            self.src = iter(SyntheticU8(8, 32, 10))

        def __iter__(self):
            return self

        def __next__(self):
            t[0] += costs[self.i][0]
            return next(self.src)

    cfg = _small(log_every=2)
    tr = Trainer(cfg, device="cpu")
    tr.clock = lambda: t[0]
    data = Timed()
    step = tr.train_step

    def timed_step(state, batch, seed):
        out = step(state, batch, seed)
        t[0] += costs[data.i][1]
        data.i += 1
        return out

    tr.train_step = timed_step
    tr.fit(tr.init_state(), data, num_steps=4)
    first, second = [r for r in tr.records if r["event"] == "train"]
    assert first["images_per_sec"] == pytest.approx(16 / 2.0)
    assert first["steps_per_sec"] == pytest.approx(2 / 2.0)
    assert first["host_wait_fraction"] == pytest.approx(0.5)
    assert second["images_per_sec"] == pytest.approx(16 / 0.5)
    assert second["steps_per_sec"] == pytest.approx(2 / 0.5)
    assert second["host_wait_fraction"] == pytest.approx(0.4)

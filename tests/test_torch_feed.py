"""The port's training feed on the CPU: the cursor-counting ingest and its
blob (distributed_vgg_f_tpu_torch/data/iterator_state.py,
telemetry/schema.py) against the JAX package's at the same cursors, the
device prefetcher (data/prefetch.py) with `device="cpu"`, and
`Trainer.fit(state)` with no dataset on a narrow VGG-F (stem 8, convs 16,
FC 32, 10 classes, 32 px, fp32) over TFRecords of the fixture JPEGs:
the step gets exactly the batches the JAX native loader yields, and a
resumed fit seeks to `state.step`."""

import copy
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.data import imagenet as jimagenet
from distributed_vgg_f_tpu.data import iterator_state as jstate
from distributed_vgg_f_tpu.data import native_jpeg as jjpeg
from distributed_vgg_f_tpu.telemetry import schema as jschema
from distributed_vgg_f_tpu_torch.config import ModelConfig, get_config
from distributed_vgg_f_tpu_torch.data import iterator_state as pstate
from distributed_vgg_f_tpu_torch.data.prefetch import DevicePrefetchIterator
from distributed_vgg_f_tpu_torch.resilience.errors import DataStallError
from distributed_vgg_f_tpu_torch.telemetry import get_registry
from distributed_vgg_f_tpu_torch.telemetry import schema as pschema
from distributed_vgg_f_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.tfrecord_write import write_shards  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
CLASSES, SIZE, BATCH = 10, 32, 4


class Numbered:
    """A seekable source of numbered u8 batches; `next_into` too when
    `into`."""

    supports_state = True
    image_dtype = "uint8"
    image_shape = (2, 4, 4, 3)

    def __init__(self, cfg=None, stop=None, fail_at=None):
        self.n, self.stop, self.fail_at = 0, stop, fail_at
        self.closed = False

    def __iter__(self):
        return self

    def _draw(self):
        if self.fail_at is not None and self.n == self.fail_at:
            raise ValueError(f"source failed at {self.n}")
        if self.stop is not None and self.n >= self.stop:
            raise StopIteration
        self.n += 1
        return self.n - 1

    def __next__(self):
        k = self._draw()
        return {"image": np.full(self.image_shape, k, np.uint8),
                "label": np.full((2,), k, np.int32)}

    def restore_state(self, k):
        self.n = int(k)
        return True

    def close(self):
        self.closed = True


class NumberedInto(Numbered):
    def next_into(self, images, labels):
        k = self._draw()
        images.fill_(k)
        labels.fill_(k)


def _ingests(batches_per_epoch=4):
    kw = dict(seed=7, batches_per_epoch=batches_per_epoch)
    return (pstate.ResumableIngest(Numbered, None, **kw),
            jstate.ResumableIngest(Numbered, None, **kw))


# ------------------------------------------------------- the ingest's blob
@pytest.mark.parametrize("next_step", [0, 3, 5])
def test_capture_state_and_window_receipt_equal_jax(next_step):
    ours, ref = _ingests()
    for _ in range(5):
        next(ours)
        next(ref)
    assert ours.cursor == ref.cursor == 5
    assert ours.capture_state(next_step) == ref.capture_state(next_step)
    assert ours.window_receipt(next_step) == ref.window_receipt(next_step)
    errors = []
    pschema.validate_iterator_state_blob(ours.capture_state(next_step),
                                         "blob", errors)
    assert errors == []


def test_next_into_draws_move_the_cursor():
    ingest = pstate.ResumableIngest(NumberedInto, None, seed=0,
                                    batches_per_epoch=4)
    images = torch.empty(Numbered.image_shape, dtype=torch.uint8)
    labels = torch.empty((2,), dtype=torch.int32)
    assert ingest.restore_state(6)
    ingest.next_into(images, labels)
    next(ingest)
    assert ingest.cursor == 8 and int(images[0, 0, 0, 0]) == 6
    assert not ingest.restore_state(0)  # exact only before the first draw
    blob = ingest.capture_state(7)
    assert blob["in_flight"] == [7] and blob["wire"] == "u8"
    ingest.close()
    assert ingest.decode_errors() == 0
    with pytest.raises(StopIteration):
        next(ingest)


def test_restore_from_blob_gives_jax_receipt():
    blob = _ingests()[0].capture_state(6)
    blob = dict(blob, source_cursor=8, in_flight=[6, 7])
    ours, ref = _ingests()
    expect = {"seed": 7, "batches_per_epoch": 4, "ingest": "local"}
    got = pstate.restore_from_blob(ours, blob, step=6, expect=expect)
    want = jstate.restore_from_blob(ref, blob, step=6, expect=expect)
    assert got == want and got["transplanted_items"] == 2
    assert ours.cursor == ref.cursor == 6
    assert int(next(ours)["image"][0, 0, 0, 0]) == 6


def _bad(key, value):
    def mutate(blob):
        blob[key] = value
        return blob
    return mutate


MALFORMED = {
    "not_an_object": lambda blob: ["cursor", 6],
    "kind": _bad("kind", "other"),
    **{f"int_{k}": _bad(k, str(k)) for k in (
        "version", "cursor", "epoch", "batches_per_epoch", "seed",
        "source_cursor", "rebuilds")},
    "epoch_of_cursor": _bad("epoch", 0),
    "shuffle": _bad("shuffle", {"algo": "pcg", "seed": 7, "epoch": 1}),
    "in_flight_type": _bad("in_flight", "6"),
    "in_flight_range": _bad("in_flight", [6, 8]),
    "wire": _bad("wire", "host_f16"),
    # valid shape, refused at dispatch
    "version_unknown": _bad("version", 2),
    "cursor_not_step": _bad("cursor", 4),
    "identity_seed": _bad("seed", 8),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_restore_from_blob_refuses_what_jax_refuses(case):
    ours, ref = _ingests()
    good = ours.capture_state(6)
    if case == "cursor_not_step":  # self-consistent, but not at step 6
        good = ours.capture_state(4)
    blob = MALFORMED[case](copy.deepcopy(good))
    errors_ours, errors_ref = [], []
    pschema.validate_iterator_state_blob(blob, "b", errors_ours)
    jschema.validate_iterator_state_blob(blob, "b", errors_ref)
    assert errors_ours == errors_ref
    expect = {"seed": 7, "batches_per_epoch": 4, "ingest": "local"}
    assert pstate.restore_from_blob(ours, blob, step=6, expect=expect) \
        is None
    assert jstate.restore_from_blob(ref, blob, step=6, expect=expect) is None
    assert ours.cursor == 0


# ----------------------------------------------------- the prefetcher, CPU
def test_prefetch_keeps_order_and_moves_its_counters():
    reg = get_registry()
    before = {k: reg.counter_value(f"prefetch/{k}", 0)
              for k in ("batches", "source_batches", "device_put_bytes",
                        "wait_ns")}
    feed = DevicePrefetchIterator(Numbered(stop=7), "cpu", buffer_size=2)
    got = [int(b["image"][0, 0, 0, 0]) for b in feed]
    assert got == list(range(7))
    after = {k: reg.counter_value(f"prefetch/{k}", 0) for k in before}
    assert after["batches"] - before["batches"] == 7
    assert after["source_batches"] - before["source_batches"] == 7
    assert after["device_put_bytes"] - before["device_put_bytes"] \
        == 7 * (2 * 4 * 4 * 3 + 2 * 4)
    assert after["wait_ns"] > before["wait_ns"]
    assert reg.gauge("prefetch/bytes_in_flight") == 0


def test_prefetch_next_into_source_gives_consumer_owned_tensors():
    """On the CPU every batch is decoded into fresh tensors: a batch the
    consumer holds is never written again."""
    ingest = pstate.ResumableIngest(lambda cfg: NumberedInto(stop=6), None,
                                    seed=0, batches_per_epoch=3)
    feed = DevicePrefetchIterator(ingest, "cpu", buffer_size=1)
    held = list(feed)
    assert [int(b["image"].max()) for b in held] == list(range(6))
    assert all(int(b["image"].min()) == k for k, b in enumerate(held))
    assert held[0]["label"].dtype == torch.int32
    assert ingest.cursor == 6


def test_prefetch_passes_a_source_error_through_in_order():
    feed = DevicePrefetchIterator(Numbered(fail_at=3), "cpu", buffer_size=2)
    assert [int(next(feed)["label"][0]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="source failed at 3"):
        next(feed)
    with pytest.raises(StopIteration):
        next(feed)


def test_prefetch_dead_worker_is_a_data_stall(monkeypatch):
    monkeypatch.setattr(DevicePrefetchIterator, "_worker", lambda self: None)
    reg = get_registry()
    dead = reg.counter_value("prefetch/dead_workers", 0)
    feed = DevicePrefetchIterator(Numbered(), "cpu")
    try:
        with pytest.raises(DataStallError, match="died"):
            next(feed)
    finally:
        feed.close()
    assert reg.counter_value("prefetch/dead_workers") == dead + 1


def test_prefetch_watchdog_times_out_after_its_retries():
    release = threading.Event()

    class Silent(Numbered):
        def __next__(self):
            release.wait(30)
            raise StopIteration

    reg = get_registry()
    timeouts = reg.counter_value("prefetch/timeouts", 0)
    feed = DevicePrefetchIterator(Silent(), "cpu", batch_timeout_s=0.1,
                                  timeout_retries=1)
    try:
        t0 = time.monotonic()
        with pytest.raises(DataStallError, match="data_timeout_s"):
            next(feed)
        assert 0.3 <= time.monotonic() - t0 < 10.0  # 0.1 + 0.2, polled
    finally:
        release.set()
        feed.close()
    assert reg.counter_value("prefetch/timeouts") == timeouts + 2


def test_prefetch_close_mid_stream_joins_the_worker():
    src = Numbered()
    feed = DevicePrefetchIterator(src, "cpu", buffer_size=2)
    next(feed)
    feed.close()
    assert not feed.worker_alive and not src.closed
    with pytest.raises(StopIteration):
        next(feed)
    assert int(next(src)["label"][0]) == src.n - 1


def test_prefetch_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetchIterator(Numbered())


# ------------------------------------------------------- the trainer's feed
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("feed_tfrecords")
    jpegs = []
    for f in sorted(os.listdir(FIXTURE))[:6]:
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            jpegs.append(fh.read())
    write_shards(str(root), jpegs, [1 + k for k in range(6)],
                 shards=2, per_shard=7)
    return str(root)


def _cfg(data_dir, **train):
    cfg = get_config("vggf_imagenet_dp")
    return dataclasses.replace(
        cfg,
        model=ModelConfig(num_classes=CLASSES, compute_dtype="float32",
                          extra=WIDTHS),
        data=dataclasses.replace(cfg.data, data_dir=data_dir,
                                 image_size=SIZE, global_batch_size=BATCH,
                                 num_train_examples=14, native_threads=2),
        train=dataclasses.replace(cfg.train, log_every=1, seed=3, **train))


def _jax_stream(cfg, n):
    """The JAX native loader's first `n` train batches for `cfg`, built as
    its _build_tfrecord_native builds them."""
    jdata = dataclasses.replace(jcfg.get_config("vggf_imagenet_dp").data,
                                data_dir=cfg.data.data_dir, image_size=SIZE,
                                global_batch_size=BATCH)
    files, labels, ranges = jimagenet.native_train_items(jdata)
    it = jjpeg.NativeJpegTrainIterator(
        files, labels, batch=BATCH, image_size=SIZE, seed=cfg.train.seed,
        mean=np.asarray(jdata.mean_rgb, np.float32),
        std=np.asarray(jdata.stddev_rgb, np.float32), image_dtype="uint8",
        num_threads=2, ranges=ranges, space_to_depth=False,
        hflip=not jdata.augment.owns_hflip)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _spy(trainer):
    seen = []
    step = trainer.train_step

    def spy(state, batch, seed):
        seen.append({k: torch.as_tensor(v).clone() for k, v in batch.items()})
        return step(state, batch, seed)

    trainer.train_step = spy
    return seen


def test_fit_without_dataset_feeds_the_jax_native_batches(data_dir):
    cfg = _cfg(data_dir)
    tr = Trainer(cfg, device="cpu")
    seen = _spy(tr)
    state = tr.fit(tr.init_state(), num_steps=5)  # 14 items: 3+ epochs
    assert state.step == 5
    want = _jax_stream(cfg, 5)
    for got, ref in zip(seen, want):
        assert got["image"].dtype == torch.uint8
        np.testing.assert_array_equal(got["image"].numpy(), ref["image"])
        np.testing.assert_array_equal(got["label"].numpy(), ref["label"])
    recs = [r for r in tr.records if r["event"] == "train"]
    assert len(recs) == 5 and all(np.isfinite(r["loss"]) for r in recs)
    assert 0.0 <= recs[-1]["host_wait_fraction"] <= 1.0
    assert "data_decode_errors" not in recs[-1]
    assert tr.ingest.decode_errors() == 0
    assert isinstance(tr.ingest, pstate.ResumableIngest)


def test_fit_resumes_at_state_step_by_seek(data_dir):
    cfg = _cfg(data_dir)
    tr = Trainer(cfg, device="cpu")
    seen = _spy(tr)
    state = tr.fit(tr.init_state(), num_steps=2)
    state = tr.fit(state, num_steps=4)
    assert [r for r in tr.records
            if r["event"] not in ("train", "autotune_armed")] == [
        {"event": "data_iterator_restore", "step": 2, "restored": True}]
    want = _jax_stream(cfg, 4)
    assert len(seen) == 4
    for got, ref in zip(seen, want):
        np.testing.assert_array_equal(got["image"].numpy(), ref["image"])
    assert tr.ingest.cursor >= 4


def test_fit_replays_a_source_that_cannot_seek(data_dir):
    cfg = _cfg(data_dir)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, name="synthetic"))
    tr = Trainer(cfg, device="cpu")
    seen = _spy(tr)
    state = tr.fit(tr.init_state(), num_steps=2)
    state = tr.fit(state, num_steps=4)
    assert state.step == 4 and len(seen) == 4
    assert [r for r in tr.records
            if r["event"] not in ("train", "autotune_armed")] == [
        {"event": "data_iterator_restore", "step": 2, "restored": False},
        {"event": "data_fast_forward", "batches": 2}]
    assert tr.ingest.cursor >= 4  # 2 replayed, then the 2 steps' draws


@pytest.mark.parametrize("passed", [False, True])
def test_fit_refuses_labels_past_the_head(data_dir, passed):
    cfg = _cfg(data_dir)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=4))  # the records' labels reach 5
    tr = Trainer(cfg, device="cpu")
    dataset = None
    if passed:
        dataset = [{"image": torch.zeros((BATCH, SIZE, SIZE, 3),
                                         dtype=torch.uint8),
                    "label": torch.tensor([0, 1, 2, 5])}]
    state = tr.init_state()
    with pytest.raises(ValueError, match="num_classes=4"):
        tr.fit(state, dataset, num_steps=1)


def test_fit_without_dataset_on_an_unported_source_raises():
    tr = Trainer(get_config("vggf_teacher"), device="cpu")
    with pytest.raises(KeyError, match="teacher"):
        tr.fit(tr.init_state(), num_steps=1)

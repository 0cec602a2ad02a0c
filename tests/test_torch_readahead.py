"""The port's read-ahead stages and decode-pool knob on the CPU
(distributed_vgg_f_tpu_torch/data/prefetch.py, native_jpeg.py,
iterator_state.py): `HostPrefetchIterator` keeps order across `set_depth`
moves, refuses a source that recycles its outputs, relays a source's
error and end, and hands the buffers its `next_into` source decoded into
to the device stage with no host copy between (the tensor the device
stage yields on the CPU is the one `next_into` filled: same data
pointer); `DevicePrefetchIterator.set_buffer_size` grows and shrinks
mid-stream without dropping or repeating a batch, over either source
kind; the native loader's pool resized mid-stream, through
`ResumableIngest.set_num_threads`, yields the JAX native loader's stream
byte for byte; and the ingest's receipts do not wait for a draw in
flight (the two-lock split)."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu.data import native_jpeg as jjpeg
from distributed_vgg_f_tpu_torch.config import get_config
from distributed_vgg_f_tpu_torch.data import autotune
from distributed_vgg_f_tpu_torch.data import native_jpeg as pjpeg
from distributed_vgg_f_tpu_torch.data import native_tfrecord as ptfr
from distributed_vgg_f_tpu_torch.data.iterator_state import ResumableIngest
from distributed_vgg_f_tpu_torch.data.prefetch import (DevicePrefetchIterator,
                                                       HostPrefetchIterator)
from distributed_vgg_f_tpu_torch.telemetry import get_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.tfrecord_write import write_shards  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
SIZE, BATCH = 48, 8
MEAN = np.asarray((123.7, 116.3, 103.5), np.float32)
STD = np.asarray((58.4, 57.1, 57.4), np.float32)


class IntoSource:
    """A `next_into` source: batch n is all n; records each buffer it
    filled."""
    image_shape = (2, 4, 4, 3)
    image_dtype = "uint8"

    def __init__(self, n=None, fail_at=None):
        self.n, self.limit, self.fail_at = 0, n, fail_at
        self.filled = []

    def next_into(self, images, labels):
        if self.n == self.fail_at:
            raise OSError("disk gone")
        if self.limit is not None and self.n >= self.limit:
            raise StopIteration
        images.fill_(self.n % 256)
        labels.fill_(self.n)
        self.filled.append(images.data_ptr())
        self.n += 1


class PlainSource:
    """An iterator of fresh batches: batch n is all n."""

    def __init__(self, n=None):
        self.n, self.limit = 0, n

    def __iter__(self):
        return self

    def __next__(self):
        if self.limit is not None and self.n >= self.limit:
            raise StopIteration
        b = {"image": np.full((2, 4, 4, 3), self.n % 256, np.uint8),
             "label": np.full((2,), self.n, np.int32)}
        self.n += 1
        return b


def _label(batch):
    return int(torch.as_tensor(batch["label"])[0])


@pytest.mark.parametrize("kind", ["into", "plain"])
def test_host_stage_keeps_order_across_depth_moves(kind):
    src = IntoSource(40) if kind == "into" else PlainSource(40)
    hp = HostPrefetchIterator(src, depth=1)
    got = []
    for i, batch in enumerate(hp):
        got.append(_label(batch))
        if i in (3, 11, 25):
            hp.set_depth({3: 6, 11: 1, 25: 3}[i])
            assert hp.depth == {3: 6, 11: 1, 25: 3}[i]
    assert got == list(range(40))
    assert hp.set_depth(0) == 1   # clamped to 1, as JAX's
    hp.close()


def test_host_stage_refuses_recycled_outputs_and_bad_depth():
    class Recycler(PlainSource):
        reuses_output_buffers = True

    with pytest.raises(ValueError, match="recycles its output buffers"):
        HostPrefetchIterator(Recycler())
    with pytest.raises(ValueError, match="depth"):
        HostPrefetchIterator(PlainSource(), depth=0)


def test_host_stage_relays_errors_to_the_consumer():
    hp = HostPrefetchIterator(IntoSource(fail_at=3), depth=2)
    assert [_label(next(hp)) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(OSError, match="disk gone"):
        next(hp)
    with pytest.raises(StopIteration):
        next(hp)


def test_next_into_buffers_reach_the_device_stage_uncopied():
    """CPU: the tensor out of the device stage IS the buffer the source
    decoded into (no host copy); each batch a buffer of its own."""
    src = IntoSource()
    hp = HostPrefetchIterator(src, depth=2, device="cpu")
    assert not hp.lends_buffers   # nothing is lent on the CPU
    dp = DevicePrefetchIterator(hp, "cpu", buffer_size=2)
    batches = [next(dp) for _ in range(6)]
    ptrs = [b["image"].data_ptr() for b in batches]
    assert ptrs == src.filled[:6] and len(set(ptrs)) == 6
    assert [_label(b) for b in batches] == list(range(6))
    dp.close()
    hp.close()


@pytest.mark.parametrize("kind", ["into", "plain", "host_stage"])
def test_ring_resize_drops_and_repeats_no_batch(kind):
    src = {"into": lambda: IntoSource(60), "plain": lambda: PlainSource(60),
           "host_stage": lambda: HostPrefetchIterator(IntoSource(60),
                                                      depth=2)}[kind]()
    dp = DevicePrefetchIterator(src, "cpu", buffer_size=1)
    moves = {2: 4, 9: 1, 15: 3, 30: 1, 31: 4}
    got = []
    for i in range(60):
        got.append(_label(next(dp)))
        if i in moves:
            assert dp.set_buffer_size(moves[i]) == moves[i]
            assert dp.buffer_size == moves[i]
            time.sleep(0.01)   # let the worker run up to the new bound
    assert got == list(range(60))
    with pytest.raises(StopIteration):
        next(dp)
    assert dp.set_buffer_size(-3) == 1
    dp.close()


def test_ingest_receipts_do_not_wait_for_a_draw():
    """A receipt on the trainer thread reads the cursor while a draw is in
    flight on the worker thread (the flagship's record waited a whole
    decode for it before the two-lock split)."""
    release = threading.Event()

    class Slow(IntoSource):
        def next_into(self, images, labels):
            release.wait(5.0)
            super().next_into(images, labels)

    ingest = ResumableIngest(lambda _: Slow(), None, seed=0,
                             batches_per_epoch=10)
    images = torch.empty(Slow.image_shape, dtype=torch.uint8)
    labels = torch.empty((2,), dtype=torch.int32)
    t = threading.Thread(target=ingest.next_into, args=(images, labels))
    t.start()
    time.sleep(0.05)
    t0 = time.monotonic()
    receipt = ingest.window_receipt(0)
    blob = ingest.capture_state(0)
    assert time.monotonic() - t0 < 1.0
    assert receipt["source_cursor"] == blob["source_cursor"] == 0
    release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert ingest.cursor == 1 and ingest.window_receipt(0)["in_flight"] == 1
    ingest.close()


# ------------------------------------------------------------ the pool
def _jpegs():
    out = []
    for f in sorted(os.listdir(FIXTURE)):
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            out.append(fh.read())
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("readahead_tfrecords")
    labels = [1 + (7 * k) % 10 for k in range(16)]
    write_shards(str(root), _jpegs(), labels, shards=3, per_shard=12)
    return sorted(os.path.join(str(root), f) for f in os.listdir(root))


def test_pool_resize_mid_stream_gives_the_jax_stream(files):
    path_idx, offsets, lengths, labels = ptfr.index_tfrecords(files)
    labels = (labels - 1).astype(np.int32)
    args = dict(batch=BATCH, image_size=SIZE, seed=11, mean=MEAN, std=STD,
                ranges=(path_idx, offsets, lengths), image_dtype="uint8",
                num_threads=2)
    ref = jjpeg.NativeJpegTrainIterator(files, labels, **args)
    ingest = ResumableIngest(
        lambda _: pjpeg.NativeJpegTrainIterator(files, labels, **args),
        None, seed=11, batches_per_epoch=4)
    lib = pjpeg.load_native_jpeg()
    assert lib.dvgg_jpeg_resize_supported() and lib.dvgg_jpeg_resize_kind()
    image = torch.empty((BATCH, SIZE, SIZE, 3), dtype=torch.uint8)
    label = torch.empty((BATCH,), dtype=torch.int32)
    assert ingest.num_threads() == 2
    for i, width in enumerate([None, 1, None, 4, 8, None, 2, 1, None, 3]):
        if width is not None:
            assert ingest.set_num_threads(width) == width
            assert ingest.num_threads() == width
        ingest.next_into(image, label)
        want = next(ref)
        np.testing.assert_array_equal(image.numpy(), want["image"])
        np.testing.assert_array_equal(label.numpy(), want["label"])
    ref.close()
    ingest.close()
    assert ingest.num_threads() is None  # the source is closed


def test_pool_resize_refused_by_the_switch(files):
    path_idx, offsets, lengths, labels = ptfr.index_tfrecords(files)
    it = pjpeg.NativeJpegTrainIterator(
        files, (labels - 1).astype(np.int32), batch=BATCH, image_size=SIZE,
        seed=1, mean=MEAN, std=STD, ranges=(path_idx, offsets, lengths),
        image_dtype="uint8", num_threads=2)
    lib = pjpeg.load_native_jpeg()
    try:
        assert lib.dvgg_jpeg_set_resize(0) == 0
        assert lib.dvgg_jpeg_resize_kind() == 0
        assert it.set_num_threads(3) is None
    finally:
        assert lib.dvgg_jpeg_set_resize(1) == 1
    assert it.set_num_threads(3) == 3
    it.close()


def test_flagship_feed_counts_pinned_bytes_only_on_the_card():
    assert get_config("vggf_imagenet_dp").data.autotune.enabled
    assert autotune.HOST_PREFETCH == 2
    reg = get_registry()
    before = reg.gauge("prefetch/pinned_bytes", 0)
    hp = HostPrefetchIterator(IntoSource(4), depth=2, device="cpu")
    dp = DevicePrefetchIterator(hp, "cpu", buffer_size=2)
    [next(dp) for _ in range(4)]
    dp.close()
    hp.close()
    assert reg.gauge("prefetch/pinned_bytes", 0) == before


def test_stress_draws_receipts_and_depth_moves_race_safely():
    """More threads than cores, a short switch interval: draws through
    the ingest from a host stage whose depth keeps moving, while other
    threads read receipts. Every batch arrives once and in order, the
    receipts never run backwards or past the draws, and the cursor ends
    at the number drawn."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n = 300
        ingest = ResumableIngest(lambda _: IntoSource(n), None, seed=0,
                                 batches_per_epoch=7)
        hp = HostPrefetchIterator(ingest, depth=2)
        stop = threading.Event()
        bad = []

        def read_receipts():
            last = 0
            while not stop.is_set():
                c = ingest.window_receipt(0)["source_cursor"]
                if c < last or c > n:
                    bad.append((last, c))
                last = c

        def move_depth():
            k = 0
            while not stop.is_set():
                hp.set_depth(1 + k % 5)
                k += 1

        workers = [threading.Thread(target=read_receipts)
                   for _ in range((os.cpu_count() or 1) + 2)]
        workers.append(threading.Thread(target=move_depth))
        for w in workers:
            w.start()
        got = [_label(b) for b in hp]
        stop.set()
        for w in workers:
            w.join(timeout=10)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(n)) and bad == []
    assert ingest.cursor == n
    hp.close()
    ingest.close()

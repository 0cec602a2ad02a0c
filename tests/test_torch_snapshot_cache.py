"""The decoded-crop snapshot cache in the port
(distributed_vgg_f_tpu_torch/data/snapshot_cache.py) against the JAX
package's (data/snapshot_cache.py), on TFRecords of the committed JPEG
fixture (22 records, distinct labels, 32 px, batch 4, so batches straddle
the epochs), the port on the CPU:

- the SplitMix64 mirror equals JAX's over a grid of (n, seed, epoch), and
  the port's own native loader's labels;
- `params_key` equals JAX's for the same tuple;
- cold then warm over three epochs, with the flip on the host and on the
  device, through `__next__` and `next_into`, byte-equal to JAX's
  `wrap_train_iterator` over the same files and seed, with the same
  hit, miss and byte counts;
- a store JAX's iterator wrote serves the port warm from batch 0;
- the degradations as JAX's tests hold them (tests/test_snapshot_cache.py
  :154–284): a corrupt payload is one miss, repaired to its cold crop;
  a source that drifted is decoded again, never served stale; an
  unreadable one is mean-filled and counted; the capacity bound refuses
  writes and never turns warm; stale generations go, live ones stay; an
  unwritable root costs the cache and not the loader;
- the DP ranks' stores under one root (one family, `family_key`) survive
  a resume that opens them at once after the eviction grace, and a
  serving iterator touches its generation at each epoch boundary;
- the seek is O(1) cold (the native seek) and warm (no decode at all);
- `next_into` into the buffers the host read-ahead lends, through
  `ResumableIngest`, and the warm switch turning the autotuner's thread
  knob unavailable without an error;
- `Trainer.fit` with checkpoints across the switch, resumed, sees JAX's
  stream over the same store, and its losses and weights are those of
  the uninterrupted fit over the complete store;
- `build_dataset` wraps the train stream only when the cache is on, and
  the command line runs it."""

import dataclasses
import glob
import json
import logging
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu import telemetry as jtelemetry
from distributed_vgg_f_tpu.data import native_jpeg as jjpeg
from distributed_vgg_f_tpu.data import snapshot_cache as jsc
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.data import autotune, build_dataset
from distributed_vgg_f_tpu_torch.data import native_jpeg as pjpeg
from distributed_vgg_f_tpu_torch.data import snapshot_cache as psc
from distributed_vgg_f_tpu_torch.data.imagenet import _tfrecord_items
from distributed_vgg_f_tpu_torch.data.iterator_state import ResumableIngest
from distributed_vgg_f_tpu_torch.data.prefetch import (DevicePrefetchIterator,
                                                       HostPrefetchIterator)
from distributed_vgg_f_tpu_torch.telemetry import get_registry
from distributed_vgg_f_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.tfrecord_write import write_shards  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
N, B, SIZE, SEED = 22, 4, 32, 7
MEAN = np.asarray(jcfg.DataConfig().mean_rgb, np.float32)
STD = np.asarray(jcfg.DataConfig().stddev_rgb, np.float32)
COUNTERS = ("prefetch/snapshot_hits", "prefetch/snapshot_misses",
            "prefetch/snapshot_bytes")
EPOCHS3 = -(-3 * N // B)      # draws that cover three epochs
COLD = -(-N // B)             # draws that capture every item


def _jpegs():
    out = []
    for f in sorted(os.listdir(FIXTURE)):
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            out.append(fh.read())
    return out


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two TFRecord shards of 11 records: the fixture's JPEGs, labels
    1..22 (0..21 after the offset), distinct so the order pins join on
    them."""
    root = str(tmp_path_factory.mktemp("snapshot_tfrecords"))
    files = write_shards(root, _jpegs(), list(range(1, N + 1)), shards=2,
                         per_shard=N // 2)
    path_idx, offsets, lengths, labels = _tfrecord_items(files, 1)
    return root, files, list(labels), (path_idx, offsets, lengths)


@pytest.fixture(scope="module")
def loose(tmp_path_factory):
    """22 whole-file JPEG items (the fixture, repeated) for the cases that
    rewrite or delete one source file."""
    root = tmp_path_factory.mktemp("snapshot_jpegs")
    jpegs = _jpegs()
    files = []
    for k in range(N):
        files.append(str(root / f"im{k:02d}.jpg"))
        with open(files[-1], "wb") as f:
            f.write(jpegs[k % len(jpegs)])
    return files, list(range(N))


def _port_cfg(data_dir, cache_dir, capacity=1 << 30, **kw):
    return tcfg.DataConfig(
        name="imagenet", data_dir=data_dir, image_size=SIZE,
        snapshot_cache=tcfg.SnapshotCacheConfig(
            enabled=True, dir=str(cache_dir), capacity_bytes=capacity), **kw)


def _jax_cfg(data_dir, cache_dir, capacity=1 << 30):
    return dataclasses.replace(
        jcfg.DataConfig(), name="imagenet", data_dir=data_dir,
        image_size=SIZE, snapshot_cache=jcfg.SnapshotCacheConfig(
            enabled=True, dir=str(cache_dir), capacity_bytes=capacity))


def _port(files, labels, ranges, cache_dir, *, hflip=False,
          capacity=1 << 30, data_dir=""):
    inner = pjpeg.NativeJpegTrainIterator(
        files, labels, B, SIZE, seed=SEED, mean=MEAN, std=STD,
        image_dtype="uint8", num_threads=2, ranges=ranges, hflip=hflip)
    return psc.wrap_train_iterator(
        inner, _port_cfg(data_dir, cache_dir, capacity), seed=SEED,
        files=files, labels=labels, ranges=ranges)


def _jax(files, labels, ranges, cache_dir, *, hflip=False,
         capacity=1 << 30, data_dir=""):
    inner = jjpeg.NativeJpegTrainIterator(
        files, labels, B, SIZE, seed=SEED, mean=MEAN, std=STD,
        image_dtype="uint8", num_threads=2, ranges=ranges,
        space_to_depth=False, hflip=hflip)
    return jsc.wrap_train_iterator(
        inner, _jax_cfg(data_dir, cache_dir, capacity), seed=SEED,
        files=files, labels=labels, ranges=ranges)


def _draw(it, api="next"):
    if api == "next":
        b = next(it)
        return np.asarray(b["image"]), np.asarray(b["label"])
    images = torch.empty(it.image_shape, dtype=torch.uint8)
    labels = torch.empty((it.batch,), dtype=torch.int32)
    it.next_into(images, labels)
    return images.numpy(), labels.numpy()


def _port_counts():
    reg = get_registry()
    return [reg.counter_value(n, 0) for n in COUNTERS]


def _jax_counts():
    snap = jtelemetry.get_registry().snapshot()
    return [snap.get(n, 0) for n in COUNTERS]


@pytest.fixture
def jax_registry_on():
    """JAX's process-wide registry switched on for a case that compares
    its counters, then given back as it was: a JAX `Trainer` built with
    `telemetry.enabled=false` earlier in the same process switches it off
    and leaves it so."""
    found = (jtelemetry.get_registry().enabled,
             jtelemetry.get_recorder().enabled)
    jtelemetry.configure(enabled=True)
    yield
    jtelemetry.configure(enabled=found[0])
    jtelemetry.get_recorder().enabled = found[1]


def _position(g):
    return int(psc.shuffle_indices(N, SEED, g // N)[g % N])


def _flip_byte(store, idx):
    off, nbytes = store._entries[idx][0], store._entries[idx][1]
    with open(store._pack_path, "r+b") as f:
        f.seek(off + nbytes // 2)
        v = f.read(1)[0]
        f.seek(off + nbytes // 2)
        f.write(bytes([v ^ 0xFF]))


# ------------------------------------------------------------ the mirror
@pytest.mark.parametrize("n", [1, 2, 23, 257])
@pytest.mark.parametrize("seed", [0, 7, 2**63 + 5])
def test_mirror_equals_jax_over_a_grid(n, seed):
    for epoch in (0, 1, 2, 1000):
        np.testing.assert_array_equal(psc.shuffle_indices(n, seed, epoch),
                                      jsc.shuffle_indices(n, seed, epoch))
    for g in (0, 1, n, 3 * n + 1, 2**40):
        assert psc.item_rng_seed(seed, g) == jsc.item_rng_seed(seed, g)
        assert psc._flip_bit(seed, g) == jsc._flip_bit(seed, g)
    assert psc.mix(seed, n) == jsc.mix(seed, n)


def test_mirror_equals_the_port_native_labels(shards):
    _, files, labels, ranges = shards
    it = pjpeg.NativeJpegTrainIterator(files, labels, B, SIZE, seed=SEED,
                                       mean=MEAN, std=STD,
                                       image_dtype="uint8", num_threads=2,
                                       ranges=ranges)
    got = []
    for _ in range(EPOCHS3):
        got.extend(int(x) for x in next(it)["label"])
    it.close()
    assert got == [labels[_position(g)] for g in range(len(got))]


@pytest.mark.parametrize("hflip,dtype,seed,size", [
    (True, "uint8", 0, 224), (False, "uint8", 7, 224),
    (False, "float32", 3, 32), (True, "uint8", 2**40, 64)])
def test_params_key_equals_jax(shards, hflip, dtype, seed, size):
    _, files, labels, _ = shards
    kw = dict(n_items=len(labels), files=files, image_size=size,
              image_dtype=dtype, mean=MEAN, std=STD,
              area_range=(0.08, 1.0), seed=seed, hflip=hflip)
    assert psc.params_key(**kw) == jsc.params_key(pack4=False, **kw)
    assert psc.params_key(**{**kw, "hflip": not hflip}) != \
        psc.params_key(**kw)


# ------------------------------------------------------ cold, then warm
@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("api", ["next", "next_into"])
def test_cold_then_warm_is_byte_equal_to_jax(shards, tmp_path, hflip, api,
                                            jax_registry_on):
    root, files, labels, ranges = shards
    port = _port(files, labels, ranges, tmp_path / "port", hflip=hflip)
    ref = _jax(files, labels, ranges, tmp_path / "jax", hflip=hflip)
    assert isinstance(port, psc.SnapshotCachingTrainIterator)
    p0, j0 = _port_counts(), _jax_counts()
    for b in range(EPOCHS3):
        images, got_labels = _draw(port, api)
        want = next(ref)
        np.testing.assert_array_equal(images, want["image"], err_msg=str(b))
        np.testing.assert_array_equal(got_labels, want["label"])
        assert [int(x) for x in got_labels] == [
            labels[_position(b * B + j)] for j in range(B)]
        assert port.warm == (b >= COLD)
    assert not port._inner_open and not ref._inner_open
    moved = [a - b for a, b in zip(_port_counts(), p0)]
    assert moved == [a - b for a, b in zip(_jax_counts(), j0)]
    assert moved == [(EPOCHS3 - COLD) * B, 0,
                     (EPOCHS3 - COLD) * B * SIZE * SIZE * 3]
    assert port.store.bytes_used == N * SIZE * SIZE * 3
    assert port.decode_errors() == 0
    port.close()
    ref.close()


def test_a_cold_pass_writes_the_store_jax_writes(shards, tmp_path):
    """The same cold stream gives the same pack, byte for byte, and the
    same index, crc32s included."""
    _, files, labels, ranges = shards
    stores = {}
    for name, make in (("port", _port), ("jax", _jax)):
        it = make(files, labels, ranges, tmp_path / name)
        for _ in range(COLD):
            next(it)
        it.close()
        gen, = glob.glob(str(tmp_path / name / "*"))
        with open(os.path.join(gen, "data.pack"), "rb") as f:
            pack = f.read()
        with open(os.path.join(gen, "index.json")) as f:
            stores[name] = (os.path.basename(gen), pack, json.load(f))
    assert stores["port"] == stores["jax"]
    assert len(stores["port"][2]["entries"]) == N


def test_native_batch_io_equals_zlib_and_names_each_failure(tmp_path):
    import zlib
    from distributed_vgg_f_tpu_torch.data import native_snapshot as ns
    from tools import abi_check
    assert abi_check.check_library(REPO, {
        "src": "distributed_vgg_f_tpu_torch/native/snapshot_gather.cc",
        "binding": "distributed_vgg_f_tpu_torch/data/native_snapshot.py",
        "abi_symbol": "dvgg_snapshot_abi_version",
        "abi_constant": "SNAPSHOT_ABI_VERSION"}) == []
    rng = np.random.default_rng(3)
    sizes = [0, 1, 7, 8, 9, 4095, 150528]
    data = rng.integers(0, 256, sum(sizes), dtype=np.uint8)
    starts = np.cumsum([0] + sizes[:-1])
    assert ns.crc32_many(data, starts, sizes, 4).tolist() == [
        zlib.crc32(data[o:o + n]) for o, n in zip(starts, sizes)]
    block = rng.integers(0, 256, (6, 1000), dtype=np.uint8)
    offsets, lengths = [0, 1000, 2500, 5999], [1000, 1500, 7, 1]
    assert ns.crc32_many(block, offsets, lengths, 3).tolist() == [
        zlib.crc32(block.reshape(-1)[o:o + n]) for o, n in zip(offsets,
                                                                lengths)]
    path = str(tmp_path / "pack")
    block.tofile(path)
    crcs = [zlib.crc32(row) for row in block]
    crcs[2] ^= 1
    fd = os.open(path, os.O_RDONLY)
    try:
        for threads in (1, 4):
            dst = np.zeros((4, 1000), np.uint8)
            whys = ns.gather(fd, [5000, 0, 2000, 5500], [1000] * 4,
                             [crcs[5], crcs[0], crcs[2], 0], dst,
                             [0, 1000, 2000, 3000], threads)
            assert whys == [None, None, "payload crc mismatch",
                            "short pack read"]
            assert (dst[:3] == block[[5, 0, 2]]).all()
        with pytest.raises(ValueError, match="outside"):
            ns.gather(fd, [0], [1000], [0], dst, [3500], 1)
        with pytest.raises(ValueError, match="contiguous"):
            ns.gather(fd, [0], [10], [0], dst[:, ::2], [0], 1)
        with pytest.raises(ValueError, match="outside"):
            ns.crc32_many(block, [-1], [10], 1)
    finally:
        os.close(fd)


def test_the_switch_under_concurrent_knob_calls(shards, tmp_path):
    """The autotuner's thread calls the pool's surface while the drawing
    thread closes the loader at the switch: every call returns the pool's
    width or None, never a closed handle's, and the stream is unchanged."""
    import threading
    _, files, labels, ranges = shards
    ref = _jax(files, labels, ranges, tmp_path / "jax")
    port = _port(files, labels, ranges, tmp_path / "port")
    seen, stop = [], threading.Event()

    def knobs():
        n = 1
        while not stop.is_set():
            got = port.set_num_threads(1 + n % 3)
            seen.append((got, port.num_threads(), port.decode_errors()))
            n += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    caller = threading.Thread(target=knobs)
    caller.start()
    try:
        for _ in range(EPOCHS3):
            images, got_labels = _draw(port, "next_into")
            want = next(ref)
            np.testing.assert_array_equal(images, want["image"])
            np.testing.assert_array_equal(got_labels, want["label"])
    finally:
        stop.set()
        caller.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not caller.is_alive()
    assert port.warm and seen and seen[-1] == (None, None, 0)
    assert all(g in (None, 1, 2, 3) and t in (None, 1, 2, 3) and e == 0
               for g, t, e in seen)
    port.close()
    ref.close()


def test_a_store_jax_wrote_serves_the_port_warm(shards, tmp_path):
    _, files, labels, ranges = shards
    ref = _jax(files, labels, ranges, tmp_path)
    for _ in range(COLD):
        next(ref)
    ref.close()
    before = pjpeg.decode_stats()["images"]
    port = _port(files, labels, ranges, tmp_path)
    again = _jax(files, labels, ranges, tmp_path)
    p0 = _port_counts()
    for b in range(2 * COLD):
        images, got_labels = _draw(port, "next_into")
        assert port.warm
        want = next(again)
        np.testing.assert_array_equal(images, want["image"])
        np.testing.assert_array_equal(got_labels, want["label"])
    moved = [a - b for a, b in zip(_port_counts(), p0)]
    assert moved[:2] == [2 * COLD * B, 0]
    assert pjpeg.decode_stats()["images"] == before  # libjpeg never ran
    port.close()
    again.close()


# ------------------------------------------------------ the degradations
def test_a_corrupt_payload_is_one_miss_repaired_to_its_cold_crop(
        shards, tmp_path, jax_registry_on):
    _, files, labels, ranges = shards
    port = _port(files, labels, ranges, tmp_path)
    cold = [_draw(port)[0] for _ in range(COLD)]
    port.close()
    b = COLD                       # the first warm batch: epoch 1's head
    idx = _position(b * B)
    g0 = [g for g in range(COLD * B) if _position(g) == idx][0]
    clean = cold[g0 // B][g0 % B].copy()
    gen = glob.glob(str(tmp_path / "*"))
    assert len(gen) == 1
    shutil.copytree(gen[0], str(tmp_path / "jax" / os.path.basename(gen[0])))
    for root in (tmp_path, tmp_path / "jax"):
        store = psc.SnapshotStore(str(root), os.path.basename(gen[0]),
                                  1 << 30, N)
        _flip_byte(store, idx)
        store.close()
    port = _port(files, labels, ranges, tmp_path)
    ref = _jax(files, labels, ranges, tmp_path / "jax")
    assert port.restore_state(b) and ref.restore_state(b)
    p0, j0 = _port_counts(), _jax_counts()
    images, _ = _draw(port, "next_into")
    want = next(ref)
    np.testing.assert_array_equal(images, want["image"])
    np.testing.assert_array_equal(images[0], clean)
    assert [a - c for a, c in zip(_port_counts(), p0)][:2] == [B - 1, 1]
    assert [a - c for a, c in zip(_jax_counts(), j0)][:2] == [B - 1, 1]
    np.testing.assert_array_equal(port.store.read(idx), clean)  # repaired
    port.close()
    ref.close()


def test_a_source_changed_under_the_cache_is_never_served_stale(loose,
                                                                tmp_path):
    from PIL import Image
    files, labels = list(loose[0]), loose[1]
    victim = str(tmp_path / "victim.jpg")
    shutil.copy2(files[0], victim)
    files[0] = victim
    port = _port(files, labels, None, tmp_path / "cache", hflip=True)
    for _ in range(COLD):
        next(port)
    old = port.store.read(0)
    rng = np.random.default_rng(99)
    Image.fromarray(rng.integers(0, 256, size=(64, 56, 3))
                    .astype(np.uint8)).save(victim, "JPEG", quality=90)
    os.utime(victim, ns=(12345, 12345))
    served = None
    for _ in range(3 * N // B + 2):   # the stat memo refreshes each epoch
        batch = next(port)
        labs = [int(x) for x in batch["label"]]
        if labels[0] in labs and port.warm:
            served = batch["image"][labs.index(labels[0])]
            break
    assert served is not None
    fresh = port.store.read(0)         # repaired from the new bytes
    assert fresh is not None and not np.array_equal(fresh, old)
    assert (np.array_equal(served, fresh)
            or np.array_equal(served, fresh[:, ::-1, :]))
    port.close()


def test_an_unreadable_source_is_mean_filled_and_counted(loose, tmp_path):
    files, labels = list(loose[0]), loose[1]
    victim = str(tmp_path / "gone.jpg")
    shutil.copy2(files[3], victim)
    files[3] = victim
    port = _port(files, labels, None, tmp_path / "cache")
    for _ in range(COLD):
        next(port)
    next(port)          # latch warm first: an eviction before it would
    assert port.warm    # only be captured again by the cold pass
    port.store.evict(3)
    os.unlink(victim)
    served = None
    for _ in range(3 * N // B + 2):
        batch = next(port)
        labs = [int(x) for x in batch["label"]]
        if labels[3] in labs:
            served = batch["image"][labs.index(labels[3])]
            break
    assert served is not None
    fill = np.clip(np.round(MEAN), 0, 255).astype(np.uint8)
    assert np.array_equal(served, np.broadcast_to(fill, served.shape))
    assert port.decode_errors() >= 1
    port.close()


def test_the_capacity_bound_refuses_writes_and_never_turns_warm(shards,
                                                                tmp_path):
    _, files, labels, ranges = shards
    port = _port(files, labels, ranges, tmp_path, capacity=6 * 3072)
    for _ in range(3 * COLD):
        next(port)
    assert not port.store.complete
    assert port.store.rejected_writes > 0
    assert port.store.bytes_used <= 6 * 3072
    assert port._inner_open and not port.warm
    port.close()


def test_stale_generations_go_and_live_ones_stay(tmp_path):
    root = str(tmp_path)
    s1 = psc.SnapshotStore(root, "gen_a", 1 << 20, 4)
    s1.write(0, np.zeros((8, 8, 3), np.uint8), (1, 2, -1, 0))
    s1.close()
    psc.SnapshotStore(root, "gen_live", 1 << 20, 4).close()
    assert os.path.isdir(os.path.join(root, "gen_a"))   # recent: kept
    dead = time.time() - psc.SnapshotStore._EVICT_GRACE_S - 60
    os.utime(os.path.join(root, "gen_a"), (dead, dead))
    psc.SnapshotStore(root, "gen_b", 1 << 20, 4).close()
    assert not os.path.isdir(os.path.join(root, "gen_a"))
    assert os.path.isdir(os.path.join(root, "gen_live"))
    assert os.path.isdir(os.path.join(root, "gen_b"))


def _rank_stream(files, r, cache_dir):
    """Rank r of two: its own shard of `files` behind the cache."""
    path_idx, offsets, lengths, labels = _tfrecord_items([files[r]], 1)
    return _port([files[r]], list(labels), (path_idx, offsets, lengths),
                 cache_dir)


def test_two_ranks_resumed_after_the_grace_keep_both_stores(shards,
                                                            tmp_path):
    """The DP ranks' stores share a root, each under its own key: a resume
    a day later, both ranks opening at once, keeps both (one family),
    while another job's aged generation still goes."""
    _, files, _, _ = shards
    root = tmp_path / "root"
    for r in (0, 1):
        it = _rank_stream(files, r, root)
        for _ in range(-(-(N // 2) // B)):
            next(it)
        assert it.store.complete
        it.close()
    psc.SnapshotStore(str(root), "other_job", 1 << 20, 4,
                      family="another").close()
    gens = sorted(os.listdir(root))
    dead = time.time() - psc.SnapshotStore._EVICT_GRACE_S - 3600
    for g in gens:
        os.utime(root / g, (dead, dead))
    opened, barrier = [None, None], threading.Barrier(2)

    def rank(r):
        barrier.wait()
        opened[r] = _rank_stream(files, r, root)

    workers = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert sorted(os.listdir(root)) == [g for g in gens if g != "other_job"]
    before = _port_counts()
    for it in opened:
        next(it)
        assert it.warm
        it.close()
    hits, misses, _ = [a - b for a, b in zip(_port_counts(), before)]
    assert (hits, misses) == (2 * B, 0)


def test_serving_touches_its_generation_each_epoch(shards, tmp_path):
    _, files, labels, ranges = shards
    it = _port(files, labels, ranges, tmp_path)
    gen = os.path.join(tmp_path, it.store.key)
    dead = time.time() - psc.SnapshotStore._EVICT_GRACE_S - 3600

    def draw_to(b):                   # draws batches up to b, then ages
        while it._pos <= b:
            next(it)
        age = time.time() - os.stat(gen).st_mtime
        os.utime(gen, (dead, dead))
        return age < 600

    first = [b for b in range(12) if b * B // N == 1][0]      # epoch 1
    second = [b for b in range(12) if b * B // N == 2][0]     # epoch 2
    assert draw_to(first - 1)         # the open and epoch 0
    assert draw_to(first)             # epoch 1's first batch: warm
    assert it.warm and not draw_to(second - 1)
    assert draw_to(second)
    it.close()


@pytest.mark.parametrize("change", [
    {"seed": 8}, {"hflip": True}, {"image_size": 64},
    {"image_dtype": "float32"}, {"area_range": (0.5, 1.0)}])
def test_family_key_leaves_out_the_source_set_only(shards, change):
    _, files, labels, _ = shards
    decode = dict(image_size=SIZE, image_dtype="uint8", mean=MEAN, std=STD,
                  area_range=(0.08, 1.0), seed=SEED, hflip=False)
    keys = {psc.params_key(n_items=n, files=fs, **decode)
            for n, fs in ((N, files), (N // 2, files[:1]),
                          (N // 2, files[1:]))}
    assert len(keys) == 3
    assert psc.family_key(**decode) != \
        psc.family_key(**{**decode, **change})


def test_an_unwritable_root_costs_the_cache_not_the_loader(shards, tmp_path,
                                                           caplog):
    _, files, labels, ranges = shards
    blocker = tmp_path / "file"
    blocker.write_bytes(b"x")           # a file where the root should be
    with caplog.at_level(logging.WARNING):
        it = _port(files, labels, ranges, blocker / "root")
    assert isinstance(it, pjpeg.NativeJpegTrainIterator)
    assert "snapshot cache disabled" in caplog.text
    next(it)
    it.close()


# --------------------------------------------------------------- the seek
def test_the_seek_is_o1_cold_and_warm(shards, tmp_path):
    _, files, labels, ranges = shards
    step = 1000
    want = [labels[_position(step * B + j)] for j in range(B)]
    cold = _port(files, labels, ranges, tmp_path)
    before = pjpeg.decode_stats()["images"]
    assert cold.restore_state(step)
    _, got = _draw(cold)
    assert [int(x) for x in got] == want and not cold.warm
    # the native seek: a few batches decoded ahead, not `step` of them
    assert pjpeg.decode_stats()["images"] - before <= 8 * B
    assert not cold.restore_state(0)   # exact only before the first draw
    cold.close()
    port = _port(files, labels, ranges, tmp_path)
    for _ in range(COLD):              # complete the store
        next(port)
    port.close()
    warm = _port(files, labels, ranges, tmp_path)
    ref = _jax(files, labels, ranges, tmp_path)
    before = pjpeg.decode_stats()["images"]
    assert warm.restore_state(step) and ref.restore_state(step)
    images, got = _draw(warm, "next_into")
    assert [int(x) for x in got] == want and warm.warm
    np.testing.assert_array_equal(images, next(ref)["image"])
    assert pjpeg.decode_stats()["images"] == before
    warm.close()
    ref.close()


# --------------------------------------------------- through the feed
def test_next_into_lent_buffers_through_ingest_and_read_ahead(shards,
                                                              tmp_path):
    root, files, labels, ranges = shards
    ingest = ResumableIngest(
        lambda dc: _port(files, labels, ranges, tmp_path), None, seed=SEED,
        batches_per_epoch=N // B)
    host = HostPrefetchIterator(ingest, depth=2, device="cpu")
    feed = DevicePrefetchIterator(host, "cpu", 2)
    ref = _jax(files, labels, ranges, tmp_path / "jax")
    try:
        assert ingest.image_shape == (B, SIZE, SIZE, 3)
        assert ingest.num_threads() == 2
        for b in range(EPOCHS3):
            got = next(feed)
            want = next(ref)
            np.testing.assert_array_equal(got["image"].numpy(),
                                          want["image"])
            np.testing.assert_array_equal(got["label"].numpy(),
                                          want["label"])
        assert ingest.window_receipt(EPOCHS3)["wire"] == "u8"
        blob = ingest.capture_state(EPOCHS3)
        assert blob["source_cursor"] >= EPOCHS3
        # warm: no decode pool left to steer
        assert ingest.num_threads() is None
        assert ingest.set_num_threads(4) is None
        assert ingest.decode_errors() == 0
    finally:
        feed.close()
        host.close()
        ingest.close()
        ref.close()


def test_the_thread_knob_turns_unavailable_at_the_switch(shards, tmp_path):
    _, files, labels, ranges = shards
    ingest = ResumableIngest(
        lambda dc: _port(files, labels, ranges, tmp_path), None, seed=SEED,
        batches_per_epoch=N // B)

    class Depth:
        depth = 2

        def set_depth(self, n):
            self.depth = n
            return n

    stage = Depth()
    tuner = autotune.IngestAutotuner([
        autotune.thread_knob(ingest, min_value=1, max_value=64),
        autotune.host_prefetch_knob(stage, max_value=8)],
        registry=type(get_registry())())
    tuner._settings.update(k_windows=1, cooldown_windows=0)
    images = torch.empty(ingest.image_shape, dtype=torch.uint8)
    labels_t = torch.empty((B,), dtype=torch.int32)
    ingest.next_into(images, labels_t)
    rec = tuner.observe({"verdict": "infeed_bound"})
    assert rec["actuations"][0]["knob"] == "native_threads"
    assert rec["actuations"][0]["to"] == 4 == ingest.num_threads()
    for _ in range(COLD):              # through the switch
        ingest.next_into(images, labels_t)
    assert ingest.num_threads() is None
    rec = tuner.observe({"verdict": "infeed_bound"})
    assert [a["knob"] for a in rec["actuations"]] == ["host_prefetch"]
    threads = tuner.describe()["knobs"][0]
    assert threads["available"] is False
    assert threads["unavailable_reason"] == "apply() refused at runtime"
    assert stage.depth == 3
    ingest.close()


# --------------------------------------------------------------- the fit
def _fit_cfg(data_dir, cache_dir, **extra):
    return tcfg.apply_overrides(tcfg.get_config("vggf_imagenet_dp"), {
        "model.num_classes": "24", "model.compute_dtype": "float32",
        "model.dropout_rate": "0.0", "model.extra.stem_features": "8",
        "model.extra.conv_features": "16", "model.extra.fc_features": "32",
        "data.data_dir": data_dir, "data.image_size": str(SIZE),
        "data.global_batch_size": str(B), "data.num_train_examples": str(N),
        "data.native_threads": "2", "data.augment.mixup_alpha": "0.0",
        "data.snapshot_cache.enabled": "true",
        "data.snapshot_cache.dir": str(cache_dir),
        "optim.reference_batch_size": str(B), "train.seed": str(SEED),
        "train.log_every": "1", **extra})


def _spy(trainer):
    seen = []
    step = trainer.train_step

    def spy(state, batch, seed):
        seen.append(batch["image"].clone())
        return step(state, batch, seed)

    spy.comm_meta = getattr(step, "comm_meta", None)
    trainer.train_step = spy
    return seen


def _made(trainer):
    """The train streams `trainer` builds, in order."""
    made = []
    make = trainer.make_dataset

    def spy(split="train", data_cfg=None):
        made.append(make(split, data_cfg))
        return made[-1]

    trainer.make_dataset = spy
    return made


def _losses(trainer):
    return [r["loss"] for r in trainer.records if r["event"] == "train"]


def test_fit_across_the_switch_resumed_sees_jax_stream_and_fit_losses(
        shards, tmp_path):
    root = shards[0]
    cache = tmp_path / "cache"
    ck = {"train.checkpoint_dir": str(tmp_path / "ck"),
          "train.checkpoint_every_steps": "4"}
    assert _fit_cfg(root, cache).data.augment.owns_hflip
    first = Trainer(_fit_cfg(root, cache, **ck), device="cpu")
    seen, made = _spy(first), _made(first)
    first.fit(num_steps=4)
    first.checkpoints.close()   # its writer thread ends with the run
    assert isinstance(made[0], psc.SnapshotCachingTrainIterator)
    second = Trainer(_fit_cfg(root, cache, **ck), device="cpu")
    seen += _spy(second)
    made_second = _made(second)
    got = second.fit(num_steps=14)
    second.checkpoints.close()
    events = [r["event"] for r in second.records]
    assert "iterator_state_restore" in events
    assert "data_fast_forward" not in events
    assert made_second[0].warm and made_second[0].decode_errors() == 0
    # JAX's iterator over the same (now complete) store: warm from batch 0
    _, files, labels, ranges = shards
    ref = _jax(files, labels, ranges, cache, data_dir=root)
    for b, image in enumerate(seen):
        np.testing.assert_array_equal(image.numpy(), next(ref)["image"],
                                      err_msg=str(b))
    ref.close()
    # the uninterrupted fit over the complete store trains on the same
    # batches; one over a fresh store too, up to the first batch that
    # reaches into epoch 1 while cold (the resumed run served it warm:
    # epoch-0 crops where the cold decoder drew fresh ones, JAX's trade)
    warm = Trainer(_fit_cfg(root, cache), device="cpu")
    want = warm.fit(warm.init_state(), num_steps=14)
    straight = Trainer(_fit_cfg(root, tmp_path / "fresh"), device="cpu")
    straight.fit(straight.init_state(), num_steps=14)
    resumed = _losses(first) + _losses(second)
    assert resumed == _losses(warm)
    assert resumed[:N // B] == _losses(straight)[:N // B]
    for (k, a), b in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_build_dataset_wraps_the_train_stream_only_with_the_cache_on(
        shards, tmp_path):
    root = shards[0]
    on = _port_cfg(root, tmp_path)
    off = dataclasses.replace(on, snapshot_cache=tcfg.SnapshotCacheConfig())
    train = build_dataset(on, "train", seed=SEED)
    plain = build_dataset(off, "train", seed=SEED)
    assert isinstance(train, psc.SnapshotCachingTrainIterator)
    assert isinstance(plain, pjpeg.NativeJpegTrainIterator)
    a, b = next(train), next(plain)
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["label"], b["label"])
    train.close()
    plain.close()
    write_shards(str(tmp_path / "val"), _jpegs()[:4], [1, 2, 3, 4],
                 shards=1, per_shard=4, prefix="validation")
    ev = build_dataset(dataclasses.replace(on, data_dir=str(tmp_path / "val")),
                       "validation")
    assert isinstance(ev, pjpeg.NativeJpegEvalIterator)


def test_the_command_line_runs_the_cache(shards, tmp_path):
    from distributed_vgg_f_tpu_torch import cli
    cache, ck = tmp_path / "cache", tmp_path / "ck"
    argv = ["--config", "vggf_imagenet_dp"]
    for key, value in {
            "model.num_classes": "24", "model.compute_dtype": "float32",
            "model.extra.stem_features": "8",
            "model.extra.conv_features": "16",
            "model.extra.fc_features": "32", "data.data_dir": shards[0],
            "data.image_size": str(SIZE), "data.global_batch_size": str(B),
            "data.num_train_examples": str(N), "data.native_threads": "2",
            "data.snapshot_cache.enabled": "true",
            "data.snapshot_cache.dir": str(cache),
            "optim.reference_batch_size": str(B), "train.steps": "8",
            "train.log_every": "4", "train.checkpoint_dir": str(ck)}.items():
        argv += ["--set", f"{key}={value}"]
    cli.main(argv, device="cpu")
    gens = os.listdir(cache)
    assert len(gens) == 1
    with open(os.path.join(cache, gens[0], "index.json")) as f:
        assert len(json.load(f)["entries"]) == N
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        train = [r for r in map(json.loads, f) if r["event"] == "train"]
    assert [r["step"] for r in train] == [4, 8]

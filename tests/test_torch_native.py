"""The port's native data path (distributed_vgg_f_tpu_torch/data/
native_build.py, native_tfrecord.py, native_jpeg.py, imagenet.py and
`build_dataset`) against the JAX package's on the same TFRecords: the
fixture JPEGs (tests/data/jpeg_fixture) packed by the pure-Python writer
(tools/tfrecord_write.py) into 3 train shards of 12 records and 2
validation shards of 7, once per module (~3 MB). Every comparison is
byte for byte: the two packages compile the same C++ source against the
same libjpeg here, so the u8 and float32 batches, labels and masks must
be identical."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.data import imagenet as jimagenet
from distributed_vgg_f_tpu.data import native_jpeg as jjpeg
from distributed_vgg_f_tpu.data import native_tfrecord as jtfr
from distributed_vgg_f_tpu_torch.config import get_config
from distributed_vgg_f_tpu_torch.data import build_dataset
from distributed_vgg_f_tpu_torch.data import imagenet as pimagenet
from distributed_vgg_f_tpu_torch.data import native_build
from distributed_vgg_f_tpu_torch.data import native_jpeg as pjpeg
from distributed_vgg_f_tpu_torch.data import native_tfrecord as ptfr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import abi_check  # noqa: E402
from tools.tfrecord_write import (example_bytes, record_bytes,  # noqa: E402
                                  write_shards)

FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")
CLASSES, SIZE, BATCH = 10, 48, 8
MEAN = np.asarray((123.7, 116.3, 103.5), np.float32)
STD = np.asarray((58.4, 57.1, 57.4), np.float32)


def _jpegs():
    out = []
    for f in sorted(os.listdir(FIXTURE)):
        with open(os.path.join(FIXTURE, f), "rb") as fh:
            out.append(fh.read())
    return out


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tfrecords")
    jpegs = _jpegs()
    labels = [1 + (7 * k) % CLASSES for k in range(len(jpegs))]
    write_shards(str(root), jpegs, labels, shards=3, per_shard=12)
    write_shards(str(root), jpegs[::-1], labels[::-1], shards=2,
                 per_shard=7, prefix="validation")
    return str(root)


def _files(data_dir, prefix="train"):
    return sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                  if f.startswith(prefix + "-"))


def _items(files):
    path_idx, offsets, lengths, labels = ptfr.index_tfrecords(files)
    return (path_idx, offsets, lengths), (labels - 1).astype(np.int32)


def _train_pair(files, **kw):
    """The port's and JAX's train iterators over the same items."""
    ranges, labels = _items(files)
    args = dict(batch=BATCH, image_size=SIZE, seed=5, mean=MEAN, std=STD,
                ranges=ranges)
    args.update(kw)
    return (pjpeg.NativeJpegTrainIterator(files, labels, **args),
            jjpeg.NativeJpegTrainIterator(files, labels, **args))


def _assert_same(a, b):
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fixture_is_small_and_textured():
    sizes = [os.path.getsize(os.path.join(FIXTURE, f))
             for f in os.listdir(FIXTURE)]
    assert len(sizes) == 16 and sum(sizes) <= 1 << 20
    assert min(sizes) > 20_000  # texture: not a flat field


def test_index_tfrecords_matches_jax(data_dir):
    files = _files(data_dir)
    ours, ref = ptfr.index_tfrecords(files), jtfr.index_tfrecords(files)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(ours[0]) == 36 and set(ours[3]) <= set(range(1, CLASSES + 1))


def test_index_cache_roundtrip(data_dir, tmp_path):
    files = _files(data_dir)
    fresh = ptfr.index_tfrecords(files, cache_dir=str(tmp_path))
    cached = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(cached) == 1
    again = ptfr.index_tfrecords(files, cache_dir=str(tmp_path))
    for a, b in zip(fresh, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("hflip", [True, False])
def test_train_batches_byte_equal_over_epochs(data_dir, threads, hflip):
    """36 items at batch 8: 10 batches run 2+ epochs (the reshuffle at
    each epoch boundary included)."""
    ours, ref = _train_pair(_files(data_dir), image_dtype="uint8",
                            num_threads=threads, hflip=hflip)
    try:
        for _ in range(10):
            _assert_same(next(ours), next(ref))
    finally:
        ours.close()
        ref.close()


def test_train_float32_kind_byte_equal(data_dir):
    ours, ref = _train_pair(_files(data_dir), image_dtype="float32",
                            num_threads=2)
    try:
        for _ in range(3):
            _assert_same(next(ours), next(ref))
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("k", [1, 4, 9])
def test_restore_state_is_the_kth_batch(data_dir, k):
    files = _files(data_dir)
    ours, ref = _train_pair(files, image_dtype="uint8", num_threads=2)
    seeked, _ = _train_pair(files, image_dtype="uint8", num_threads=2)
    try:
        assert seeked.restore_state(k)
        stream = [next(ours) for _ in range(k + 1)]
        got = next(seeked)
        _assert_same(got, stream[k])
        assert ref.restore_state(k)
        _assert_same(got, next(ref))
        assert not seeked.restore_state(0)  # exact only before a draw
    finally:
        for it in (ours, ref, seeked):
            it.close()


def test_next_into_fills_caller_buffers_like_next(data_dir):
    files = _files(data_dir)
    a, _ = _train_pair(files, image_dtype="uint8", num_threads=2)
    b, _ = _train_pair(files, image_dtype="uint8", num_threads=2)
    images = torch.empty(a.image_shape, dtype=torch.uint8)
    labels = torch.empty((BATCH,), dtype=torch.int32)
    try:
        for _ in range(3):
            a.next_into(images, labels)
            want = next(b)
            np.testing.assert_array_equal(images.numpy(), want["image"])
            np.testing.assert_array_equal(labels.numpy(), want["label"])
        with pytest.raises(ValueError, match="next_into needs"):
            a.next_into(images[:1], labels)
        with pytest.raises(ValueError, match="next_into needs"):
            a.next_into(images, labels.long())
    finally:
        a.close()
        b.close()
    assert a.decode_errors() == 0  # final once closed


def test_eval_pass_byte_equal_with_padded_last_batch(data_dir):
    files = _files(data_dir, "validation")
    ranges, labels = _items(files)
    args = dict(batch=BATCH, image_size=SIZE, mean=MEAN, std=STD,
                num_threads=2, ranges=ranges)
    ours = pjpeg.NativeJpegEvalIterator(files, labels, **args)
    ref = jjpeg.NativeJpegEvalIterator(files, labels, **args)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _assert_same(a, b)
    assert got[-1]["valid"].sum() == 14 - BATCH
    assert not got[-1]["image"][got[-1]["valid"].sum():].any()
    _assert_same(ours.padding_batch(), ref.padding_batch())


@pytest.mark.parametrize("shard", [0, 1])
def test_build_dataset_shards_match_jax_native_items(data_dir, shard):
    """The port's build_dataset at num_shards=2 against JAX's
    native_train_items and a NativeJpegTrainIterator built with
    _build_tfrecord_native's arguments (u8 wire, flip owned by the
    device augment, no host packing)."""
    cfg = get_config("vggf_imagenet_dp")
    data = dataclasses.replace(cfg.data, data_dir=data_dir, image_size=SIZE,
                               global_batch_size=2 * BATCH, native_threads=2)
    ours = build_dataset(data, "train", seed=3, num_shards=2,
                         shard_index=shard, num_classes=CLASSES)
    jdata = dataclasses.replace(jcfg.get_config("vggf_imagenet_dp").data,
                                data_dir=data_dir, image_size=SIZE,
                                global_batch_size=2 * BATCH)
    files, labels, ranges = jimagenet.native_train_items(
        jdata, num_shards=2, shard_index=shard)
    ref = jjpeg.NativeJpegTrainIterator(
        files, labels, batch=BATCH, image_size=SIZE, seed=3,
        mean=np.asarray(jdata.mean_rgb, np.float32),
        std=np.asarray(jdata.stddev_rgb, np.float32), image_dtype="uint8",
        num_threads=2, ranges=ranges, space_to_depth=False,
        hflip=not jdata.augment.owns_hflip)
    assert ours.image_dtype == "uint8" and ours.hflip is False
    try:
        for _ in range(4):
            _assert_same(next(ours), next(ref))
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("lib", [
    ("native/jpeg_loader.cc", "native_jpeg.py",
     "dvgg_jpeg_loader_abi_version", "JPEG_ABI_VERSION"),
    ("native/tfrecord_index.cc", "native_tfrecord.py",
     "dvgg_tfrecord_index_abi_version", "TFRECORD_ABI_VERSION")])
def test_abi_check_passes_the_port_bindings(lib):
    src, binding, symbol, const = lib
    cfg = {"src": src,
           "binding": f"distributed_vgg_f_tpu_torch/data/{binding}",
           "abi_symbol": symbol, "abi_constant": const}
    assert abi_check.check_library(REPO, cfg) == []


def test_written_records_parse_in_tf_and_index_alike(tmp_path):
    """The hand-encoded Example and framing: both packages' indexers
    read them the same, the payload CRC verifies, and TensorFlow parses
    them."""
    jpegs = _jpegs()[:3]
    path = tmp_path / "train-00000-of-00001"
    with open(path, "wb") as f:
        for k, j in enumerate(jpegs):
            f.write(record_bytes(example_bytes(j, 1000 - k)))
    ours = ptfr.index_tfrecord(str(path), verify_payload_crc=True)
    ref = jtfr.index_tfrecord(str(path), verify_payload_crc=True)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    raw = path.read_bytes()
    for off, n, j in zip(ours[0], ours[1], jpegs):
        assert raw[off:off + n] == j
    tf = pytest.importorskip("tensorflow")
    feats = {"image/encoded": tf.io.FixedLenFeature([], tf.string),
             "image/class/label": tf.io.FixedLenFeature([], tf.int64)}
    parsed = [tf.io.parse_single_example(r, feats)
              for r in tf.data.TFRecordDataset(str(path))]
    assert [int(p["image/class/label"]) for p in parsed] == [1000, 999, 998]
    assert [p["image/encoded"].numpy() for p in parsed] == jpegs


def test_missing_train_shards_raise_naming_the_layout(tmp_path):
    cfg = dataclasses.replace(get_config("vggf_imagenet_dp").data,
                              data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="train-\\* TFRecord"):
        build_dataset(cfg, "train")


def test_label_below_offset_is_a_layout_error(tmp_path):
    path = tmp_path / "train-00000-of-00001"
    path.write_bytes(record_bytes(example_bytes(_jpegs()[0], 0)))
    cfg = dataclasses.replace(get_config("vggf_imagenet_dp").data,
                              data_dir=str(tmp_path))
    with pytest.raises(pimagenet.DataLayoutError, match="label_offset"):
        build_dataset(cfg, "train")


def test_native_library_is_keyed_by_source_and_flags(monkeypatch):
    """Both libraries live under build/native/<name>-<hash>.so; another
    flag or another CPU gives another path, and the build of a broken
    source raises with the compiler's output instead of falling back."""
    _, link = native_build.jpeg_build_args()
    path = native_build.library_path("tfrecord_index.cc", "libdvgg_tfrecord")
    assert os.path.dirname(path) == native_build.BUILD_DIR
    ptfr.load_native_tfrecord()
    assert os.path.exists(path)
    assert native_build.library_path(
        "tfrecord_index.cc", "libdvgg_tfrecord", ("-DX=1",)) != path
    assert any("libjpeg" in a for a in link)
    # -march=native code is keyed by the CPU it was built for
    monkeypatch.setattr(native_build, "_cpu_flags", lambda: "flags : sse2")
    assert native_build.library_path("tfrecord_index.cc",
                                      "libdvgg_tfrecord") != path
    monkeypatch.setattr(native_build, "_CXX_FLAGS",
                        native_build._CXX_FLAGS + ["-DBROKEN", "-include",
                                                   "/nonexistent.h"])
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        native_build.build_native_lib("tfrecord_index.cc", "broken_probe")

"""ImageNet-1k from TFRecord shards through the native decoder — the
counterpart of the native branch of the JAX package's ``data/imagenet.py``
`build_imagenet` (:271).

`data_dir` holds the standard ``train-*-of-*`` / ``validation-*-of-*``
shards, each record a JPEG (``image/encoded``) and its 1-based label
(``image/class/label``). Each process takes every `num_shards`-th file
from its `shard_index`; the native indexer (data/native_tfrecord.py)
turns the files into JPEG byte ranges and 0-based labels, and the native
decoder (data/native_jpeg.py) reads them:

- train: the endless deterministic stream on the uint8 wire (the device
  finish normalizes, casts and packs), flipped on the host only when the
  device augment does not own the flip, behind the decoded-crop snapshot
  cache when `data.snapshot_cache.enabled` (data/snapshot_cache.py);
- eval: the finite center-crop pass, host-normalized float32, the last
  batch padded and masked.

The imagefolder layout, tf.data and grain are not ported: a `data_dir`
without TFRecord shards raises.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from distributed_vgg_f_tpu_torch.data.native_jpeg import (
    NativeJpegEvalIterator, NativeJpegTrainIterator)
from distributed_vgg_f_tpu_torch.data.native_tfrecord import index_tfrecords
from distributed_vgg_f_tpu_torch.data.snapshot_cache import \
    wrap_train_iterator

#: Where the TFRecord index cache lives.
CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                         "distributed_vgg_f_tpu_torch")


class DataLayoutError(Exception):
    """The dataset itself is broken or misdescribed (e.g. labels below
    label_offset): never a ValueError, so no caller mistakes it for "this
    backend is unavailable"."""


def _shard_files(data_dir: str, split: str, num_shards: int,
                 shard_index: int) -> list:
    prefix = "train" if split == "train" else "validation"
    files = sorted(glob.glob(os.path.join(data_dir, f"{prefix}-*")))
    if not files:
        raise FileNotFoundError(
            f"no {prefix}-* TFRecord shards in data.data_dir={data_dir!r}: "
            "the port reads the TFRecord layout only (the imagefolder "
            "layout is not ported)")
    return files[shard_index::num_shards] if num_shards > 1 else files


def _tfrecord_items(files: list, label_offset: int):
    """(path_idx, offsets, lengths, labels) of TFRecord shards through the
    native indexer, the labels shifted into the 0-based space."""
    path_idx, offsets, lengths, labels64 = index_tfrecords(
        files, cache_dir=CACHE_DIR)
    if len(labels64) == 0:
        raise ValueError("no records with image/encoded found")
    labels = (labels64 - label_offset).astype(np.int32)
    if (labels < 0).any():
        bad = int((labels < 0).sum())
        raise DataLayoutError(
            f"{bad} records have label < label_offset ({label_offset}): "
            "records missing image/class/label, or a wrong label_offset")
    return path_idx, offsets, lengths, labels


def _build_tfrecord_native(cfg, files: list, is_train: bool,
                           local_batch: int, seed: int, label_offset: int):
    """Train: the u8-wire stream, never packed on the host, behind the
    snapshot cache when it is on (JAX `data/imagenet.py:420–432`); eval:
    the float32 center-crop pass, never cached."""
    path_idx, offsets, lengths, labels = _tfrecord_items(files, label_offset)
    common = dict(
        batch=local_batch, image_size=cfg.image_size,
        mean=np.asarray(cfg.mean_rgb, np.float32),
        std=np.asarray(cfg.stddev_rgb, np.float32),
        num_threads=cfg.native_threads or None,
        ranges=(path_idx, offsets, lengths))
    if is_train:
        it = NativeJpegTrainIterator(
            files, labels, seed=seed, image_dtype="uint8",
            hflip=not cfg.augment.owns_hflip, **common)
        return wrap_train_iterator(it, cfg, seed=seed, files=files,
                                   labels=labels,
                                   ranges=(path_idx, offsets, lengths))
    return NativeJpegEvalIterator(files, labels, image_dtype="float32",
                                  **common)


def build_imagenet(cfg, split: str, local_batch: int, *, seed: int = 0,
                   num_shards: int = 1, shard_index: int = 0,
                   label_offset: int = 1):
    """This process's ImageNet iterator for `split` ("train" or eval)."""
    files = _shard_files(cfg.data_dir, split, num_shards, shard_index)
    return _build_tfrecord_native(cfg, files, split == "train", local_batch,
                                  seed, label_offset)


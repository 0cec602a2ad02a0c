"""ctypes bindings for the native TFRecord indexer (native/tfrecord_index.cc)
— the counterpart of the JAX package's ``data/native_tfrecord.py``
(`load_native_tfrecord` :41, `index_tfrecord` :71, `index_tfrecords` :116).

The indexer walks each shard once (framing and a minimal protobuf wire
parse, seeking past the JPEG bytes) and emits the absolute byte range of
every encoded JPEG and its integer label: the ranged items the native
JPEG decoder (data/native_jpeg.py) takes, so training reads JPEGs
straight out of the TFRecord files with no TensorFlow. Index results are
cached as an .npz keyed on every file's (path, size, mtime).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import threading
from typing import Optional, Sequence

import numpy as np

from distributed_vgg_f_tpu_torch.data.native_build import load_abi_checked

log = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I64P = ctypes.POINTER(ctypes.c_int64)

#: Must match dvgg_tfrecord_index_abi_version() in native/tfrecord_index.cc.
TFRECORD_ABI_VERSION = 1


def load_native_tfrecord() -> ctypes.CDLL:
    """The indexer's library, built on first use; raises when it cannot
    be built or has another ABI."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_abi_checked("tfrecord_index.cc", "libdvgg_tfrecord",
                               "dvgg_tfrecord_index_abi_version",
                               TFRECORD_ABI_VERSION)
        lib.dvgg_tfrecord_index_create.restype = ctypes.c_void_p
        lib.dvgg_tfrecord_index_create.argtypes = [ctypes.c_char_p,
                                                   ctypes.c_int]
        lib.dvgg_tfrecord_index_size.restype = ctypes.c_int64
        lib.dvgg_tfrecord_index_size.argtypes = [ctypes.c_void_p]
        lib.dvgg_tfrecord_index_error.restype = ctypes.c_char_p
        lib.dvgg_tfrecord_index_error.argtypes = [ctypes.c_void_p]
        lib.dvgg_tfrecord_index_skipped.restype = ctypes.c_int64
        lib.dvgg_tfrecord_index_skipped.argtypes = [ctypes.c_void_p]
        lib.dvgg_tfrecord_index_fill.restype = None
        lib.dvgg_tfrecord_index_fill.argtypes = [ctypes.c_void_p, _I64P,
                                                 _I64P, _I64P]
        lib.dvgg_tfrecord_index_destroy.restype = None
        lib.dvgg_tfrecord_index_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def index_tfrecord(path: str, *, verify_payload_crc: bool = False):
    """(offsets, lengths, labels) int64 arrays for one TFRecord shard.
    Raises ValueError on malformed or corrupt framing (the length CRC is
    always verified; the payload CRC only when asked, which reads every
    payload byte)."""
    lib = load_native_tfrecord()
    handle = lib.dvgg_tfrecord_index_create(
        path.encode(), int(verify_payload_crc))
    try:
        n = lib.dvgg_tfrecord_index_size(handle)
        if n < 0:
            err = lib.dvgg_tfrecord_index_error(handle).decode()
            raise ValueError(f"indexing {path!r} failed: {err}")
        skipped = lib.dvgg_tfrecord_index_skipped(handle)
        if skipped:
            log.warning("%s: %d records without an image/encoded value "
                        "skipped", path, skipped)
        offsets = np.empty(n, np.int64)
        lengths = np.empty(n, np.int64)
        labels = np.empty(n, np.int64)
        if n:
            lib.dvgg_tfrecord_index_fill(
                handle, offsets.ctypes.data_as(_I64P),
                lengths.ctypes.data_as(_I64P),
                labels.ctypes.data_as(_I64P))
        return offsets, lengths, labels
    finally:
        lib.dvgg_tfrecord_index_destroy(handle)


def _cache_path(cache_dir: str, files: Sequence[str],
                verify_payload_crc: bool) -> str:
    h = hashlib.sha256()
    # the verification level is part of the key: an unverified index must
    # not answer a verify_payload_crc=True request
    h.update(f"crc={int(verify_payload_crc)}|".encode())
    for f in files:
        st = os.stat(f)
        h.update(f.encode())
        h.update(f"|{st.st_size}|{int(st.st_mtime)}|".encode())
    return os.path.join(cache_dir, f"tfrecord_index_{h.hexdigest()[:16]}.npz")


def index_tfrecords(files: Sequence[str], *, cache_dir: str = "",
                    verify_payload_crc: bool = False):
    """Concatenated (path_idx, offsets, lengths, labels) over `files`:
    `path_idx[i]` indexes `files`, and with offsets and lengths these are
    the ranged items of the native JPEG iterators. With `cache_dir` the
    result is cached, keyed on every file's (path, size, mtime)."""
    files = list(files)
    if not files:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    cache = _cache_path(cache_dir, files, verify_payload_crc) \
        if cache_dir else None
    if cache and os.path.exists(cache):
        try:
            z = np.load(cache)
            return (z["path_idx"], z["offsets"], z["lengths"], z["labels"])
        except (OSError, ValueError, KeyError) as e:
            log.warning("unreadable index cache %s (%s); re-indexing",
                        cache, e)
    parts = [index_tfrecord(f, verify_payload_crc=verify_payload_crc)
             for f in files]
    path_idx = np.concatenate([
        np.full(len(off), i, np.int32) for i, (off, _, _) in enumerate(parts)])
    offsets = np.concatenate([p[0] for p in parts])
    lengths = np.concatenate([p[1] for p in parts])
    labels = np.concatenate([p[2] for p in parts])
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        # np.savez appends ".npz" unless the name already ends with it
        tmp = f"{cache}.{os.getpid()}.tmp.npz"
        try:
            np.savez(tmp, path_idx=path_idx, offsets=offsets,
                     lengths=lengths, labels=labels)
            os.replace(tmp, cache)
            _prune_cache(cache_dir)
        except OSError as e:
            log.warning("could not write the index cache %s (%s)", cache, e)
    return path_idx, offsets, lengths, labels


def _prune_cache(cache_dir: str, keep: int = 16) -> None:
    """Keep the newest `keep` index files. Only final names match: another
    process's in-flight temp file is never removed."""
    pat = re.compile(r"^tfrecord_index_[0-9a-f]{16}\.npz$")
    try:
        entries = [os.path.join(cache_dir, f) for f in os.listdir(cache_dir)
                   if pat.match(f)]
        entries.sort(key=os.path.getmtime, reverse=True)
        for path in entries[keep:]:
            os.remove(path)
    except OSError:  # another process pruned first: its pass suffices
        pass

"""ctypes bindings for the native libjpeg decoder (native/jpeg_loader.cc) —
the counterpart of the JAX package's ``data/native_jpeg.py``
(`load_native_jpeg` :114, `_NativeJpegBase` :691,
`NativeJpegTrainIterator` :864, `NativeJpegEvalIterator` :946).

The decoder crops, resizes and (in the float32 kind) normalizes JPEGs in
C++ worker threads, a few batches ahead of the consumer. Items are byte
ranges (`ranges=(path_idx, offsets, lengths)`, from the TFRecord indexer,
data/native_tfrecord.py) or whole files. The library is built from the
repo's source by data/native_build.py; every export is declared here with
its argtypes and restype, so the ABI checker (tools/abi_check.py) holds
this binding to the C source unfiltered.

Two output kinds are reachable: ``"uint8"``, the wire of the training
feed (raw resampled HWC pixels; the device finish normalizes them,
data/device_ingest.py), and ``"float32"`` (host-normalized, the eval
pass). A live loader's `set_num_threads` / `num_threads` are what the
ingest autotuner's thread knob reaches (data/autotune.py). The bf16 host
kind and the decode-tuning calls (SIMD, scaled decode, restart markers
and fan-out, the resize switch, stats, restart re-encoding) are declared
but not wrapped (ROADMAP A14b).

Determinism (train): the batch stream is a pure function of (seed, batch
index) at any thread count, and `restore_state(step)` is an O(1) exact
seek before the first draw. `next_into(images, labels)` decodes the next
batch into caller-owned buffers (a pinned uint8 tensor and an int32
tensor, passed by address): the device prefetcher's path
(data/prefetch.py). ctypes drops the GIL for the native call.

Eval (`NativeJpegEvalIterator`): the deterministic center crop, one
in-order finite pass; the last partial batch arrives zero-padded with a
`valid` mask.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from distributed_vgg_f_tpu_torch.data.native_build import (jpeg_build_args,
                                                           load_abi_checked)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)

#: Must match dvgg_jpeg_loader_abi_version() in native/jpeg_loader.cc.
JPEG_ABI_VERSION = 9

#: The out_kind values of the C ABI the port reaches (1, bf16, is not).
_OUT_KINDS = {"float32": 0, "uint8": 2}


def load_native_jpeg() -> ctypes.CDLL:
    """The decoder's library, built on first use; raises when it cannot be
    built (no libjpeg, a compile error) or has another ABI."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        compile_args, link_args = jpeg_build_args()
        lib = load_abi_checked("jpeg_loader.cc", "libdvgg_jpeg",
                               "dvgg_jpeg_loader_abi_version",
                               JPEG_ABI_VERSION, compile_args=compile_args,
                               link_args=link_args)
        lib.dvgg_jpeg_loader_create.restype = ctypes.c_void_p
        lib.dvgg_jpeg_loader_create.argtypes = [
            ctypes.c_char_p, _I64P, _I32P, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, _F32P, _F32P, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_double]
        lib.dvgg_jpeg_loader_create_ranged.restype = ctypes.c_void_p
        lib.dvgg_jpeg_loader_create_ranged.argtypes = [
            ctypes.c_char_p, _I64P, ctypes.c_int64, _I32P, _I64P, _I64P,
            _I32P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, _F32P, _F32P, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.dvgg_jpeg_loader_next.restype = ctypes.c_int
        lib.dvgg_jpeg_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, _I32P]
        lib.dvgg_jpeg_loader_next_valid.restype = ctypes.c_int
        lib.dvgg_jpeg_loader_next_valid.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, _I32P, _I32P]
        lib.dvgg_jpeg_loader_seek.restype = None
        lib.dvgg_jpeg_loader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.dvgg_jpeg_loader_decode_errors.restype = ctypes.c_int64
        lib.dvgg_jpeg_loader_decode_errors.argtypes = [ctypes.c_void_p]
        lib.dvgg_jpeg_loader_destroy.restype = None
        lib.dvgg_jpeg_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.dvgg_jpeg_decode_single.restype = ctypes.c_int
        lib.dvgg_jpeg_decode_single.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, _F32P, _F32P,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
            ctypes.c_void_p]
        lib.dvgg_jpeg_simd_supported.restype = ctypes.c_int
        lib.dvgg_jpeg_simd_supported.argtypes = []
        lib.dvgg_jpeg_simd_kind.restype = ctypes.c_int
        lib.dvgg_jpeg_simd_kind.argtypes = []
        lib.dvgg_jpeg_set_simd.restype = ctypes.c_int
        lib.dvgg_jpeg_set_simd.argtypes = [ctypes.c_int]
        lib.dvgg_jpeg_profile_ns.restype = None
        lib.dvgg_jpeg_profile_ns.argtypes = [_I64P]
        lib.dvgg_jpeg_profile_reset.restype = None
        lib.dvgg_jpeg_profile_reset.argtypes = []
        lib.dvgg_jpeg_scaled_supported.restype = ctypes.c_int
        lib.dvgg_jpeg_scaled_supported.argtypes = []
        lib.dvgg_jpeg_scaled_kind.restype = ctypes.c_int
        lib.dvgg_jpeg_scaled_kind.argtypes = []
        lib.dvgg_jpeg_set_scaled.restype = ctypes.c_int
        lib.dvgg_jpeg_set_scaled.argtypes = [ctypes.c_int]
        lib.dvgg_jpeg_partial_supported.restype = ctypes.c_int
        lib.dvgg_jpeg_partial_supported.argtypes = []
        lib.dvgg_jpeg_choose_scale.restype = ctypes.c_int
        lib.dvgg_jpeg_choose_scale.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int]
        lib.dvgg_jpeg_decode_stats.restype = None
        lib.dvgg_jpeg_decode_stats.argtypes = [_I64P]
        lib.dvgg_jpeg_decode_stats_reset.restype = None
        lib.dvgg_jpeg_decode_stats_reset.argtypes = []
        lib.dvgg_jpeg_wire_u8_supported.restype = ctypes.c_int
        lib.dvgg_jpeg_wire_u8_supported.argtypes = []
        lib.dvgg_jpeg_wire_u8_kind.restype = ctypes.c_int
        lib.dvgg_jpeg_wire_u8_kind.argtypes = []
        lib.dvgg_jpeg_set_wire_u8.restype = ctypes.c_int
        lib.dvgg_jpeg_set_wire_u8.argtypes = [ctypes.c_int]
        lib.dvgg_jpeg_restart_supported.restype = ctypes.c_int
        lib.dvgg_jpeg_restart_supported.argtypes = []
        lib.dvgg_jpeg_restart_kind.restype = ctypes.c_int
        lib.dvgg_jpeg_restart_kind.argtypes = []
        lib.dvgg_jpeg_set_restart.restype = ctypes.c_int
        lib.dvgg_jpeg_set_restart.argtypes = [ctypes.c_int]
        lib.dvgg_jpeg_restart_fanout.restype = ctypes.c_int
        lib.dvgg_jpeg_restart_fanout.argtypes = []
        lib.dvgg_jpeg_set_restart_fanout.restype = ctypes.c_int
        lib.dvgg_jpeg_set_restart_fanout.argtypes = [ctypes.c_int]
        lib.dvgg_jpeg_restart_stats.restype = None
        lib.dvgg_jpeg_restart_stats.argtypes = [_I64P]
        lib.dvgg_jpeg_restart_stats_reset.restype = None
        lib.dvgg_jpeg_restart_stats_reset.argtypes = []
        lib.dvgg_jpeg_reencode_restart.restype = ctypes.c_int64
        lib.dvgg_jpeg_reencode_restart.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64]
        lib.dvgg_jpeg_resize_supported.restype = ctypes.c_int
        lib.dvgg_jpeg_resize_supported.argtypes = []
        lib.dvgg_jpeg_resize_kind.restype = ctypes.c_int
        lib.dvgg_jpeg_resize_kind.argtypes = []
        lib.dvgg_jpeg_set_resize.restype = ctypes.c_int
        lib.dvgg_jpeg_set_resize.argtypes = [ctypes.c_int]
        lib.dvgg_jpeg_loader_set_threads.restype = ctypes.c_int
        lib.dvgg_jpeg_loader_set_threads.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_int]
        lib.dvgg_jpeg_loader_num_threads.restype = ctypes.c_int
        lib.dvgg_jpeg_loader_num_threads.argtypes = [ctypes.c_void_p]
        lib.dvgg_jpeg_loader_set_hflip.restype = ctypes.c_int
        lib.dvgg_jpeg_loader_set_hflip.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_int]
        lib.dvgg_jpeg_loader_hflip.restype = ctypes.c_int
        lib.dvgg_jpeg_loader_hflip.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def wire_u8_enabled() -> bool:
    """True iff a uint8-kind loader can be created now: compiled in and
    not refused by the DVGGF_WIRE_U8=0 switch the C side reads."""
    return bool(load_native_jpeg().dvgg_jpeg_wire_u8_kind())


def _paths_blob(files: Sequence[str]):
    blob = b"".join(p.encode() for p in files)
    offsets = np.zeros(len(files) + 1, np.int64)
    np.cumsum([len(p.encode()) for p in files], out=offsets[1:])
    return blob, offsets


def _whole_file_ranges(n: int):
    """(path_idx, offsets, lengths) for n whole-file items: one path per
    item, offset < 0 meaning the entire file."""
    return (np.arange(n, dtype=np.int32), np.full(n, -1, np.int64),
            np.zeros(n, np.int64))


class _NativeJpegBase:
    """Handle and buffer plumbing shared by the train and eval iterators.

    `_create_ranged` returns a native handle and tracks it in `_live`;
    `_next_raw` and `_destroy` take it as an argument, so each eval pass
    owns its handle. Every batch `_next_raw` returns is a fresh array the
    caller owns.
    """

    def __init__(self, lib, batch: int, image_size: int, image_dtype: str):
        if image_dtype not in _OUT_KINDS:
            raise ValueError(
                f"image_dtype {image_dtype!r} not one of {sorted(_OUT_KINDS)}")
        self._lib = lib
        self.batch = int(batch)
        self.image_size = int(image_size)
        self._out_kind = _OUT_KINDS[image_dtype]
        self._np_dtype = np.dtype(image_dtype)
        #: the dtype this iterator ships ("uint8": the device finish
        #: normalizes it exactly once)
        self.image_dtype = image_dtype
        self._live: list = []            # open native handles
        self._decode_errors_closed = 0   # counts of destroyed handles

    @property
    def image_shape(self):
        """(B, S, S, 3): the shape of one batch's images."""
        return (self.batch, self.image_size, self.image_size, 3)

    def _create_ranged(self, files, path_idx, offsets, lengths, labels, *,
                       seed, mean, std, num_threads, area_range, eval_mode,
                       finite):
        lib = self._lib
        blob, path_offsets = _paths_blob(files)
        path_idx = np.ascontiguousarray(path_idx, np.int32)
        offsets = np.ascontiguousarray(offsets, np.int64)
        lengths = np.ascontiguousarray(lengths, np.int64)
        labels = np.ascontiguousarray(labels, np.int32)
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        if not num_threads:
            num_threads = max(1, min(8, (os.cpu_count() or 1)))
        handle = lib.dvgg_jpeg_loader_create_ranged(
            blob, path_offsets.ctypes.data_as(_I64P), len(files),
            path_idx.ctypes.data_as(_I32P), offsets.ctypes.data_as(_I64P),
            lengths.ctypes.data_as(_I64P), labels.ctypes.data_as(_I32P),
            len(labels), self.batch, self.image_size, seed,
            mean.ctypes.data_as(_F32P), std.ctypes.data_as(_F32P),
            num_threads, self._out_kind,
            float(area_range[0]), float(area_range[1]),
            int(eval_mode), int(finite), 0)
        if not handle:
            if self._out_kind == _OUT_KINDS["uint8"] \
                    and not wire_u8_enabled():
                raise RuntimeError(
                    "uint8 wire refused by the native library (compiled out "
                    "with -DDVGGF_NO_WIRE_U8, or DVGGF_WIRE_U8=0); the port "
                    "has no host-normalize training wire")
            raise RuntimeError("dvgg_jpeg_loader_create_ranged failed")
        self._live.append(handle)
        return handle

    def _next_into_ptrs(self, handle, images_ptr: int, labels_ptr: int):
        """Decode the next batch into the buffers at the two addresses;
        returns the valid count, or None at the end of a finite stream."""
        valid = ctypes.c_int32(self.batch)
        rc = self._lib.dvgg_jpeg_loader_next_valid(
            handle, ctypes.c_void_p(images_ptr),
            ctypes.cast(ctypes.c_void_p(labels_ptr), _I32P),
            ctypes.byref(valid))
        if rc == 1:
            return None
        if rc != 0:
            raise RuntimeError(f"dvgg_jpeg_loader_next rc={rc}")
        return int(valid.value)

    def _next_raw(self, handle):
        """(images, labels, valid) for the next batch in fresh arrays;
        None at the end of a finite stream."""
        images = np.empty(self.image_shape, self._np_dtype)
        labels = np.empty((self.batch,), np.int32)
        valid = self._next_into_ptrs(handle, images.ctypes.data,
                                     labels.ctypes.data)
        if valid is None:
            return None
        return images, labels, valid

    def _destroy(self, handle) -> None:
        if handle in self._live:
            self._decode_errors_closed += int(
                self._lib.dvgg_jpeg_loader_decode_errors(handle))
            self._lib.dvgg_jpeg_loader_destroy(handle)
            self._live.remove(handle)

    def decode_errors(self) -> int:
        """Corrupt images over this iterator's lifetime (live handles and
        closed passes). The decoder runs ahead of the consumer, so the
        count is final only after `close()` or the end of the stream."""
        live = sum(int(self._lib.dvgg_jpeg_loader_decode_errors(h))
                   for h in self._live)
        return self._decode_errors_closed + live

    def set_num_threads(self, n: int) -> Optional[int]:
        """Resize the live decode worker pool (the autotuner's thread
        knob): growing starts workers that join the item claims at once,
        shrinking retires idle ones before their next claim; the stream is
        byte-identical at any width. Returns the now-active target, or None
        when refused (no live handle, or the resize compiled out or
        switched off: DVGGF_THREAD_RESIZE=0)."""
        if not self._live:
            return None
        rc = -1
        for handle in self._live:
            rc = int(self._lib.dvgg_jpeg_loader_set_threads(handle, int(n)))
        return None if rc < 0 else rc

    def num_threads(self) -> Optional[int]:
        """The worker-count target, or None with no live handle."""
        if not self._live:
            return None
        rc = int(self._lib.dvgg_jpeg_loader_num_threads(self._live[-1]))
        return None if rc < 0 else rc

    def close(self) -> None:
        for handle in list(getattr(self, "_live", [])):
            self._destroy(handle)

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


class NativeJpegTrainIterator(_NativeJpegBase):
    """Endless deterministic train iterator over JPEG items: random-resized
    crops, flipped on the host only with `hflip=True`. Yields
    ``{"image": (B, S, S, 3) uint8|float32, "label": (B,) int32}`` in fresh
    arrays, or decodes into caller-owned buffers with `next_into`.
    `restore_state(step)` seeks to "next batch = step" in O(1)."""

    supports_state = True

    def __init__(self, files: Sequence[str], labels: Sequence[int],
                 batch: int, image_size: int, *, seed: int,
                 mean: np.ndarray, std: np.ndarray,
                 image_dtype: str = "float32",
                 num_threads: int | None = None,
                 area_range=(0.08, 1.0),
                 ranges=None,
                 hflip: bool = True):
        if not len(files):
            raise ValueError("empty file list")
        super().__init__(load_native_jpeg(), batch, image_size, image_dtype)
        if ranges is None:
            if len(labels) != len(files):
                raise ValueError("labels must match files")
            path_idx, offsets, lengths = _whole_file_ranges(len(files))
        else:
            path_idx, offsets, lengths = ranges
            if not (len(path_idx) == len(offsets) == len(lengths)
                    == len(labels)):
                raise ValueError("ranges/labels length mismatch")
        self._handle = self._create_ranged(
            files, path_idx, offsets, lengths, labels, seed=seed, mean=mean,
            std=std, num_threads=num_threads, area_range=area_range,
            eval_mode=0, finite=0)
        #: flip ownership: False when the device augment owns the flip.
        #: Set right after create, before the native workers start on
        #: the first draw.
        self.hflip = bool(hflip)
        if not self.hflip:
            rc = int(self._lib.dvgg_jpeg_loader_set_hflip(self._handle, 0))
            if rc != 0:
                raise RuntimeError(
                    f"dvgg_jpeg_loader_set_hflip refused (rc={rc})")
        self._started = False

    def restore_state(self, step: int) -> bool:
        if self._started:
            return False  # a seek is exact only before the first draw
        self._lib.dvgg_jpeg_loader_seek(self._handle, int(step))
        return True

    def __iter__(self):
        return self

    def __next__(self):
        self._started = True
        images, labels, _ = self._next_raw(self._handle)
        return {"image": images, "label": labels}

    def next_into(self, images, labels) -> None:
        """Decode the next batch into `images`, a C-contiguous CPU tensor of
        shape `image_shape` and this iterator's dtype (pinned, for the
        device prefetcher), and `labels`, a C-contiguous (B,) int32 CPU
        tensor."""
        import torch
        want = getattr(torch, self.image_dtype)
        for t, shape, dtype in ((images, self.image_shape, want),
                                (labels, (self.batch,), torch.int32)):
            if tuple(t.shape) != shape or t.dtype != dtype \
                    or t.device.type != "cpu" or not t.is_contiguous():
                raise ValueError(
                    f"next_into needs a contiguous CPU {dtype} tensor of "
                    f"shape {shape}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
        self._started = True
        self._next_into_ptrs(self._handle, images.data_ptr(),
                             labels.data_ptr())


class NativeJpegEvalIterator(_NativeJpegBase):
    """One finite in-order eval pass: the deterministic center crop, no
    flip. Yields ``{"image", "label", "valid"}`` with `valid` a (B,) bool
    mask: the last partial batch is zero-padded and masked. Each `iter()`
    starts a new pass on a handle of its own."""

    is_finite = True

    def __init__(self, files: Sequence[str], labels: Sequence[int],
                 batch: int, image_size: int, *,
                 mean: np.ndarray, std: np.ndarray,
                 image_dtype: str = "float32",
                 num_threads: int | None = None,
                 ranges=None):
        if not len(files):
            raise ValueError("empty file list")
        super().__init__(load_native_jpeg(), batch, image_size, image_dtype)
        self._files = list(files)
        self._labels = list(labels)
        self._mean = np.ascontiguousarray(mean, np.float32)
        self._std = np.ascontiguousarray(std, np.float32)
        self._num_threads = num_threads
        self._ranges = ranges

    def __iter__(self):
        if self._ranges is None:
            path_idx, offsets, lengths = _whole_file_ranges(len(self._files))
        else:
            path_idx, offsets, lengths = self._ranges
        handle = self._create_ranged(
            self._files, path_idx, offsets, lengths, self._labels, seed=0,
            mean=self._mean, std=self._std, num_threads=self._num_threads,
            area_range=(1.0, 1.0), eval_mode=1, finite=1)
        try:
            while True:
                out = self._next_raw(handle)
                if out is None:
                    break
                images, labels, valid = out
                mask = np.zeros((self.batch,), bool)
                mask[:valid] = True
                yield {"image": images, "label": labels, "valid": mask}
        finally:
            self._destroy(handle)

    def padding_batch(self):
        """An all-invalid batch, for hosts whose shards run out first."""
        return {"image": np.zeros(self.image_shape, self._np_dtype),
                "label": np.zeros((self.batch,), np.int32),
                "valid": np.zeros((self.batch,), np.bool_)}

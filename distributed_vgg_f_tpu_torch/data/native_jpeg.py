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
kind is declared but not reachable (ROADMAP A17).

The decoder's tuning surface (JAX `data/native_jpeg.py:229–676`), all
process-wide switches of the one library: the resample path
(`simd_kind`/`set_simd`), DCT-scaled and partial decode (`scaled_kind`,
`set_scaled`, `partial_supported`, and `expected_scale_denom`, the mirror
of the native scale chooser), the restart-marker excerpt decode and its
intra-image fan-out (`restart_kind`, `set_restart`, `restart_fanout`,
`set_restart_fanout`, `restart_stats`), the receipts (`decode_stats`,
`decode_profile`), the lossless restart-marker transcode
(`reencode_restart`) and the stateless one-image decode
(`decode_single_image`, the snapshot cache's repair path,
data/snapshot_cache.py). JAX's build-support probes (`scaled_supported`,
`restart_supported`, `thread_resize_supported`), its pool-resize switch
(`thread_resize_enabled`, `set_thread_resize`) and `choose_scale` are
declared below but not wrapped: nothing in the port calls them.

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


_SIMD_KINDS = {0: "scalar", 1: "avx2"}


def simd_kind() -> str:
    """The resample path the decoder dispatches to ('scalar' | 'avx2'); the
    initial value honours cpuid and the DVGGF_DECODE_SIMD=0 switch."""
    return _SIMD_KINDS.get(int(load_native_jpeg().dvgg_jpeg_simd_kind()),
                           "unknown")


def set_simd(enabled: bool) -> str:
    """Force the resample path (False: scalar; True: SIMD where the CPU has
    it); returns the now-active kind."""
    return _SIMD_KINDS.get(
        int(load_native_jpeg().dvgg_jpeg_set_simd(int(enabled))), "unknown")


_SCALED_KINDS = {0: "full", 1: "scaled"}

#: The power-of-two scale_num candidates (over a denominator of 8) the
#: native chooser draws from: libjpeg-turbo has SIMD IDCTs only for these
#: output sizes.
SCALE_CANDIDATES = (1, 2, 4, 8)


def expected_scale_denom(crop_w: int, crop_h: int, out_size: int) -> int:
    """Mirror of the native scale chooser (`dvgg_jpeg_choose_scale`): the
    smallest M of SCALE_CANDIDATES whose M/8-scaled crop still covers
    `out_size` in both dims (floor), else 8, so the resample never
    upscales pixels a smaller DCT scale threw away."""
    for m in SCALE_CANDIDATES:
        if (crop_w * m) // 8 >= out_size and (crop_h * m) // 8 >= out_size:
            return m
    return 8


def scaled_kind() -> str:
    """The decode strategy dispatched to ('full' | 'scaled'); the initial
    value honours the DVGGF_DECODE_SCALED=0 switch."""
    return _SCALED_KINDS.get(int(load_native_jpeg().dvgg_jpeg_scaled_kind()),
                             "unknown")


def set_scaled(enabled: bool) -> str:
    """Force the decode strategy (False: full resolution; True: DCT-scaled
    + partial where compiled in); returns the now-active kind."""
    return _SCALED_KINDS.get(
        int(load_native_jpeg().dvgg_jpeg_set_scaled(int(enabled))),
        "unknown")


def partial_supported() -> bool:
    """Whether the running libjpeg has the turbo-only partial decode
    (jpeg_crop_scanline + jpeg_skip_scanlines, probed with dlsym); without
    it the scaled path decodes whole rows and discards, the same pixels."""
    return bool(load_native_jpeg().dvgg_jpeg_partial_supported())


_RESTART_KINDS = {0: "sequential", 1: "restart"}


def restart_kind() -> str:
    """The entropy-decode strategy dispatched to ('sequential' |
    'restart'); the initial value honours DVGGF_DECODE_RESTART=0. 'restart'
    engages per image, only on streams with usable RSTn markers
    (`restart_stats()['marker_absent']` counts the others)."""
    return _RESTART_KINDS.get(
        int(load_native_jpeg().dvgg_jpeg_restart_kind()), "unknown")


def set_restart(enabled: bool) -> str:
    """Force the entropy strategy (False: sequential; True: restart
    excerpts where compiled in); returns the now-active kind. The pixels
    are the same either way."""
    return _RESTART_KINDS.get(
        int(load_native_jpeg().dvgg_jpeg_set_restart(int(enabled))),
        "unknown")


def restart_fanout() -> int:
    """The intra-image fan-out width (1: none); the initial value honours
    DVGGF_RESTART_FANOUT."""
    return int(load_native_jpeg().dvgg_jpeg_restart_fanout())


def set_restart_fanout(width: int) -> int:
    """How many entropy chunks of one image's crop band decode at once
    (clamped to [1, 64]); returns the now-active width. Fan-out trades
    cores for one image's latency; width 1 serves throughput."""
    return int(load_native_jpeg().dvgg_jpeg_set_restart_fanout(int(width)))


#: Field order of dvgg_jpeg_restart_stats.
_RESTART_STAT_FIELDS = (
    "images", "marker_absent", "unsupported", "misaligned", "scan_failures",
    "excerpt_fallbacks", "segments_used", "segments_skipped",
    "fanout_images", "fanout_width_max", "chunk_jobs_pooled", "no_gain")


def restart_stats(reset: bool = False) -> dict:
    """Process-wide restart-path receipts since load (or the last reset):
    images decoded through excerpts, the fallbacks by cause, entropy
    segments decoded and skipped, fan-out accounting, and `no_gain`
    (the band needed every segment)."""
    lib = load_native_jpeg()
    buf = (ctypes.c_int64 * 16)()
    lib.dvgg_jpeg_restart_stats(buf)
    if reset:
        lib.dvgg_jpeg_restart_stats_reset()
    return {k: int(buf[i]) for i, k in enumerate(_RESTART_STAT_FIELDS)}


def reencode_restart(data: bytes, interval_mcus: int = 0) -> Optional[bytes]:
    """Transcode one JPEG losslessly so its entropy stream carries a
    restart marker every `interval_mcus` MCUs (0: one each MCU row, the
    layout the excerpt decoder engages on). A coefficient-domain copy: the
    decoded pixels are the source's (a progressive source becomes baseline).
    None when the source does not decode."""
    lib = load_native_jpeg()
    data = bytes(data)
    cap = len(data) + len(data) // 2 + 65536
    for _ in range(2):
        buf = ctypes.create_string_buffer(cap)
        rc = int(lib.dvgg_jpeg_reencode_restart(data, len(data),
                                                int(interval_mcus), buf, cap))
        if rc > 0:
            return buf.raw[:rc]
        if rc == -1:
            return None
        if rc == -2:
            raise ValueError("bad reencode_restart arguments")
        cap = -rc  # the buffer was short: rc names the size it needs
    raise RuntimeError("reencode_restart did not converge on a buffer size")


def decode_stats(reset: bool = False) -> dict:
    """Process-wide decode receipts since load (or the last reset): images,
    the chosen-scale histogram {scale_num: count}, scanlines skipped above
    and truncated below the crop, the decode-buffer pool's hits, misses and
    hit rate, images through the partial path, and full-decode fallbacks."""
    lib = load_native_jpeg()
    buf = (ctypes.c_int64 * 16)()
    lib.dvgg_jpeg_decode_stats(buf)
    if reset:
        lib.dvgg_jpeg_decode_stats_reset()
    hits, misses = int(buf[11]), int(buf[12])
    return {
        "images": int(buf[0]),
        "scale_histogram": {m: int(buf[m]) for m in range(1, 9)
                            if int(buf[m])},
        "rows_skipped": int(buf[9]),
        "rows_truncated": int(buf[10]),
        "pool_hits": hits,
        "pool_misses": misses,
        "pool_hit_rate": (hits / (hits + misses)
                          if hits + misses else None),
        "partial_images": int(buf[13]),
        "full_fallbacks": int(buf[14]),
    }


def decode_profile(reset: bool = False) -> dict:
    """Process-wide split of successful decodes since load (or the last
    reset): {'jpeg_s', 'resample_s', 'images'}, libjpeg's entropy + IDCT
    seconds against the resample kernels', summed over worker threads."""
    lib = load_native_jpeg()
    buf = (ctypes.c_int64 * 3)()
    lib.dvgg_jpeg_profile_ns(buf)
    if reset:
        lib.dvgg_jpeg_profile_reset()
    return {"jpeg_s": buf[0] / 1e9, "resample_s": buf[1] / 1e9,
            "images": int(buf[2])}


def decode_single_image(data: bytes, out_size: int, mean, std, *,
                        image_dtype: str = "float32", eval_mode: bool = False,
                        area_range=(0.08, 1.0), rng_seed: int = 0,
                        hflip: bool = True, out=None):
    """One image through the batch loader's crop, resize and (float32)
    normalize (dvgg_jpeg_decode_single), stateless: the decoded (S, S, 3)
    array, or None when the JPEG does not decode. `rng_seed` is the item's
    decode RNG seed (the train crop and flip); `hflip=False` gives the crop
    of a stream whose flip the device owns (the flip bit is drawn either
    way, so the crop is the same). `out`, a C-contiguous array of that
    shape and dtype, is decoded into and returned. The host never packs:
    space-to-depth belongs to the device finish."""
    lib = load_native_jpeg()
    if image_dtype not in _OUT_KINDS:
        raise ValueError(
            f"image_dtype {image_dtype!r} not one of {sorted(_OUT_KINDS)}")
    shape = (out_size, out_size, 3)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if out is None:
        out = np.empty(shape, image_dtype)
    else:
        if tuple(out.shape) != shape:
            raise ValueError(f"out shape {out.shape} != {shape}")
        if out.dtype != np.dtype(image_dtype):
            raise ValueError(f"out dtype {out.dtype} != {image_dtype}")
        if not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous")
    rc = lib.dvgg_jpeg_decode_single(
        bytes(data), len(data), int(out_size),
        mean.ctypes.data_as(_F32P), std.ctypes.data_as(_F32P),
        _OUT_KINDS[image_dtype], 0, int(eval_mode), int(hflip),
        float(area_range[0]), float(area_range[1]), int(rng_seed),
        out.ctypes.data_as(ctypes.c_void_p))
    if rc == 1:
        return None
    if rc != 0:
        if image_dtype == "uint8" and not wire_u8_enabled():
            raise RuntimeError(
                "uint8 wire refused by the native library (compiled out "
                "with -DDVGGF_NO_WIRE_U8, or DVGGF_WIRE_U8=0)")
        raise RuntimeError(f"dvgg_jpeg_decode_single rc={rc}")
    return out


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

"""ctypes bindings for the snapshot cache's batch I/O
(distributed_vgg_f_tpu_torch/native/snapshot_gather.cc), built by
data/native_build.py from the port's own native source: a warm batch's
payloads read from the store's pack into the caller's buffer with their
crc32s checked (`gather`), and the crc32s of the items a cold batch
captures or a repair writes (`crc32_many`), each one call a batch over
`threads` threads,
during which ctypes holds no interpreter lock. crc32 is zlib's. Every
export is declared here with its argtypes and restype, so the ABI checker
(tools/abi_check.py) holds this binding to the C source."""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from distributed_vgg_f_tpu_torch.data.native_build import (PORT_NATIVE_DIR,
                                                           load_abi_checked)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)

#: Must match dvgg_snapshot_abi_version() in native/snapshot_gather.cc.
SNAPSHOT_ABI_VERSION = 1

#: `gather`'s per-item status codes.
GOOD, SHORT_READ, CRC_MISMATCH, IO_ERROR = 0, 1, 2, 3
_WHY = {SHORT_READ: "short pack read", CRC_MISMATCH: "payload crc mismatch",
        IO_ERROR: "pack read failed"}


def load_native_snapshot() -> ctypes.CDLL:
    """The batch I/O library, built on first use; raises when it cannot be
    built or has another ABI."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_abi_checked("snapshot_gather.cc", "libdvgg_snapshot",
                               "dvgg_snapshot_abi_version",
                               SNAPSHOT_ABI_VERSION, src_dir=PORT_NATIVE_DIR)
        lib.dvgg_snapshot_crc32_many.restype = None
        lib.dvgg_snapshot_crc32_many.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, _I64P, _I64P, _I64P,
            ctypes.c_int32]
        lib.dvgg_snapshot_gather.restype = ctypes.c_int64
        lib.dvgg_snapshot_gather.argtypes = [
            ctypes.c_int32, ctypes.c_int64, _I64P, _I64P, _I64P, _I64P,
            ctypes.c_void_p, ctypes.c_int32, _I32P]
        _lib = lib
        return _lib


def _i64(values) -> np.ndarray:
    return np.ascontiguousarray(values, np.int64)


def _check_buffer(arr: np.ndarray, offsets, lengths, what: str) -> None:
    if not arr.flags.c_contiguous:
        raise ValueError(f"the {what} must be C-contiguous")
    if len(offsets) and (int(offsets.min()) < 0 or int(lengths.min()) < 0
                         or int((offsets + lengths).max()) > arr.nbytes):
        raise ValueError(f"a range runs outside the {what}")


def crc32_many(base: np.ndarray, offsets, lengths, threads: int) -> np.ndarray:
    """zlib.crc32 of each (offset, length) byte range of the C-contiguous
    array `base`, as an int64 array."""
    offsets, lengths = _i64(offsets), _i64(lengths)
    _check_buffer(base, offsets, lengths, "buffer")
    out = np.empty(len(offsets), np.int64)
    load_native_snapshot().dvgg_snapshot_crc32_many(
        base.ctypes.data, len(offsets), offsets.ctypes.data_as(_I64P),
        lengths.ctypes.data_as(_I64P), out.ctypes.data_as(_I64P),
        int(threads))
    return out


def gather(fd: int, offsets, lengths, crcs, dst: np.ndarray, dst_offsets,
           threads: int) -> list:
    """Read each item's `lengths` bytes at `offsets` of the file `fd` into
    the C-contiguous array `dst` at `dst_offsets` and check its crc32
    against `crcs`; the reason each item is not good, or None for a good
    one."""
    offsets, lengths = _i64(offsets), _i64(lengths)
    crcs, dst_offsets = _i64(crcs), _i64(dst_offsets)
    _check_buffer(dst, dst_offsets, lengths, "batch buffer")
    status = np.empty(len(offsets), np.int32)
    load_native_snapshot().dvgg_snapshot_gather(
        int(fd), len(offsets), offsets.ctypes.data_as(_I64P),
        lengths.ctypes.data_as(_I64P), crcs.ctypes.data_as(_I64P),
        dst_offsets.ctypes.data_as(_I64P), dst.ctypes.data, int(threads),
        status.ctypes.data_as(_I32P))
    return [_WHY.get(int(s)) for s in status]

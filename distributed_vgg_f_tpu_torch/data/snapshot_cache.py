"""Decoded-crop snapshot cache behind the native train stream — the port's
own copy of the JAX package's ``data/snapshot_cache.py`` (the tf.data
paper's cache/snapshot move, arXiv 2101.12127).

The first pass over the dataset runs the native decoder and writes each
item's crop, exactly the bytes the loader shipped (raw uint8 HWC on the
u8 wire), into a bounded on-disk store keyed by the source set, the
decode parameters and the native ABI (`params_key`). Once every item is
in the store the iterator turns WARM: it closes the native loader and
assembles each batch from the store, so libjpeg never runs again; a store
left complete by an earlier run serves warm from batch 0. Opt-in
(`data.snapshot_cache.enabled`): warm epochs re-serve the first pass's
crop geometry, so training is not bit-comparable to the uncached stream.

Flip ownership: with the device augment owning the flip (the inner
loader's `hflip` False) the cold pass captures unflipped crops, the warm
path never redraws a flip, and the repair decodes flips-disabled; with
the host owning it, each warm item is flipped afresh by `_flip_bit` of
(seed, position). `params_key` keys on it, so no run serves the other's
crops.

Order: warm batches follow the native stream's per-epoch shuffle bit for
bit (`shuffle_indices` mirrors native/jpeg_loader.cc's SplitMix64), so
labels and store keys line up and `restore_state(step)` stays an O(1)
seek in either phase.

The port's feed draws through `next_into(images, labels)` into buffers
the host read-ahead lends onward (data/prefetch.py). Cold, the wrapper
forwards to the loader's `next_into` and captures from the filled buffer
before it returns: one crc32 call for the batch's new items and one
append for each run of them. Warm, it reads each item's payload straight
into its place in the caller's buffer and checks its crc32 there: no
per-item temporary and no second copy. Both batch calls are the port's
native batch I/O (data/native_snapshot.py), which runs a batch's items
over `BATCH_IO_THREADS` threads while the interpreter lock is free: a Python
loop that released the lock per item (for each pread and each crc32) had
to win it back twice an item from the training thread. Store bookkeeping,
repairs and counters stay on the drawing thread, in position order.

Degradation: a warm item that is missing, fails its crc32, has a source
whose stat drifted (size, mtime, range) or a stale layout is a miss: it is
decoded again through `decode_single_image` with the mirrored item RNG
(the same epoch-0 crop, written back to the store), and filled as a
corrupt image (the mean on the u8 wire) only when that decode fails too.
Never stale pixels.

Counters: `prefetch/snapshot_hits`, `prefetch/snapshot_misses` and
`prefetch/snapshot_bytes` (payload bytes served from the store;
telemetry/registry.py `SNAPSHOT_COUNTERS`).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from distributed_vgg_f_tpu_torch.data import native_snapshot
from distributed_vgg_f_tpu_torch.data.native_jpeg import (
    JPEG_ABI_VERSION, _whole_file_ranges, decode_single_image)
from distributed_vgg_f_tpu_torch.telemetry import get_registry
from distributed_vgg_f_tpu_torch.telemetry.registry import SNAPSHOT_COUNTERS

log = logging.getLogger(__name__)

_MASK = (1 << 64) - 1

#: Threads the native batch I/O runs one batch's items over: a warm
#: batch's reads and crc checks, a cold batch's crc32s.
BATCH_IO_THREADS = max(1, min(8, os.cpu_count() or 1))


# ------------------------------------------------------------ the RNG mirror
# Exact mirrors of native/jpeg_loader.cc's SplitMix64, mix and
# shuffle_indices: warm batches join labels and store keys on them.

class SplitMix64:
    __slots__ = ("s",)

    def __init__(self, seed: int):
        self.s = seed & _MASK

    def next(self) -> int:
        self.s = (self.s + 0x9E3779B97F4A7C15) & _MASK
        z = self.s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        return z ^ (z >> 31)


def mix(a: int, b: int) -> int:
    r = SplitMix64((a * 0x9E3779B97F4A7C15 + b) & _MASK)
    r.next()
    return r.next()


def shuffle_indices(n: int, seed: int, epoch: int) -> np.ndarray:
    """The native loader's epoch shuffle, index for index."""
    idx = np.arange(n, dtype=np.int64)
    r = SplitMix64(mix(seed, (0x5EED + epoch) & _MASK))
    for i in range(n - 1, 0, -1):
        j = r.next() % (i + 1)
        idx[i], idx[j] = idx[j], idx[i]
    return idx


def item_rng_seed(seed: int, g: int) -> int:
    """The decode RNG seed of global item g: what the native worker hands
    its decode, and what a repair must use to reproduce the cached crop."""
    return mix(seed, (0xA0A0 + g) & _MASK)


def _flip_bit(seed: int, g: int) -> bool:
    """Warm serving's fresh flip draw for position g while the host owns
    the flip; its own tag, apart from the crop RNG's."""
    return bool(mix(seed, (0xF11F00 + g) & _MASK) & 1)


# ---------------------------------------------------------- the item source

def read_item_bytes(files: Sequence[str], path_idx, offsets, lengths,
                    idx: int) -> Optional[bytes]:
    """Item idx's source bytes (offset < 0: the whole file), or None on any
    I/O failure."""
    try:
        with open(files[int(path_idx[idx])], "rb") as f:
            off = int(offsets[idx])
            if off < 0:
                return f.read()
            f.seek(off)
            return f.read(int(lengths[idx]))
    except OSError:
        return None


def corrupt_fill(out: np.ndarray, image_dtype: str, mean) -> None:
    """The corrupt-image fill of each wire: the mean on u8 (about zero
    after the device finish), zeros on the host wires."""
    if image_dtype == "uint8":
        out[...] = np.clip(np.round(np.asarray(mean, np.float32)), 0, 255) \
            .astype(np.uint8).reshape(1, 1, 3)
    else:
        out[...] = 0


class SourceStatMemo:
    """(file size, mtime_ns, offset, length) fingerprints, each file
    stat'ed once an epoch: a payload swapped on disk is noticed at the next
    epoch boundary."""

    def __init__(self, files: Sequence[str], path_idx, offsets, lengths):
        self._files = files
        self._path_idx = path_idx
        self._offsets = offsets
        self._lengths = lengths
        self._memo: dict = {}
        self._epoch = -1

    def fingerprint(self, idx: int, epoch: int) -> tuple:
        if epoch != self._epoch:
            self._memo.clear()
            self._epoch = epoch
        p = int(self._path_idx[idx])
        st = self._memo.get(p)
        if st is None:
            try:
                s = os.stat(self._files[p])
                st = (s.st_size, s.st_mtime_ns)
            except OSError:
                st = (-1, -1)
            self._memo[p] = st
        return (st[0], st[1], int(self._offsets[idx]),
                int(self._lengths[idx]))

    @property
    def epoch(self) -> int:
        return self._epoch


# ----------------------------------------------------------------- the store

class SnapshotStore:
    """One generation of the snapshot: <root>/<key>/data.pack (every
    payload, appended) and <root>/<key>/index.json (each item's offset,
    length, zlib crc32, dtype, shape and source fingerprint), JAX's layout:
    a store either package wrote serves the other. Serving an item costs
    one pread and one crc pass.

    Eviction at open: a generation whose key is not this store's goes when
    no store touched its directory for `_EVICT_GRACE_S` and it is not of
    this store's `family` (<root>/<key>/family, `family_key`: the same
    decode parameters over another source set, which is another DP rank's
    shard of one job, never stale for this one). The iterator touches its
    generation at every epoch boundary, so a live one stays young.
    Evicting an item drops its index entry; its pack bytes stay inside the
    capacity accounting. The index is replaced atomically every
    `_FLUSH_EVERY` admissions and at `flush()`, so a crash leaves a valid
    prefix (the next cold pass captures the rest)."""

    _FLUSH_EVERY = 256
    #: Foreign generations younger than this survive a store's open: under
    #: a shared root each job's store has its own key.
    _EVICT_GRACE_S = 24 * 3600

    def __init__(self, root: str, key: str, capacity_bytes: int,
                 n_items: int, *, family: str = ""):
        self.root = root
        self.key = key
        self.family = family
        self.capacity_bytes = int(capacity_bytes)
        self.n_items = int(n_items)
        self.rejected_writes = 0
        self._dir = os.path.join(root, key)
        os.makedirs(self._dir, exist_ok=True)
        self._pack_path = os.path.join(self._dir, "data.pack")
        self._index_path = os.path.join(self._dir, "index.json")
        if family:
            self._write_family()
        # entry: [off, len, crc, dtype, shape, src_fp]
        self._entries: dict[int, list] = {}
        self._pack_end = 0
        self._dirty = 0
        self._append_f = None
        self._read_fd = -1
        self._load_index()
        self._evict_stale_generations()

    def _load_index(self) -> None:
        try:
            pack_size = os.path.getsize(self._pack_path)
            with open(self._index_path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        for k, e in raw.get("entries", {}).items():
            if e[0] + e[1] <= pack_size:  # only records inside the pack
                self._entries[int(k)] = e
        self._pack_end = pack_size

    def _persist_index(self) -> None:
        tmp = f"{self._index_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"entries": {str(k): v for k, v
                                       in self._entries.items()}}, f)
            os.replace(tmp, self._index_path)
        except OSError as e:
            log.warning("snapshot cache index persist failed: %s", e)
        self._dirty = 0

    def flush(self) -> None:
        if self._append_f is not None:
            try:
                self._append_f.flush()
            except OSError:
                pass
        if self._dirty:
            self._persist_index()

    def close(self) -> None:
        self.flush()
        if self._append_f is not None:
            try:
                self._append_f.close()
            except OSError:
                pass
            self._append_f = None
        if self._read_fd >= 0:
            try:
                os.close(self._read_fd)
            except OSError:
                pass
            self._read_fd = -1

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    @property
    def bytes_used(self) -> int:
        return self._pack_end

    @property
    def complete(self) -> bool:
        return len(self._entries) >= self.n_items

    def _write_family(self) -> None:
        path = os.path.join(self._dir, "family")
        if self._family_of(self._dir) == self.family:
            return
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(self.family)
            os.replace(tmp, path)
        except OSError as e:  # a read-only store still serves
            log.warning("snapshot cache: family mark not written: %s", e)

    @staticmethod
    def _family_of(path: str) -> str:
        try:
            with open(os.path.join(path, "family")) as f:
                return f.read()
        except OSError:
            return ""

    def touch(self) -> None:
        """Mark this generation live (its directory's mtime)."""
        try:
            os.utime(self._dir)
        except OSError:
            pass

    def _evict_stale_generations(self) -> None:
        self.touch()  # claim this generation as live
        cutoff = time.time() - self._EVICT_GRACE_S
        try:
            with os.scandir(self.root) as it:
                stale = sorted(
                    (e.stat().st_mtime, e.path) for e in it
                    if e.is_dir() and e.name != self.key
                    and e.stat().st_mtime < cutoff)
        except OSError:
            return
        for _, path in stale:
            if self.family and self._family_of(path) == self.family:
                continue  # a sibling: another rank's shard of this job
            log.info("snapshot cache: evicting stale generation %s", path)
            shutil.rmtree(path, ignore_errors=True)

    def has(self, i: int) -> bool:
        return i in self._entries

    def evict(self, i: int) -> None:
        if self._entries.pop(i, None) is not None:
            self._dirty += 1

    def write(self, i: int, arr: np.ndarray, src_fp: Sequence[int]) -> bool:
        """Admit item i (append, then index it; a rewrite orphans the old
        record). False, counted in `rejected_writes`, when the append would
        pass the capacity: the store stays bounded and never turns warm."""
        return self.write_rows(np.ascontiguousarray(arr)[None], [0], [i],
                               [src_fp], 1) == 1

    def write_rows(self, block: np.ndarray, rows: Sequence[int],
                   keys: Sequence[int], src_fps: Sequence[Sequence[int]],
                   threads: int) -> int:
        """`write(keys[k], block[rows[k]], src_fps[k])` for each k in turn,
        the pack and index left as those writes leave them, with one crc32
        call for all the rows and one append for each run of consecutive
        rows; `block` is C-contiguous. Returns how many were admitted."""
        nbytes = block[0].nbytes if len(block) else 0
        room = max(0, (self.capacity_bytes - self._pack_end) // nbytes) \
            if nbytes else 0
        admit = list(rows[:room])
        self.rejected_writes += len(rows) - len(admit)
        if not admit:
            return 0
        raw = block.reshape(len(block), -1).view(np.uint8)
        crcs = native_snapshot.crc32_many(
            raw, np.asarray(admit, np.int64) * nbytes,
            np.full(len(admit), nbytes, np.int64), threads)
        try:
            if self._append_f is None:
                self._append_f = open(self._pack_path, "ab")
            off = self._append_f.tell()
            k = 0
            while k < len(admit):
                end = k + 1
                while end < len(admit) and admit[end] == admit[end - 1] + 1:
                    end += 1
                self._append_f.write(raw[admit[k]:admit[end - 1] + 1].data)
                k = end
        except (OSError, ValueError) as e:
            log.warning("snapshot cache write failed for items %s: %s",
                        list(keys[:len(admit)]), e)
            return 0
        dtype, shape = block.dtype.name, list(block.shape[1:])
        for k, (key, fp) in enumerate(zip(keys, src_fps[:len(admit)])):
            self._entries[int(key)] = [off + k * nbytes, nbytes,
                                       int(crcs[k]), dtype, shape, list(fp)]
        self._pack_end = off + len(admit) * nbytes
        self._dirty += len(admit)
        if self._dirty >= self._FLUSH_EVERY or self.complete:
            self.flush()
        return len(admit)

    def lookup(self, i: int, src_fp: Optional[Sequence[int]] = None,
               dtype: Optional[str] = None,
               shape: Optional[Sequence[int]] = None) -> Optional[list]:
        """Item i's entry, or None (and the entry evicted) when it is
        missing, its recorded source fingerprint is not `src_fp`, or its
        dtype and shape are not the ones asked for."""
        e = self._entries.get(i)
        if e is None:
            return None
        if src_fp is not None and list(src_fp) != list(e[5]):
            log.warning("snapshot cache: invalidating item %d "
                        "(source fingerprint drift)", i)
            self.evict(i)
            return None
        if (dtype is not None and e[3] != dtype) or \
                (shape is not None and list(e[4]) != list(shape)):
            self.evict(i)  # a stale layout: a miss
            return None
        return e

    def fetch(self, entries: Sequence[list], dst: np.ndarray,
              dst_offsets: Sequence[int], threads: int = 1) -> list:
        """Read each entry's payload into the C-contiguous `dst` at its
        byte offset and check it; for each, None when it is whole and its
        crc32 matches, else why not. The appends are
        flushed first: a repair may have appended since the last read."""
        if not entries:
            return []
        try:
            if self._append_f is not None:
                self._append_f.flush()
            if self._read_fd < 0:
                self._read_fd = os.open(self._pack_path, os.O_RDONLY)
        except OSError as err:
            return [str(err)] * len(entries)
        return native_snapshot.gather(
            self._read_fd, [e[0] for e in entries], [e[1] for e in entries],
            [e[2] for e in entries], dst, dst_offsets, threads)

    def read(self, i: int,
             src_fp: Optional[Sequence[int]] = None) -> Optional[np.ndarray]:
        """Item i's crop in a fresh array, or None (and the entry evicted)
        as `lookup` and `fetch` fail."""
        e = self.lookup(i, src_fp)
        if e is None:
            return None
        out = np.empty(e[4], np.dtype(e[3]))
        why, = self.fetch([e], out, [0])
        if why is not None:
            log.warning("snapshot cache: invalidating item %d (%s)", i, why)
            self.evict(i)
            return None
        return out


def _decode_spec(*, image_size: int, image_dtype: str, mean, std,
                 area_range, seed: int, hflip: bool = True) -> dict:
    return {
        "abi": JPEG_ABI_VERSION, "image_size": int(image_size),
        "image_dtype": image_dtype, "pack4": False,
        "mean": [float(v) for v in mean], "std": [float(v) for v in std],
        "area_range": [float(v) for v in area_range], "seed": int(seed),
        "hflip": bool(hflip),
    }


def _digest(spec: dict) -> str:
    return hashlib.sha1(json.dumps(spec, sort_keys=True).encode()) \
        .hexdigest()[:16]


def params_key(*, n_items: int, files: Sequence[str], **decode) -> str:
    """The generation key: the decode parameters (`_decode_spec`'s
    keywords), the native ABI and a (path, size) fingerprint of the source
    files. Anything that would change the pixels changes the key. The spec
    is JAX's, so either package serves the other's store; its `pack4` (the
    host's space-to-depth) is False, as the port never packs on the host."""
    fp = hashlib.sha1()
    for p in files:
        try:
            fp.update(f"{p}:{os.path.getsize(p)}\n".encode())
        except OSError:
            fp.update(f"{p}:?\n".encode())
    return _digest(dict(_decode_spec(**decode), n=int(n_items),
                        files=fp.hexdigest()))


def family_key(**decode) -> str:
    """`params_key` without the source set: equal for the stores of one
    job's DP ranks (the same decode parameters over each rank's shard)."""
    return _digest(_decode_spec(**decode))


def _hflip(arr: np.ndarray) -> np.ndarray:
    """An HWC crop flipped left to right."""
    return arr[:, ::-1, :]


# -------------------------------------------------------------- the iterator

class SnapshotCachingTrainIterator:
    """Wraps a NativeJpegTrainIterator: pass through and capture until the
    store holds every item, then serve warm (the inner loader is closed at
    the switch; repairs go through the stateless `decode_single_image`).
    Yields ``{"image", "label"}`` in fresh arrays, or fills caller-owned
    tensors through `next_into`."""

    supports_state = True

    def __init__(self, inner, store: SnapshotStore, *, n_items: int,
                 seed: int, labels, files: Sequence[str], path_idx, offsets,
                 lengths, mean, std, image_dtype: str, image_size: int,
                 area_range=(0.08, 1.0), hflip: bool = True):
        self._inner = inner
        #: False: the device augment owns the flip (unflipped captures, no
        #: warm redraw, flips-disabled repairs)
        self._hflip = bool(hflip)
        self._store = store
        self._n = int(n_items)
        self._seed = int(seed)
        self._labels = np.ascontiguousarray(labels, np.int32)
        self._files = [str(f) for f in files]
        self._path_idx = np.ascontiguousarray(path_idx, np.int32)
        self._offsets = np.ascontiguousarray(offsets, np.int64)
        self._lengths = np.ascontiguousarray(lengths, np.int64)
        self._mean = np.ascontiguousarray(mean, np.float32)
        self._std = np.ascontiguousarray(std, np.float32)
        self._area_range = (float(area_range[0]), float(area_range[1]))
        self.batch = int(inner.batch)
        self.image_size = int(image_size)
        self.image_dtype = image_dtype
        self._item_shape = (self.image_size, self.image_size, 3)
        self._pos = 0
        self._started = False
        self._warm = False
        self._inner_open = True
        # the autotuner's calls and the warm switch's close, apart
        self._inner_lock = threading.Lock()
        self._inner_errors = 0
        self._orders: dict[int, np.ndarray] = {}
        self._inv0: Optional[np.ndarray] = None
        self._stats = SourceStatMemo(self._files, self._path_idx,
                                     self._offsets, self._lengths)
        self._fill_failures = 0
        self._touched_epoch = -1
        #: seconds each warm batch's assembly took, newest last (bounded)
        self.warm_assembly_s: List[float] = []
        reg = get_registry()
        for name in SNAPSHOT_COUNTERS:
            reg.counter(name)

    # -------------------------------------------------------- the surface
    def __iter__(self):
        return self

    @property
    def image_shape(self):
        """(B, S, S, 3): the shape of one batch's images."""
        return (self.batch,) + self._item_shape

    @property
    def warm(self) -> bool:
        """True once the iterator serves from the store."""
        return self._warm

    @property
    def store(self) -> SnapshotStore:
        return self._store

    def restore_state(self, step: int) -> bool:
        if self._started:
            return False
        self._pos = int(step)
        if not self._store.complete and self._inner_open:
            return self._inner.restore_state(step)
        return True

    def decode_errors(self) -> int:
        with self._inner_lock:
            inner = (self._inner.decode_errors() if self._inner_open
                     else self._inner_errors)
        return inner + self._fill_failures

    def set_num_threads(self, n: int) -> Optional[int]:
        """The decode pool's resize while the cold pass decodes; None once
        warm, where no pool is left to steer."""
        with self._inner_lock:
            if not self._inner_open:
                return None
            return self._inner.set_num_threads(n)

    def num_threads(self) -> Optional[int]:
        with self._inner_lock:
            if not self._inner_open:
                return None
            return self._inner.num_threads()

    def _close_inner(self) -> None:
        with self._inner_lock:
            if self._inner_open:
                # the count never goes back across the switch
                self._inner_errors = self._inner.decode_errors()
                self._inner.close()
                self._inner_open = False
        self._store.flush()

    def close(self) -> None:
        self._close_inner()
        self._store.close()

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    # ----------------------------------------------------------- the draw
    def __next__(self):
        b = self._begin_draw()
        if self._warm:
            images = np.empty(self.image_shape, self.image_dtype)
            labels = np.empty((self.batch,), np.int32)
            self._assemble_warm(b, images, labels)
            return {"image": images, "label": labels}
        batch = next(self._inner)
        self._capture(batch["image"], b)
        return batch

    def next_into(self, images, labels) -> None:
        """Fill `images`, a C-contiguous CPU tensor of `image_shape` and
        this iterator's dtype, and `labels`, a (B,) int32 CPU tensor, with
        the next batch: decoded by the inner loader and captured (cold), or
        read from the store into them (warm)."""
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
        b = self._begin_draw()
        if self._warm:
            self._assemble_warm(b, images.numpy(), labels.numpy())
            return
        self._inner.next_into(images, labels)
        self._capture(images.numpy(), b)

    def _begin_draw(self) -> int:
        self._started = True
        b = self._pos
        self._pos += 1
        epoch = b * self.batch // self._n
        if epoch != self._touched_epoch:  # keep the generation young
            self._touched_epoch = epoch
            self._store.touch()
        if not self._warm and self._store.complete:
            # latch warm: repairs ride decode_single_image from here on,
            # so the loader's workers and buffers can go
            self._warm = True
            self._close_inner()
        return b

    # ---------------------------------------------------------- internals
    def _order(self, epoch: int) -> np.ndarray:
        order = self._orders.get(epoch)
        if order is None:
            order = shuffle_indices(self._n, self._seed, epoch)
            self._orders[epoch] = order
            while len(self._orders) > 2:  # a batch spans at most two
                self._orders.pop(min(self._orders))
        return order

    def _items(self, b: int):
        """[(g, epoch, idx)] of batch b's positions."""
        g = b * self.batch + np.arange(self.batch, dtype=np.int64)
        epochs, pos = np.divmod(g, self._n)
        idx = np.empty(self.batch, np.int64)
        for epoch in np.unique(epochs):
            at = epochs == epoch
            idx[at] = self._order(int(epoch))[pos[at]]
        return list(zip(g.tolist(), epochs.tolist(), idx.tolist()))

    def _capture(self, images: np.ndarray, b: int) -> None:
        """Cold: admit every item of batch b not yet in the store, in
        position order (any epoch: a resumed run back-fills what its cold
        pass missed)."""
        rows, keys, fps, taken = [], [], [], set()
        for j, (_, epoch, idx) in enumerate(self._items(b)):
            if not self._store.has(idx) and idx not in taken:
                taken.add(idx)
                rows.append(j)
                keys.append(idx)
                fps.append(self._stats.fingerprint(idx, epoch))
        self._store.write_rows(images, rows, keys, fps, BATCH_IO_THREADS)

    def _fallback_decode(self, idx: int, out: np.ndarray) -> bool:
        """Decode item idx's epoch-0 crop (the mirrored item RNG seed) into
        `out` and repair its entry; False when the source cannot be read
        or decoded."""
        if self._inv0 is None:
            order0 = shuffle_indices(self._n, self._seed, 0)
            self._inv0 = np.empty_like(order0)
            self._inv0[order0] = np.arange(self._n, dtype=np.int64)
        data = read_item_bytes(self._files, self._path_idx, self._offsets,
                               self._lengths, idx)
        if not data:
            return False
        try:
            arr = decode_single_image(
                data, self.image_size, self._mean, self._std,
                image_dtype=self.image_dtype, eval_mode=False,
                area_range=self._area_range,
                rng_seed=item_rng_seed(self._seed, int(self._inv0[idx])),
                hflip=self._hflip, out=out)
        except RuntimeError:
            return False
        if arr is None:
            return False
        self._store.write(idx, out, self._stats.fingerprint(
            idx, self._stats.epoch))
        return True

    def _assemble_warm(self, b: int, images: np.ndarray,
                       labels: np.ndarray) -> None:
        """Batch b from the store into `images` and `labels`: every item's
        payload read and checked in one native call, then, on this thread,
        each miss evicted and repaired (or filled) in position order, and
        the flips while the host owns them."""
        t0 = time.perf_counter()
        store = self._store
        items = self._items(b)
        labels[:] = self._labels[[idx for _, _, idx in items]]
        item_bytes = images[0].nbytes
        jobs, entries = [], []
        for j, (_, epoch, idx) in enumerate(items):
            e = store.lookup(idx, self._stats.fingerprint(idx, epoch),
                             self.image_dtype, self._item_shape)
            if e is not None:
                jobs.append(j)
                entries.append(e)
        failed = set(range(self.batch))
        whys = store.fetch(entries, images, [j * item_bytes for j in jobs],
                           BATCH_IO_THREADS)
        for j, why in zip(jobs, whys):
            if why is None:
                failed.discard(j)
            else:
                log.warning("snapshot cache: invalidating item %d (%s)",
                            items[j][2], why)
                store.evict(items[j][2])
        hits = self.batch - len(failed)
        misses = 0
        for j in sorted(failed):
            _, epoch, idx = items[j]
            # an earlier position of this batch may have repaired it
            e = store.lookup(idx, self._stats.fingerprint(idx, epoch),
                             self.image_dtype, self._item_shape)
            if e is not None and store.fetch([e], images,
                                             [j * item_bytes])[0] is None:
                hits += 1
                continue
            store.evict(idx)
            misses += 1
            if not self._fallback_decode(idx, images[j]):
                self._fill_failures += 1
                corrupt_fill(images[j], self.image_dtype, self._mean)
        if self._hflip:
            for j, (g, _, _) in enumerate(items):
                if _flip_bit(self._seed, g):
                    images[j] = _hflip(images[j])
        reg = get_registry()
        reg.inc("prefetch/snapshot_hits", hits)
        reg.inc("prefetch/snapshot_misses", misses)
        reg.inc("prefetch/snapshot_bytes", hits * images[0].nbytes)
        self.warm_assembly_s.append(time.perf_counter() - t0)
        del self.warm_assembly_s[:-256]


def wrap_train_iterator(inner, cfg, *, seed: int, files: Sequence[str],
                        labels, ranges=None):
    """`inner`, a fresh NativeJpegTrainIterator, behind the snapshot cache
    per `cfg.snapshot_cache` (a DataConfig's); `inner` itself when the
    cache is off, or when the store's root cannot be made (a read-only
    dataset mount costs the cache, never the loader: a warning is
    logged)."""
    sc = cfg.snapshot_cache
    if not sc.enabled:
        return inner
    if ranges is None:
        path_idx, offsets, lengths = _whole_file_ranges(len(files))
    else:
        path_idx, offsets, lengths = ranges
    root = sc.dir or os.path.join(cfg.data_dir or ".", ".dvggf_snapshot")
    # flip ownership rides the inner loader's: an hflip=False loader
    # captures unflipped crops
    hflip = bool(getattr(inner, "hflip", True))
    decode = dict(image_size=cfg.image_size, image_dtype=inner.image_dtype,
                  mean=cfg.mean_rgb, std=cfg.stddev_rgb,
                  area_range=(0.08, 1.0), seed=seed, hflip=hflip)
    try:
        store = SnapshotStore(
            root, params_key(n_items=len(labels), files=files, **decode),
            sc.capacity_bytes, len(labels), family=family_key(**decode))
    except OSError as e:
        log.warning("snapshot cache disabled: store root %s unusable (%s)",
                    root, e)
        return inner
    return SnapshotCachingTrainIterator(
        inner, store, n_items=len(labels), seed=seed, labels=labels,
        files=files, path_idx=path_idx, offsets=offsets, lengths=lengths,
        mean=cfg.mean_rgb, std=cfg.stddev_rgb,
        image_dtype=inner.image_dtype, image_size=cfg.image_size,
        hflip=hflip)

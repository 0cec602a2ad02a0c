"""Bucketed, overlap-capable gradient exchange and the ZeRO flat layout —
the counterpart of the JAX package's parallel/buckets.py (:73–395).

The parameters partition into size-targeted BUCKETS in reverse-backward
order (the last layers' gradients exist first), and each bucket's
collective is issued as soon as its last gradient has been accumulated:
one all-reduce per bucket in plain DP, one reduce-scatter per bucket
under ZeRO-1/2. `BucketExchange` does that from the parameters'
post-accumulate-grad hooks (train/step.py), with `async_op=True`, so
bucket 0 (fc8's) is on the wire while the convs still back-propagate.

The layout is defined on the Flax leaf order and the Flax layouts, not on
the port's parameters: leaves in `jax.tree.leaves` order (sorted names:
``conv1/bias, conv1/kernel, ..., fc8/kernel``), kernels in HWIO and
(in, out). Each gradient is copied into its bucket buffer through the
view `weights.flax_view` gives (conv weights permuted, dense weights
transposed) and copied back the same way, so the bucket boundaries,
`describe()` and the (T,) vectors of `to_global` equal the JAX layout's
element for element, and a JAX ZeRO-2 checkpoint's flat momentum can be
taken as it is.

ZeRO shard layout under bucketing: replica r holds piece r OF EACH
BUCKET, so the persistent flat layout is bucket-major and
replica-interleaved,

    global[r * S + off_b : r * S + off_b + s_b] = bucket_b[r * s_b : (r + 1) * s_b]

with S = sum(s_b) the per-replica shard length and off_b the running
shard offset of bucket b. `to_global` / `from_global` are the exact
permutations between that layout and the parameters. Under ZeRO-3 the
(S,) shard is the parameters' only copy: `gather_param_tree` gathers
each bucket's pieces back (one all-gather a bucket) into the parameters
for a step (train/state.py `TrainState.release_params` empties them
after it).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from distributed_vgg_f_tpu_torch.parallel.collectives import (
    all_gather_flat, all_reduce_sum, cast_from_wire, cast_to_wire,
    rank_and_size, reduce_scatter_sum)
from distributed_vgg_f_tpu_torch.weights import flax_leaves, flax_view

#: Gradient bytes per element used for bucket sizing — gradients are fp32
#: whatever the compute dtype; the geometry must not depend on
#: mesh.reduce_dtype, or flipping the wire would re-layout a ZeRO state.
GRAD_BYTES_PER_ELEM = 4

Params = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def wire_dtype_of(reduce_dtype) -> Optional[torch.dtype]:
    """mesh.reduce_dtype ("float32", "bfloat16", a torch dtype or None) ->
    the wire dtype, None for the gradients' own fp32."""
    if reduce_dtype is None or reduce_dtype in ("float32", torch.float32):
        return None
    if reduce_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"reduce dtype {reduce_dtype!r} not one of "
                     "('float32', 'bfloat16')")


@dataclasses.dataclass(frozen=True)
class GradBucketLayout:
    """Static bucket geometry for one (parameter set, shard count,
    target). `buckets` holds canonical (Flax-order) leaf indices in
    EMISSION order: bucket 0 holds the last leaves. `names` are the Flax
    names, `keys` the port's parameter names, `leaf_shapes` the Flax
    shapes and `port_shapes` the port's, all in canonical order.
    `bucket_bytes` 0 marks a layout that is not size-targeted (one bucket
    a leaf, or parallel/zero.py's single flat vector)."""

    num_shards: int
    bucket_bytes: int
    names: Tuple[str, ...]
    keys: Tuple[str, ...]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    port_shapes: Tuple[Tuple[int, ...], ...]
    buckets: Tuple[Tuple[int, ...], ...]

    # ------------------------------------------------------------ geometry
    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def _leaf_size(self, idx: int) -> int:
        return int(math.prod(self.leaf_shapes[idx]))

    @functools.cached_property
    def _sizes(self) -> Tuple[Tuple[int, ...], ...]:
        n = tuple(sum(self._leaf_size(i) for i in b) for b in self.buckets)
        p = tuple(k + (-k) % self.num_shards for k in n)
        return n, p, tuple(k // self.num_shards for k in p)

    def bucket_sizes(self) -> Tuple[int, ...]:
        """Unpadded element count per bucket."""
        return self._sizes[0]

    def padded_sizes(self) -> Tuple[int, ...]:
        """Per-bucket length after padding to a multiple of num_shards."""
        return self._sizes[1]

    def shard_sizes(self) -> Tuple[int, ...]:
        return self._sizes[2]

    @property
    def shard_size(self) -> int:
        """Per-replica flat shard length S = sum(s_b)."""
        return sum(self.shard_sizes())

    @property
    def total_padded(self) -> int:
        """Global flat length T = N * S = sum(p_b)."""
        return sum(self.padded_sizes())

    def describe(self) -> dict:
        """The geometry receipt: everything `build_bucket_layout` needs to
        rebuild the layout, plus `total_padded` as the check a restore
        verifies."""
        return {"kind": "bucketed_flat",
                "num_shards": self.num_shards,
                "bucket_bytes": self.bucket_bytes,
                "num_buckets": self.num_buckets,
                "total_padded": self.total_padded,
                "bucket_elems": list(self.bucket_sizes())}

    @functools.cached_property
    def _slots(self) -> Tuple[Tuple[int, int], ...]:
        """Per canonical leaf: (its bucket, its offset in the bucket)."""
        slots = [None] * len(self.names)
        for b, bucket in enumerate(self.buckets):
            off = 0
            for i in bucket:
                slots[i] = (b, off)
                off += self._leaf_size(i)
        return tuple(slots)

    @functools.cached_property
    def _shard_offsets(self) -> Tuple[int, ...]:
        offs, off = [], 0
        for s_b in self.shard_sizes():
            offs.append(off)
            off += s_b
        return tuple(offs)

    # ------------------------------------------------ tensors <-> buckets
    def leaves(self, params: Params) -> List[torch.Tensor]:
        """The parameters (a module, or a mapping of the port's names to
        tensors such as its gradients) in canonical order."""
        named = (dict(params.named_parameters())
                 if isinstance(params, torch.nn.Module) else params)
        return [named[k] for k in self.keys]

    def pack(self, idx: int, t: torch.Tensor, buf: torch.Tensor) -> None:
        """Copy leaf `idx` (the port's layout) into its place in its
        bucket's buffer, in the Flax layout."""
        _, off = self._slots[idx]
        src = flax_view(self.keys[idx], t)
        buf[off:off + src.numel()].view(src.shape).copy_(src)

    def unpack(self, b: int, vec: torch.Tensor,
               out: Sequence[torch.Tensor]) -> None:
        """Write bucket b's vector (padded or not) into its leaves of `out`
        (canonical order, the port's layout)."""
        for i in self.buckets[b]:
            _, off = self._slots[i]
            dst = flax_view(self.keys[i], out[i])
            dst.copy_(vec[off:off + dst.numel()].view(dst.shape))

    def bucket_vector(self, leaves: Sequence[torch.Tensor], b: int,
                      pad: bool) -> torch.Tensor:
        """Bucket b's leaves as one fp32 vector in the Flax layout,
        zero-padded to a multiple of num_shards with `pad`."""
        n = (self.padded_sizes() if pad else self.bucket_sizes())[b]
        buf = torch.zeros(n, dtype=torch.float32, device=leaves[0].device)
        for i in self.buckets[b]:
            self.pack(i, leaves[i], buf)
        return buf

    def _bucket_columns(self, mat: torch.Tensor, b: int) -> torch.Tensor:
        """Bucket b's padded vector from the (N, S) view of a global one."""
        off, s_b = self._shard_offsets[b], self.shard_sizes()[b]
        return mat[:, off:off + s_b].reshape(-1)

    def _exchange(self, grads, scatter: bool, group, wire_dtype):
        ex = BucketExchange(self, scatter=scatter, group=group,
                            wire_dtype=wire_dtype)
        for b in self.buckets:
            for i in b:
                ex.add(i, grads[i])
        return ex.finish(grads)

    # -------------------------------------------------------- the DP leg
    def pmean_buckets(self, grads: Sequence[torch.Tensor], group=None,
                      wire_dtype=None) -> None:
        """Per-bucket mean all-reduce of gradients (canonical order), in
        place: each bucket's leaves ride one collective, cast to the wire
        dtype through `cast_to_wire`. Elementwise the per-leaf mean."""
        self._exchange(grads, False, group, wire_dtype)

    # ------------------------------------------------------ the ZeRO legs
    def scatter_mean_shards(self, grads: Sequence[torch.Tensor], group=None,
                            wire_dtype=None) -> torch.Tensor:
        """Per-bucket reduce-scatter of gradients (canonical order) to
        this replica's fp32 mean flat shard (S,), bucket-major."""
        return self._exchange(grads, True, group, wire_dtype)

    def local_param_shard(self, params: Sequence[torch.Tensor],
                          rank: int) -> torch.Tensor:
        """This replica's (S,) fp32 slice of the bucket-major flat
        parameters — the piece the sharded optimizer updates."""
        with torch.no_grad():
            mat = self.to_global(params).view(self.num_shards, -1)
            return mat[rank].clone()

    def gather_params(self, param_shard: torch.Tensor,
                      params: Sequence[torch.Tensor], group=None) -> None:
        """All-gather the updated (S,) shards and write them into the full
        parameters (canonical order), which re-sync exactly: always fp32,
        the gather leg is never narrowed."""
        full = torch.empty(self.total_padded, dtype=torch.float32,
                           device=param_shard.device)
        all_gather_flat(full, param_shard, group)
        mat = full.view(self.num_shards, -1)
        with torch.no_grad():
            for b in range(self.num_buckets):
                self.unpack(b, self._bucket_columns(mat, b), params)

    def gather_param_tree(self, param_shard: torch.Tensor,
                          params: Sequence[torch.Tensor], group=None,
                          wire_dtype=None,
                          events: Optional[list] = None) -> None:
        """ZeRO-3's just-in-time gather (JAX `buckets.py:225`): one
        all-gather PER BUCKET of this rank's piece of the (S,) shard,
        issued async in the order the forward consumes the buckets (the
        last bucket, which holds the first layers, first) on the
        `mesh.reduce_dtype` wire through `cast_to_wire` (the gathered
        replica is a transient of one step; the fp32 truth stays in the
        shard). Once every gather has landed, each bucket's leaves are
        unpacked into one fp32 buffer of their own and the parameters
        (canonical order) become views
        of it (a parameter's shape between steps lives in `port_shapes`).
        `events`, when a list, gets ("gather", bucket) as each gather is
        issued."""
        wire = wire_dtype_of(wire_dtype)
        pending = []
        for b in reversed(range(self.num_buckets)):
            off = self._shard_offsets[b]
            piece = cast_to_wire(
                param_shard[off:off + self.shard_sizes()[b]], wire)
            full = torch.empty(self.padded_sizes()[b], dtype=piece.dtype,
                               device=piece.device)
            pending.append((b, all_gather_flat(full, piece, group,
                                               async_op=True), full))
            if events is not None:
                events.append(("gather", b))
        for b, work, full in pending:
            if work is not None:
                work.wait()
            sizes = [self._leaf_size(i) for i in self.buckets[b]]
            buf = torch.empty(sum(sizes), dtype=torch.float32,
                              device=full.device)
            out: List[Optional[torch.Tensor]] = [None] * len(self.keys)
            off = 0
            for i, n in zip(self.buckets[b], sizes):
                out[i] = buf[off:off + n].view(self.port_shapes[i])
                off += n
            with torch.no_grad():
                self.unpack(b, cast_from_wire(full, torch.float32), out)
                for i in self.buckets[b]:
                    params[i].data = out[i]

    # --------------------------------------- global flat layout (opt state)
    def to_global(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        """Leaves (canonical order) -> the (T,) bucket-major
        replica-interleaved fp32 vector; row r of its (N, S) view is
        replica r's shard."""
        rows = [self.bucket_vector(leaves, b, pad=True).view(
                    self.num_shards, s_b)
                for b, s_b in enumerate(self.shard_sizes())]
        return torch.cat(rows, dim=1).reshape(self.total_padded)

    def from_global(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Inverse of `to_global`: a (T,) vector (or the tiled all-gather
        of the replicas' shards, the same layout) -> the port's name ->
        tensor in the port's layout; padding is dropped."""
        if vec.numel() != self.total_padded:
            raise ValueError(f"a global vector of {vec.numel()} elements; "
                             f"this layout holds {self.total_padded}")
        out = [torch.empty(s, dtype=vec.dtype, device=vec.device)
               for s in self.port_shapes]
        mat = vec.reshape(self.num_shards, self.shard_size)
        for b in range(self.num_buckets):
            self.unpack(b, self._bucket_columns(mat, b), out)
        return dict(zip(self.keys, out))

    # ------------------------------------------------------------- receipts
    def wire_bytes_per_step(self, *, zero: bool, wire_dtype=None,
                            shard_params: bool = False) -> Dict[str, int]:
        """Logical collective payload bytes per step per replica (the one
        accounting, `exchange_wire_bytes`)."""
        return exchange_wire_bytes(sum(self.bucket_sizes()),
                                   self.total_padded, zero=zero,
                                   wire_dtype=wire_dtype,
                                   shard_params=shard_params)


class BucketExchange:
    """One backward's exchange over a layout. `add(idx, grad)` copies a
    leaf's gradient into its bucket's fp32 buffer (divided by `divisor`,
    the micro-batch count of a plain accumulation, once the bucket is
    whole) and issues the bucket's collective, async, as soon as its last
    leaf is in: an all-reduce, or with `scatter` a reduce-scatter into
    this rank's piece. `finish()` waits on every handle and returns this
    rank's (S,) fp32 mean shard (scatter) or writes the means into the
    gradients it is given (all-reduce). A single-leaf bucket on an fp32
    wire all-reduces the gradient itself, in place. `events`, when a
    list, gets ("issue", bucket) as each collective is issued."""

    def __init__(self, layout: GradBucketLayout, *, scatter: bool,
                 group=None, wire_dtype=None, divisor: int = 1,
                 events: Optional[list] = None):
        self.layout = layout
        self.scatter = scatter
        self.group = group
        self.wire = wire_dtype_of(wire_dtype)
        self.divisor = divisor
        self.events = events
        self.n = rank_and_size(group)[1]
        if self.n != layout.num_shards:
            raise ValueError(f"a layout for {layout.num_shards} shards in a "
                             f"group of {self.n}")
        self._left = [len(b) for b in layout.buckets]
        self._bufs: List[Optional[torch.Tensor]] = [None] * len(self._left)
        self._inplace = [False] * len(self._left)
        self._pending: list = []
        self._shard: Optional[torch.Tensor] = None

    def add(self, idx: int, grad: torch.Tensor) -> None:
        lay = self.layout
        b, _ = lay._slots[idx]
        if (not self.scatter and self.wire is None and len(lay.buckets[b]) == 1
                and grad.dtype == torch.float32 and grad.is_contiguous()):
            self._bufs[b], self._inplace[b] = grad, True
        else:
            if self._bufs[b] is None:
                n = (lay.padded_sizes() if self.scatter
                     else lay.bucket_sizes())[b]
                self._bufs[b] = torch.empty(n, dtype=torch.float32,
                                            device=grad.device)
                self._bufs[b][lay.bucket_sizes()[b]:].zero_()
            lay.pack(idx, grad, self._bufs[b])
        self._left[b] -= 1
        if self._left[b] == 0:
            self._issue(b)

    def _issue(self, b: int) -> None:
        buf = self._bufs[b]
        if self.divisor != 1:
            buf.div_(self.divisor)
        wire = cast_to_wire(buf, self.wire)
        if self.scatter:
            if self._shard is None:
                self._shard = torch.empty(self.layout.shard_size,
                                          dtype=torch.float32,
                                          device=buf.device)
            off = self.layout._shard_offsets[b]
            piece = self._shard[off:off + self.layout.shard_sizes()[b]]
            out = piece if self.wire is None else torch.empty_like(
                piece, dtype=self.wire)
            work = reduce_scatter_sum(out, wire, self.group, async_op=True)
            self._pending.append((b, work, out, piece))
        else:
            work = all_reduce_sum(wire, self.group, async_op=True)
            self._pending.append((b, work, wire, None))
        if self.events is not None:
            self.events.append(("issue", b))

    def finish(self, grads: Optional[Sequence[torch.Tensor]] = None):
        missing = [self.layout.names[i] for b, left in enumerate(self._left)
                   if left for i in self.layout.buckets[b]]
        if missing:
            raise RuntimeError(f"no gradient reached the exchange for "
                               f"{missing[:4]}: every rank must issue every "
                               "bucket")
        for b, work, out, piece in self._pending:
            if work is not None:
                work.wait()
            if self.scatter:
                if out is not piece:
                    piece.copy_(cast_from_wire(out, torch.float32))
                piece.div_(self.n)
            else:
                vec = cast_from_wire(out, torch.float32).div_(self.n)
                if not self._inplace[b]:
                    self.layout.unpack(b, vec, grads)
        self._pending = []
        if self.scatter:
            return self._shard
        return None


def sharding_basis(zero1: bool, shard_gradients: bool,
                   shard_params: bool = False) -> str:
    """THE (dp | zero1 | zero2 | zero3) basis derivation — the single
    source for the step's `comm_meta` (the EFFECTIVE basis, after the
    trainer's single-shard downgrade) and config.MeshConfig's configured
    label. Cumulative: zero3 implies zero2 implies zero1."""
    if zero1 and shard_gradients and shard_params:
        return "zero3"
    if zero1 and shard_gradients:
        return "zero2"
    return "zero1" if zero1 else "dp"


def exchange_wire_bytes(n_elem: int, padded_total: int, *, zero: bool,
                        wire_dtype=None,
                        shard_params: bool = False) -> Dict[str, int]:
    """Logical collective payload bytes per step per replica (algorithm
    bytes; the ring factor 2(N-1)/N is not in them). DP: one all-reduce
    of the gradient bytes on the (possibly narrowed) wire. ZeRO-1/2: the
    scatter leg on the wire dtype plus the fp32 param gather (replicas
    must agree bit-exactly, so it never narrows). ZeRO-3: the gather
    rides the wire too."""
    wire = wire_dtype_of(wire_dtype)
    wire_itemsize = 4 if wire is None else torch.finfo(wire).bits // 8
    if not zero:
        b = n_elem * wire_itemsize
        return {"allreduce_bytes": b, "scatter_bytes": 0,
                "gather_bytes": 0, "wire_bytes": b}
    scatter = padded_total * wire_itemsize
    gather = padded_total * (wire_itemsize if shard_params else 4)
    return {"allreduce_bytes": 0, "scatter_bytes": scatter,
            "gather_bytes": gather, "wire_bytes": scatter + gather}


def canonical_leaves(params: Params, num_heads: Optional[int] = None
                     ) -> List[Tuple[str, str, Tuple[int, ...],
                                     Tuple[int, ...]]]:
    """(Flax name, port name, Flax shape, port shape) of every parameter,
    in the Flax leaf order. A module names its own head count (ViT's
    fused attention leaves need it)."""
    if isinstance(params, torch.nn.Module):
        num_heads = getattr(params, "num_heads", num_heads)
        params = dict(params.named_parameters())
    if not params:
        raise ValueError("cannot bucket an empty parameter set")
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    return [(name, key, shape, shapes[key]) for name, key, shape
            in flax_leaves(shapes, num_heads=num_heads)]


def _layout(leaves, num_shards: int, bucket_bytes: int,
            buckets) -> GradBucketLayout:
    names, keys, shapes, port_shapes = zip(*leaves)
    return GradBucketLayout(num_shards=int(num_shards),
                            bucket_bytes=int(bucket_bytes), names=names,
                            keys=keys, leaf_shapes=shapes,
                            port_shapes=port_shapes,
                            buckets=tuple(tuple(b) for b in buckets))


def build_bucket_layout(params: Params, num_shards: int, bucket_bytes: int,
                        *, num_heads: Optional[int] = None
                        ) -> Optional[GradBucketLayout]:
    """Partition the parameters into size-targeted buckets in
    reverse-backward order. `bucket_bytes` <= 0 returns None (the
    unbucketed exchange). Leaves are atomic: a leaf larger than the target
    is a bucket of its own, so the target is a granularity floor, not a
    cap."""
    if bucket_bytes <= 0:
        return None
    leaves = canonical_leaves(params, num_heads)
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for idx in reversed(range(len(leaves))):
        nbytes = int(math.prod(leaves[idx][2])) * GRAD_BYTES_PER_ELEM
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(idx)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return _layout(leaves, num_shards, bucket_bytes, buckets)


def leaf_layout(params: Params, num_shards: int, *,
                num_heads: Optional[int] = None) -> GradBucketLayout:
    """One bucket per leaf in reverse-backward order: the unbucketed DP
    exchange, one all-reduce per leaf (`all_reduce_gradients` issued as
    each gradient lands)."""
    leaves = canonical_leaves(params, num_heads)
    return _layout(leaves, num_shards, 0,
                   [[i] for i in reversed(range(len(leaves)))])


def layout_from_receipt(params: Params, receipt: dict, *,
                        num_heads: Optional[int] = None) -> GradBucketLayout:
    """Rebuild a layout from its receipt (`describe()`), verifying the
    rebuild against every recorded geometry field — total_padded, bucket
    count and the per-bucket sizes (two partitions can share a total
    while permuting differently). A mismatch raises ValueError: a
    momentum vector is never silently permuted."""
    if receipt.get("kind") != "bucketed_flat":
        raise ValueError(f"unknown opt-layout kind {receipt.get('kind')!r}")
    layout = build_bucket_layout(params, int(receipt["num_shards"]),
                                 int(receipt["bucket_bytes"]),
                                 num_heads=num_heads)
    rebuilt = None if layout is None else {
        "total_padded": layout.total_padded,
        "num_buckets": layout.num_buckets,
        "bucket_elems": list(layout.bucket_sizes())}
    recorded = {"total_padded": int(receipt["total_padded"]),
                "num_buckets": int(receipt["num_buckets"]),
                "bucket_elems": [int(n) for n in receipt["bucket_elems"]]}
    if rebuilt != recorded:
        raise ValueError(
            f"bucket-layout receipt does not reproduce on these parameters: "
            f"rebuilt {rebuilt} != recorded {recorded} — it was written for "
            "a different model or geometry")
    return layout

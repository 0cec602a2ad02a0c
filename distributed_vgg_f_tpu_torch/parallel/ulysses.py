"""Ulysses: all-to-all sequence parallelism — the counterpart of the JAX
package's parallel/ulysses.py (`ulysses_self_attention`).

q, k and v arrive sequence-sharded, (B, T_loc, H, D) on each rank. One
tiled all-to-all each (`collectives.all_to_all`) re-shards them by head:
every rank then holds the whole sequence for H/n of the heads, attention
(causal masking included) is a local computation — the einsum reference
or the port's flash kernels — and one more all-to-all returns the output
to the sequence-sharded layout. Head counts that do not divide the group
size are zero-padded to the next multiple and sliced back (exact,
gradients included: a zero head attends uniformly over zero values).
With kernel="flash" and causal=True at T >= 2048, this is the path on
which the causal tile skip of the flash kernels (the counterpart of the
JAX package's jagged grids) runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from distributed_vgg_f_tpu_torch.ops.flash_attention import \
    flash_self_attention
from distributed_vgg_f_tpu_torch.parallel.collectives import (all_to_all,
                                                              rank_and_size)
from distributed_vgg_f_tpu_torch.parallel.ring_attention import \
    full_attention_reference

LOCAL_KERNELS = ("einsum", "flash")


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, group=None,
                           causal: bool = False,
                           kernel: str = "einsum") -> torch.Tensor:
    """This rank's (B, T_loc, H, D) output attending over the whole
    sequence, from its (B, T_loc, H, D) shards of q, k and v, for any
    head count H (padded to a multiple of the group size inside).
    `kernel`: "einsum" (`full_attention_reference`, O(T^2) memory) or
    "flash" (`flash_self_attention`: the Hopper kernels for CUDA tensors,
    their plain versions for CPU tensors)."""
    if kernel not in LOCAL_KERNELS:
        raise ValueError(f"kernel {kernel!r} not one of {LOCAL_KERNELS}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one (B, T_loc, H, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    _, n = rank_and_size(group)
    h = q.shape[2]
    h_pad = -(-h // n) * n
    if h_pad != h:
        q, k, v = (F.pad(x, (0, 0, 0, h_pad - h)) for x in (q, k, v))
    # (B, T_loc, H, D) -> (B, T, H/n, D)
    qh, kh, vh = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    if kernel == "flash":
        out = flash_self_attention(qh, kh, vh, causal=causal)
    else:
        out = full_attention_reference(qh, kh, vh, causal=causal)
    # (B, T, H/n, D) -> (B, T_loc, H, D)
    out = all_to_all(out, 1, 2, group)
    return out[:, :, :h] if h_pad != h else out

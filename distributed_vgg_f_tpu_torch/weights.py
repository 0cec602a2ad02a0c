"""Weight bridge between the Flax param tree and the port's state_dict.

The Flax tree nests ``{layer: {"kernel", "bias"}}`` (``"scale"`` and
``"bias"`` for a LayerNorm) under module names, with raw parameters
(ViT's ``cls`` and ``pos_embed``) as arrays of their own; the port's
state_dict names the same leaves ``block0.attn.qkv.weight`` and so on.
Each leaf maps by a transpose or a reshape, so the round trip is bitwise:

- conv kernels HWIO <-> OIHW; dense kernels (in, out) <-> (out, in);
- ViT's fused ``qkv`` kernel (D, 3, H, hd) <-> (3*H*hd, D) and its bias
  (3, H, hd) <-> flat; the ``out`` kernel (H, hd, D) <-> (D, H*hd);
- LayerNorm and BatchNorm ``scale`` <-> ``weight``; raw parameters as
  they are.

The way back needs the head count H (`params_to_flax(num_heads=...)`).
VGG-F's fc6 needs no row permutation: the port flattens pool5 in NHWC
order, as Flax does.

BatchNorm (the zoo's ResNet) adds Flax's second collection, the
`batch_stats` tree (``<layer>/mean``, ``<layer>/var``): raw leaves to
these maps, so `params_from_flax` and `params_to_flax` carry it to and
from the BatchNorm layers' ``mean`` and ``var`` buffers as they are; a
BatchNorm's ``weight`` is Flax's ``scale``, as a LayerNorm's is.

`load_npz` reads the flat ``'conv1/kernel'`` npz the JAX package's
`train/distill.py save_params` writes; `init_params` makes a seeded tree
with the Flax initializers for runs without a weights file, and
`init_batch_stats` the statistics Flax's init starts at.
`momentum_from_optax` maps optax's SGD momentum trace (a param-shaped
tree) through the same maps, so a port run can continue a JAX run;
`momentum_shard_from_optax` takes the trace of a JAX ZeRO state (the
(T,) bucket-major flat vector, parallel/buckets.py) to one rank's (S,)
shard, and `momentum_global_from_shards` joins the ranks' shards back.

`flax_leaves` and `flax_view` give the Flax leaf order
(`jax.tree.leaves`: sorted names, so ``conv1/bias`` before
``conv1/kernel``) and, for each of the port's tensors, a view whose
C-order elements are the Flax leaf's: the gradient exchange lays its flat
vectors out on them (parallel/buckets.py, parallel/zero.py), so they
equal the JAX package's element for element.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_vgg_f_tpu_torch.config import ModelConfig

#: stddev correction of a normal truncated at two standard deviations
#: (the lecun_normal initializer's truncated_normal variance scaling)
_TRUNC_STD = 0.87962566103423978
#: Flax leaf names of a layer; any other array is a raw parameter
_LAYER_LEAVES = ("kernel", "bias", "scale")


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _leaf_from_flax(path: Tuple[str, ...], arr: np.ndarray
                    ) -> Tuple[str, np.ndarray]:
    """One Flax leaf -> (state_dict key, array in the port's layout)."""
    *layer, leaf = path
    if not layer or leaf not in _LAYER_LEAVES:
        return ".".join(path), np.array(arr, copy=True)
    name = ".".join(layer)
    if leaf == "scale":
        return f"{name}.weight", np.array(arr, copy=True)
    if leaf == "bias":
        return f"{name}.bias", np.array(arr.reshape(-1), copy=True)
    if layer[-1] == "qkv":        # (D, 3, H, hd) -> (3*H*hd, D)
        out = arr.reshape(arr.shape[0], -1).T
    elif layer[-1] == "out" and arr.ndim == 3:   # (H, hd, D) -> (D, H*hd)
        out = arr.reshape(-1, arr.shape[-1]).T
    elif arr.ndim == 4:           # HWIO -> OIHW
        out = arr.transpose(3, 2, 0, 1)
    elif arr.ndim == 2:           # (in, out) -> (out, in)
        out = arr.T
    else:
        raise ValueError(f"kernel {'/'.join(path)} of rank {arr.ndim}: "
                         "expected a conv (4), dense (2), qkv or out kernel")
    return f"{name}.weight", np.ascontiguousarray(out)


def _leaf_to_flax(key: str, arr: np.ndarray, num_heads: Optional[int]
                  ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """One state_dict entry -> (Flax path, array in the Flax layout)."""
    path, view = _flax_leaf_view(key, arr, num_heads)
    return path, np.array(view, copy=True, order="C")


def _flax_leaf_view(key: str, arr: np.ndarray, num_heads: Optional[int]
                    ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """`_leaf_to_flax` without the copy: the Flax path and a view of `arr`
    in the Flax layout (its shape is all a caller of shapes needs)."""
    layer, _, leaf = key.rpartition(".")
    if not layer or leaf not in ("weight", "bias"):
        return tuple(key.split(".")), arr
    path = tuple(layer.split("."))
    if num_heads is None and (path[-1] == "qkv" or (path[-1] == "out"
                                                    and leaf == "weight")):
        raise ValueError(f"{key}: mapping ViT's fused attention leaves to "
                         "Flax needs num_heads")
    if leaf == "bias":
        if path[-1] == "qkv":     # flat -> (3, H, hd)
            arr = arr.reshape(3, num_heads, -1)
        return path + ("bias",), arr
    if arr.ndim == 1:             # LayerNorm, BatchNorm
        return path + ("scale",), arr
    if path[-1] == "qkv":         # (3*H*hd, D) -> (D, 3, H, hd)
        out = arr.T.reshape(arr.shape[1], 3, num_heads, -1)
    elif path[-1] == "out":       # (D, H*hd) -> (H, hd, D)
        out = arr.T.reshape(num_heads, -1, arr.shape[0])
    elif arr.ndim == 4:           # OIHW -> HWIO
        out = arr.transpose(2, 3, 1, 0)
    elif arr.ndim == 2:
        out = arr.T
    else:
        raise ValueError(f"weight {key} of rank {arr.ndim}: expected a "
                         "conv (4), dense (2) or LayerNorm (1) weight")
    return path + ("kernel",), out


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves, nested) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _walk(tree):
        key, value = _leaf_from_flax(path, arr)
        out[key] = torch.from_numpy(value)
    return out


def _optax_trace(opt_state):
    """The momentum `trace` of optax.sgd's state tuple (its one element
    that has one)."""
    traces = [s for s in opt_state if hasattr(s, "trace")]
    if len(traces) != 1:
        raise ValueError(f"expected one momentum trace in the optax state, "
                         f"found {len(traces)}")
    return traces[0].trace


def momentum_from_optax(opt_state) -> Dict[str, torch.Tensor]:
    """optax.sgd's state (numpy leaves, Flax layout) -> the port's momentum
    buffers keyed like its state_dict, through the params' maps."""
    return params_from_flax(_optax_trace(opt_state))


def momentum_shard_from_optax(opt_state, rank: int,
                              num_shards: int) -> torch.Tensor:
    """The momentum of a JAX ZeRO-1/2 state -> rank `rank`'s (S,) fp32
    shard: the trace is the (T,) flat vector (bucket-major under
    buckets, the canonical ravel otherwise) and rank r holds row r of
    its (num_shards, S) view."""
    vec = np.asarray(_optax_trace(opt_state), np.float32)
    if vec.ndim != 1 or vec.size % num_shards:
        raise ValueError(f"a ZeRO momentum trace is one flat vector that "
                         f"splits over {num_shards} ranks, got shape "
                         f"{vec.shape}")
    if not 0 <= rank < num_shards:
        raise ValueError(f"rank {rank} outside [0, {num_shards})")
    return torch.from_numpy(vec.reshape(num_shards, -1)[rank].copy())


def momentum_global_from_shards(shards: Sequence[torch.Tensor]
                                ) -> np.ndarray:
    """The inverse: the ranks' (S,) shards, in rank order -> the (T,) flat
    vector a JAX ZeRO state holds."""
    return np.concatenate([s.detach().cpu().float().numpy()
                           for s in shards])


def flax_leaves(shapes: Mapping[str, Sequence[int]], *,
                num_heads: Optional[int] = None
                ) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """The port's parameter names and shapes -> (Flax name such as
    ``conv1/kernel``, the port's name, the Flax shape) for every leaf, in
    the JAX package's `jax.tree.leaves` order (sorted paths)."""
    out = []
    for key, shape in shapes.items():
        path, arr = _flax_leaf_view(key, np.empty(tuple(shape), np.uint8),
                                    num_heads)
        out.append((path, key, tuple(arr.shape)))
    out.sort(key=lambda leaf: leaf[0])
    return [("/".join(path), key, shape) for path, key, shape in out]


def flax_view(key: str, t: torch.Tensor) -> torch.Tensor:
    """A view of the port's tensor `key` whose C-order elements are those
    of its Flax leaf (the maps of `_leaf_to_flax`): conv weights OIHW ->
    HWIO and 2-D weights (dense, ViT's qkv and out) transposed; every
    other leaf is already in Flax order. Writing into the view writes the
    tensor."""
    layer, _, leaf = key.rpartition(".")
    if layer and leaf == "weight" and t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    if layer and leaf == "weight" and t.dim() == 2:
        return t.t()
    return t


def params_to_flax(state_dict: Mapping[str, torch.Tensor], *,
                   num_heads: Optional[int] = None) -> dict:
    """The port's state_dict -> nested Flax param tree of numpy arrays.
    `num_heads` is needed for ViT's fused qkv and out leaves."""
    tree: dict = {}
    for key, value in state_dict.items():
        path, arr = _leaf_to_flax(key, value.detach().cpu().numpy(),
                                  num_heads)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return tree


def load_npz(path: str) -> dict:
    """Flax param tree from a flat ``'layer/leaf'`` npz."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


#: Layers whose Flax scale starts at zero (the JAX ResNet's `bn3`,
#: `scale_init=nn.initializers.zeros`: an identity residual branch at init)
_ZERO_SCALE_LAYERS = ("bn3",)


def init_params(model_cfg: ModelConfig, seed: int, *,
                image_size: int = 224) -> dict:
    """Seeded Flax param tree for `model_cfg` at `image_size`, drawn leaf
    by leaf from one `torch.Generator` with the Flax initializers:
    lecun-normal kernels (normal truncated at two standard deviations,
    stddev sqrt(1/fan_in) corrected for the truncation, fan_in over the
    contracted axes), zero biases, LayerNorm and BatchNorm scales of one
    (zero for ResNet's `bn3`), a zero cls token and a normal(0.02)
    position embedding. The BatchNorm statistics are
    `init_batch_stats`'."""
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    model = build_model(model_cfg, image_size=image_size)
    num_heads = getattr(model, "num_heads", None)
    gen = torch.Generator().manual_seed(int(seed))
    tree: dict = {}
    for name, param in model.named_parameters():
        path, like = _flax_leaf_view(name, np.empty(tuple(param.shape),
                                                    np.uint8), num_heads)
        leaf = path[-1]
        if leaf in ("bias", "cls"):
            value = np.zeros(like.shape, np.float32)
        elif leaf == "scale":
            value = (np.zeros if path[-2] in _ZERO_SCALE_LAYERS
                     else np.ones)(like.shape, np.float32)
        elif leaf == "pos_embed":
            value = (torch.randn(like.shape, generator=gen)
                     * 0.02).numpy()
        else:
            std = math.sqrt(1.0 / math.prod(param.shape[1:])) / _TRUNC_STD
            kernel = torch.empty(like.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std,
                                        2.0 * std, generator=gen)
            value = kernel.numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def init_batch_stats(model_cfg: ModelConfig, *,
                     image_size: int = 224) -> dict:
    """The Flax `batch_stats` tree of a fresh `model_cfg` model, as
    Flax's init makes it: every BatchNorm's `mean` zeros and `var` ones
    (an empty tree for a model without BatchNorm)."""
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.ops.batch_norm import batch_stats_of
    stats = batch_stats_of(build_model(model_cfg, image_size=image_size))
    return params_to_flax(stats)


def load_params(model: torch.nn.Module, tree: Mapping,
                batch_stats: Optional[Mapping] = None) -> torch.nn.Module:
    """Load a Flax param tree, and a Flax `batch_stats` tree for a model
    with BatchNorm, into `model`: strict over parameters and buffers
    both, so a ResNet loaded without its statistics raises."""
    state = params_from_flax(tree)
    state.update(params_from_flax(batch_stats or {}))
    model.load_state_dict(state, strict=True)
    return model

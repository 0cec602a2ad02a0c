"""Weight bridge between the Flax param tree and the port's state_dict.

The Flax tree holds ``{layer: {"kernel", "bias"}}`` with conv kernels
HWIO and dense kernels (in, out); the port holds ``layer.weight`` OIHW or
(out, in) and ``layer.bias``. Both directions are transposes, so the round
trip is bitwise. fc6 needs no row permutation: the port flattens pool5 in
NHWC order, as Flax does.

`load_npz` reads the flat ``'conv1/kernel'`` npz the JAX package's
`train/distill.py save_params` writes; `init_params` makes a seeded
lecun-normal tree for runs without a weights file. `momentum_from_optax`
maps optax's SGD momentum trace (a param-shaped tree) through the same
transposes, so a port run can continue a JAX run.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from distributed_vgg_f_tpu_torch.config import ModelConfig

#: stddev correction of a normal truncated at two standard deviations
#: (the lecun_normal initializer's truncated_normal variance scaling)
_TRUNC_STD = 0.87962566103423978


def _to_torch_layout(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 4:       # HWIO -> OIHW
        return kernel.transpose(3, 2, 0, 1)
    if kernel.ndim == 2:       # (in, out) -> (out, in)
        return kernel.T
    raise ValueError(f"kernel of rank {kernel.ndim}: expected a conv (4) or "
                     "dense (2) kernel")


def _to_flax_layout(weight: np.ndarray) -> np.ndarray:
    if weight.ndim == 4:       # OIHW -> HWIO
        return weight.transpose(2, 3, 1, 0)
    if weight.ndim == 2:
        return weight.T
    raise ValueError(f"weight of rank {weight.ndim}: expected a conv (4) or "
                     "dense (2) weight")


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for layer, leaves in tree.items():
        if set(leaves) != {"kernel", "bias"}:
            raise ValueError(f"layer {layer!r} has leaves {sorted(leaves)}; "
                             "expected kernel and bias")
        kernel = _to_torch_layout(np.asarray(leaves["kernel"]))
        out[f"{layer}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel))
        out[f"{layer}.bias"] = torch.from_numpy(
            np.array(leaves["bias"], copy=True))
    return out


def momentum_from_optax(opt_state) -> Dict[str, torch.Tensor]:
    """optax.sgd's state (numpy leaves, Flax layout) -> the port's momentum
    buffers keyed like its state_dict: the one element of the state
    tuple that holds a momentum `trace`, through the params' transposes."""
    traces = [s for s in opt_state if hasattr(s, "trace")]
    if len(traces) != 1:
        raise ValueError(f"expected one momentum trace in the optax state, "
                         f"found {len(traces)}")
    return params_from_flax(traces[0].trace)


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict -> Flax param tree of numpy arrays."""
    tree: dict = {}
    for key, value in state_dict.items():
        layer, _, leaf = key.rpartition(".")
        arr = value.detach().cpu().numpy()
        if leaf == "weight":
            tree.setdefault(layer, {})["kernel"] = np.ascontiguousarray(
                _to_flax_layout(arr))
        elif leaf == "bias":
            tree.setdefault(layer, {})["bias"] = arr.copy()
        else:
            raise ValueError(f"unexpected state_dict key {key!r}")
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


def init_params(model_cfg: ModelConfig, seed: int, *,
                image_size: int = 224) -> dict:
    """Seeded Flax param tree for `model_cfg` at `image_size`: lecun-normal
    kernels (normal truncated at two standard deviations, stddev
    sqrt(1/fan_in) corrected for the truncation) and zero biases, drawn
    layer by layer from one `torch.Generator`."""
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    model = build_model(model_cfg, image_size=image_size)
    gen = torch.Generator().manual_seed(int(seed))
    tree: dict = {}
    for name, param in model.named_parameters():
        layer, _, leaf = name.rpartition(".")
        if leaf == "bias":
            tree.setdefault(layer, {})["bias"] = np.zeros(
                tuple(param.shape), np.float32)
            continue
        shape = _to_flax_layout(np.empty(tuple(param.shape), np.uint8)).shape
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / _TRUNC_STD
        kernel = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=gen)
        tree.setdefault(layer, {})["kernel"] = kernel.numpy()
    return tree


def load_params(model: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load a Flax param tree into `model` (every parameter, exactly)."""
    model.load_state_dict(params_from_flax(tree), strict=True)
    return model

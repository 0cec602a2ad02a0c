"""Model registry: `build_model(cfg.model, image_size=...)` returns an
`nn.Module` whose `forward(images)` yields fp32 logits. The module's
parameters are uninitialized until weights.py loads them."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from distributed_vgg_f_tpu_torch.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_REGISTRY: Dict[str, Callable[[ModelConfig, int], nn.Module]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available_models():
    return sorted(_REGISTRY)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not one of "
                         f"{sorted(_DTYPES)}") from None


def build_model(cfg: ModelConfig, *, image_size: int = 224) -> nn.Module:
    try:
        make = _REGISTRY[cfg.name]
    except KeyError:
        raise KeyError(f"unknown model {cfg.name!r}; available: "
                       f"{available_models()}") from None
    return make(cfg, image_size)


@register("vggf")
def _build_vggf(cfg: ModelConfig, image_size: int) -> nn.Module:
    from distributed_vgg_f_tpu_torch.models.vggf import VGGF
    return VGGF(cfg.num_classes, compute_dtype=compute_dtype(cfg),
                image_size=image_size, dropout_rate=cfg.dropout_rate,
                **cfg.extra)


@register("vggf_student")
def _build_vggf_student(cfg: ModelConfig, image_size: int) -> nn.Module:
    # Half-width CNN-F (stem 32, convs 128, FC 2048): the distillation
    # target served as the student tier.
    from distributed_vgg_f_tpu_torch.models.vggf import VGGF
    return VGGF(cfg.num_classes, compute_dtype=compute_dtype(cfg),
                image_size=image_size, stem_features=32, conv_features=128,
                fc_features=2048, dropout_rate=cfg.dropout_rate, **cfg.extra)


@register("vgg16")
def _build_vgg16(cfg: ModelConfig, image_size: int) -> nn.Module:
    # `cfg.extra`: block_sizes, block_features; `image_size` sizes fc6
    from distributed_vgg_f_tpu_torch.models.vgg16 import VGG16
    return VGG16(cfg.num_classes, compute_dtype=compute_dtype(cfg),
                 image_size=image_size, dropout_rate=cfg.dropout_rate,
                 **cfg.extra)


@register("resnet50")
def _build_resnet50(cfg: ModelConfig, image_size: int) -> nn.Module:
    # `cfg.extra`: stage_sizes, bn_axis_name, stem; the model is the same
    # at any image size (a spatial mean before the head) and has no
    # dropout, as JAX's registry passes none
    from distributed_vgg_f_tpu_torch.models.resnet import ResNet50
    return ResNet50(cfg.num_classes, compute_dtype=compute_dtype(cfg),
                    **cfg.extra)


@register("vit_s16")
def _build_vit_s16(cfg: ModelConfig, image_size: int) -> nn.Module:
    # `cfg.extra` carries ViT's overrides: hidden_dim, depth, num_heads,
    # mlp_dim, patch_size, attention_layout, attention_dropout_rate;
    # `image_size` sizes pos_embed
    from distributed_vgg_f_tpu_torch.models.vit import ViT
    return ViT(cfg.num_classes, compute_dtype=compute_dtype(cfg),
               image_size=image_size, dropout_rate=cfg.dropout_rate,
               **cfg.extra)

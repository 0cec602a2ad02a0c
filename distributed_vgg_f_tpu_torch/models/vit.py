"""ViT-S/16 (Dosovitskiy et al. 2020; DeiT-S widths): patch 16, width 384,
depth 12, 6 heads, MLP 1536, a cls token and learned position
embeddings — the counterpart of the JAX package's ``models/vit.py``.

The public layout is the JAX one: NHWC images in, fp32 logits out, and
parameters that map one to one onto the Flax tree (weights.py). The
places where the two frameworks differ are pinned here:

- Flax's `nn.gelu` is the tanh approximation: ``F.gelu(approximate=
  "tanh")``.
- Flax's LayerNorm runs in fp32 with eps 1e-6 and returns fp32; the next
  projection casts its input to the compute dtype.
- The fused QKV projection's output features are ordered (3, H, hd),
  row-major, and the out projection contracts (H, hd).
- The patch embedding flattens tokens in (h, w) row-major order; the cls
  token is prepended and the position embedding added in the compute
  dtype; the head reads token 0 after `ln_final` and returns fp32.
- Dense layers cast input, weight and bias to the compute dtype and add
  the bias after the product, as Flax's `Dense(dtype=...)` does.
- Dropout follows Flax's `Dropout`: keep with probability 1-p, kept
  values divided by 1-p in the input's dtype; the bits come from the
  `torch.Generator` the train step passes.

Attention layouts (`attention_layout`):

- "head_major": (B, T, 3, H, hd) -> (3, B, H, T, hd), q scaled by
  1/sqrt(hd) before QK^T, fp32 softmax, probabilities in the compute
  dtype (attention-weight dropout applies here).
- "token_major": the same einsums on the (B, T, H, hd) slices.
- "flash": `ops.flash_attention.flash_self_attention` on the three
  (B, T, H, hd) slices of the QKV output (no copy); the scale multiplies
  the fp32 scores inside. The (T, T) probabilities never exist, so
  attention-weight dropout is refused when the module is built.
- "auto" is refused: the JAX package picks flash from a token count
  measured on a TPU, and the crossover on the card is still to be
  measured (ROADMAP B8).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_vgg_f_tpu_torch.models.ingest import reject_raw_uint8
from distributed_vgg_f_tpu_torch.ops.flash_attention import \
    flash_self_attention

LAYOUTS = ("head_major", "token_major", "flash")
#: Flax LayerNorm's epsilon
LN_EPS = 1e-6


def check_layout(layout: str, attention_dropout_rate: float) -> None:
    """Refuse what the port cannot run: "auto", an unknown layout, and
    flash with attention-weight dropout."""
    if layout == "auto":
        raise ValueError(
            "attention_layout 'auto' is not ported: its switch to flash at "
            "8192 tokens was measured on a TPU, and the crossover on the "
            "card is still to be measured (ROADMAP B8); pick 'flash', "
            "'head_major' or 'token_major'")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown attention layout {layout!r}; one of "
                         f"{LAYOUTS}")
    if layout == "flash" and attention_dropout_rate > 0.0:
        raise ValueError(
            f"attention layout 'flash' never materializes the attention "
            f"weights — incompatible with attention-weight dropout_rate="
            f"{attention_dropout_rate}; pick an einsum layout "
            f"('head_major'/'token_major') or set "
            f"model.extra.attention_dropout_rate=0")


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Flax `Dropout` in training: where(keep, x / (1 - rate), 0), keep
    drawn with probability 1 - rate. Saves only the boolean mask for the
    backward."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """A Flax `Dense`/`DenseGeneral` in the compute dtype: y = x W^T + b
    with x, W and b cast to `dtype`. `weight` is (out, in) with the
    Flax kernel's output (and input) axes flattened row-major."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype)) \
            + self.bias.to(self.dtype)


class PatchEmbed(nn.Module):
    """Flax `Conv(p x p, stride p, VALID)` in the compute dtype: `weight`
    OIHW (D, 3, p, p), the bias added after the product."""

    def __init__(self, patch_size: int, hidden_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.weight = nn.Parameter(
            torch.empty(hidden_dim, 3, patch_size, patch_size))
        self.bias = nn.Parameter(torch.empty(hidden_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> (B, h*w, D) tokens in (h, w) row-major order."""
        cd = self.dtype
        y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), self.weight.to(cd), None,
                     self.patch_size)
        y = y + self.bias.to(cd).view(1, -1, 1, 1)
        return y.flatten(2).transpose(1, 2)


class LayerNorm(nn.Module):
    """Flax `LayerNorm(dtype=float32)`: fp32 statistics and output, eps
    1e-6; `weight` is Flax's `scale`."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, LN_EPS)


class FusedSelfAttention(nn.Module):
    """Self-attention with one fused QKV projection (Flax `qkv`, kernel
    (D, 3, H, hd)) and an out projection contracting (H, hd) (Flax
    `out`, kernel (H, hd, D))."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype, *, layout: str = "head_major",
                 dropout_rate: float = 0.0):
        super().__init__()
        check_layout(layout, dropout_rate)
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.layout = layout
        self.dropout_rate = float(dropout_rate)
        self.qkv = Dense(hidden_dim, 3 * hidden_dim, dtype)
        self.out = Dense(hidden_dim, hidden_dim, dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        hd = d // h
        qkv = self.qkv(x).view(b, t, 3, h, hd)
        if self.layout == "flash":
            q, k, v = qkv.unbind(2)
            ctx = flash_self_attention(q, k, v)      # (B, T, H, hd)
            return self.out(ctx.reshape(b, t, d))
        scale = 1.0 / math.sqrt(hd)
        if self.layout == "head_major":
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)   # (B, H, T, hd)
            scores = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
        else:
            q, k, v = qkv.unbind(2)                          # (B, T, H, hd)
            scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
        probs = torch.softmax(scores.float(), dim=-1).to(qkv.dtype)
        if train and self.dropout_rate > 0.0:
            probs = dropout(probs, self.dropout_rate, generator)
        if self.layout == "head_major":
            ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
            return self.out(ctx.permute(0, 2, 1, 3).reshape(b, t, d))
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(ctx.reshape(b, t, d))


class MlpBlock(nn.Module):
    def __init__(self, hidden_dim: int, mlp_dim: int, dtype: torch.dtype,
                 dropout_rate: float):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.fc1 = Dense(hidden_dim, mlp_dim, dtype)
        self.fc2 = Dense(mlp_dim, hidden_dim, dtype)

    def forward(self, x, *, train: bool = False, generator=None):
        drop = train and self.dropout_rate > 0.0
        x = F.gelu(self.fc1(x), approximate="tanh")
        if drop:
            x = dropout(x, self.dropout_rate, generator)
        x = self.fc2(x)
        if drop:
            x = dropout(x, self.dropout_rate, generator)
        return x


class EncoderBlock(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, dropout_rate: float, *,
                 attention_dropout_rate: float = 0.0,
                 attention_layout: str = "head_major"):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.ln1 = LayerNorm(hidden_dim)
        self.attn = FusedSelfAttention(hidden_dim, num_heads, dtype,
                                       layout=attention_layout,
                                       dropout_rate=attention_dropout_rate)
        self.ln2 = LayerNorm(hidden_dim)
        self.mlp = MlpBlock(hidden_dim, mlp_dim, dtype, dropout_rate)

    def forward(self, x, *, train: bool = False, generator=None):
        y = self.attn(self.ln1(x), train=train, generator=generator)
        if train and self.dropout_rate > 0.0:
            y = dropout(y, self.dropout_rate, generator)
        x = x + y
        return x + self.mlp(self.ln2(x), train=train, generator=generator)


class ViT(nn.Module):
    def __init__(self, num_classes: int = 1000, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224, patch_size: int = 16,
                 hidden_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_dim: int = 1536, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 attention_layout: str = "head_major"):
        super().__init__()
        check_layout(attention_layout, attention_dropout_rate)
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{dropout_rate}")
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple "
                             f"of patch_size {patch_size}")
        self.compute_dtype = compute_dtype
        self.num_heads = int(num_heads)
        self.dropout_rate = float(dropout_rate)
        self.attention_dropout_rate = float(attention_dropout_rate)
        tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(patch_size, hidden_dim, compute_dtype)
        self.cls = nn.Parameter(torch.empty(1, 1, hidden_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, hidden_dim))
        # named block0 .. block{depth-1}, as the Flax tree names them
        self.depth = int(depth)
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                hidden_dim, num_heads, mlp_dim, compute_dtype, dropout_rate,
                attention_dropout_rate=attention_dropout_rate,
                attention_layout=attention_layout))
        self.ln_final = LayerNorm(hidden_dim)
        self.head = Dense(hidden_dim, num_classes, compute_dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """NHWC images (finished, not raw u8) -> fp32 logits. `train=True`
        turns dropout on, drawing its bits from `generator` (on the
        input's device), which is then required."""
        reject_raw_uint8(x, "ViT")
        if train and generator is None and (
                self.dropout_rate > 0.0 or self.attention_dropout_rate > 0.0):
            raise ValueError("ViT(train=True) draws its dropout bits from "
                             "an explicit torch.Generator; pass generator=")
        cd = self.compute_dtype
        x = self.patch_embed(x)
        cls = self.cls.to(cd).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cd)
        if train and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, generator)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, train=train,
                                           generator=generator)
        x = self.ln_final(x)[:, 0]
        return self.head(x).float()

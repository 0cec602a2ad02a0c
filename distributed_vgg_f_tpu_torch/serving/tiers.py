"""Latency tiers of the predict server: bf16, int8 and student engines
behind one router — the counterpart of the JAX package's
``serving/tiers.py``.

Each tier is a full `PredictEngine` with its own bucket ladder over its
own forward, so a tier's served answer is its own `engine.run`'s bits.
The ladder:

- **fp32** — the base engine, unchanged.
- **bf16** — a second instance of the base's architecture at bfloat16
  compute, its parameters cast to bf16 once at build (not per forward;
  the BatchNorm statistics stay fp32, buffers, not parameters), the
  finish normalizing in fp32 and casting to bf16, the logits fp32.
- **int8** — post-training quantization of CNN-F's FC heads (fc6, fc7,
  fc8: ~90 % of its parameters): per-out-channel symmetric int8 weights,
  per-tensor activation scales from a calibration pass over the u8 wire
  (`calibrate`). Under a per-tensor scale a channel whose calibrated
  range stays below half an LSB rounds to zero, so its row of the next
  weight matrix contributes nothing: the tier drops those channels from
  its GEMMs. On calibration-range inputs the compacted heads compute what
  dense int8 emulation (`dense_int8_reference`) computes. The trunk
  (`VGGF.trunk`) runs at the base's compute dtype, its two LRN sites on
  the hand kernel.
- **student** — the half-width `vggf_student` (train/distill.py) serving
  the flagship's route: the same wire, the same classes.

Execution of the int8 heads: the weights are kept int8 with fp32 scales
(that is what the HBM estimate counts); the heads run as fp32 GEMMs over
the folded constants ``wq * a * s`` (plain `torch.matmul`: the JAX
package runs them as XLA dots, not as a kernel of its own), while the
activations are rounded and clipped onto the int8 grid, so the numbers
are int8's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from distributed_vgg_f_tpu_torch.config import (SERVING_TIERS,
                                                ServingTiersConfig)
from distributed_vgg_f_tpu_torch.data.device_ingest import make_device_finish
from distributed_vgg_f_tpu_torch.serving.engine import PredictEngine

#: Router vocabulary, descending fidelity.
TIERS = SERVING_TIERS

#: The FC head stack the int8 tier quantizes (CNN-F's names,
#: models/vggf.py); the int8 builder refuses architectures without it.
_HEAD_LAYERS = ("fc6", "fc7", "fc8")


# --------------------------------------------------------------------- bf16
def _clone_at(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """A copy of `model` computing in `dtype`, its fp32 parameters cast to
    `dtype` (buffers, the BatchNorm statistics, keep theirs)."""
    clone = copy.deepcopy(model)
    for m in clone.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    with torch.no_grad():
        for p in clone.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return clone


def build_bf16_engine(base: PredictEngine) -> PredictEngine:
    """The bf16 tier: the base's architecture at bfloat16 compute, its
    parameters cast once, the wire finished into bf16; logits fp32."""
    return PredictEngine(
        model_name=base.model_name,
        model=_clone_at(base._model, torch.bfloat16),
        image_size=base.image_size, num_classes=base.num_classes,
        buckets=base.buckets, max_batch=base.buckets[-1],
        image_dtype="bfloat16", mean_rgb=base._mean, stddev_rgb=base._std,
        device=base.device, tier="bf16")


# --------------------------------------------------------------------- int8
@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """The activation-range pass: one per-tensor scale per head input and
    the kept-channel index sets derived from them. `receipt()` is the
    JSON a re-run reproduces the quantization from."""
    scales: Dict[str, float]          # head layer -> activation LSB a
    keep: Dict[str, np.ndarray]       # head layer -> kept input channels
    widths: Dict[str, int]            # head layer -> dense input width
    batches: int
    batch_size: int
    seed: int

    def receipt(self) -> dict:
        return {"scales": {k: float(v) for k, v in self.scales.items()},
                "kept": {k: int(len(v)) for k, v in self.keep.items()},
                "widths": {k: int(v) for k, v in self.widths.items()},
                "batches": self.batches, "batch_size": self.batch_size,
                "seed": self.seed}


def calibration_images(image_size: int, *, batches: int, batch_size: int,
                       seed: int) -> np.ndarray:
    """The deterministic u8-wire calibration stream: the teacher task's
    procedural textures (data/teacher.py `_raw_images`) at a seeded index
    range disjoint from its train and eval ranges."""
    from distributed_vgg_f_tpu_torch.data.teacher import _raw_images
    n = batches * batch_size
    idx = np.arange(n) + (int(seed) << 16) + (1 << 24)
    raw = _raw_images(idx, image_size, base_seed=11)
    return np.clip(np.rint(raw), 0, 255).astype(np.uint8)


def _split_params(params):
    """(trunk_params, head_params) of a Flax-layout tree — refuses
    non-CNN-F head stacks."""
    p = {k: v for k, v in dict(params).items()}
    missing = [k for k in _HEAD_LAYERS if k not in p]
    if missing:
        raise ValueError(
            f"int8 tier needs the CNN-F head stack {list(_HEAD_LAYERS)}; "
            f"params are missing {missing} — only the vggf family serves "
            "this tier")
    heads = {k: p.pop(k) for k in _HEAD_LAYERS}
    return p, heads


def _head_tree(model: torch.nn.Module) -> dict:
    """The model's top-level layers as a Flax-layout tree for
    `_split_params`: each dense layer's kernel (in, out) and bias in fp32
    numpy, every other layer an empty entry."""
    tree = {}
    for name, m in model.named_children():
        w = getattr(m, "weight", None)
        if name in _HEAD_LAYERS and w is not None and w.dim() == 2:
            tree[name] = {
                "kernel": w.detach().float().cpu().numpy().T,
                "bias": m.bias.detach().float().cpu().numpy()}
        else:
            tree[name] = {}
    return tree


def _trunk_view(model: torch.nn.Module) -> torch.nn.Module:
    """The model without its heads, sharing the trunk's tensors: what the
    int8 tier keeps of the base model (and counts in its HBM
    estimate)."""
    view = copy.copy(model)
    view._modules = {k: m for k, m in model._modules.items()
                     if k not in _HEAD_LAYERS}
    return view


def _make_trunk(model, finish):
    """u8 images -> the trunk's output (pool5 flattened) in fp32."""

    def trunk(images: torch.Tensor) -> torch.Tensor:
        return model.trunk(finish(images)).float()

    return trunk


def quantize_dense(kernel: np.ndarray):
    """Per-OUT-channel symmetric int8 weight quantization of an (in, out)
    kernel: `scale_j = max_i |W_ij| / 127`, `Wq = clip(round(W /
    scale), ±127)`. Returns (int8 kernel, fp32 per-column scales)."""
    w = np.asarray(kernel, np.float32)
    scale = np.max(np.abs(w), axis=0) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    wq = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return wq, scale


def calibrate(base: PredictEngine, images: np.ndarray, *,
              batch_size: int, seed: int) -> CalibrationResult:
    """The activation-range pass over the u8 wire: run the base forward
    on the calibration stream, capturing each head layer's input; the
    per-tensor max sets the activation LSB a = max/127, the per-channel
    maxima which channels stay below a/2 (and so always quantize to
    zero)."""
    model = base._model
    # the fp32 finish, as the JAX package's calibration uses
    finish = make_device_finish(base._mean, base._std)

    def head_inputs(imgs: np.ndarray):
        with torch.inference_mode():
            t = model.trunk(finish(torch.from_numpy(imgs).to(base.device)))
            h6 = F.relu(model._dense(model.fc6, t))
            h7 = F.relu(model._dense(model.fc7, h6))
            return [x.float().cpu().numpy() for x in (t, h6, h7)]

    per_channel = {k: None for k in _HEAD_LAYERS}
    n = int(images.shape[0])
    batches = 0
    for i in range(0, n, batch_size):
        chunk = images[i:i + batch_size]
        if chunk.shape[0] != batch_size:
            break  # one batch geometry, as the JAX package's pass
        batches += 1
        for layer, x in zip(_HEAD_LAYERS, head_inputs(chunk)):
            m = np.max(np.abs(x), axis=0)
            per_channel[layer] = m if per_channel[layer] is None \
                else np.maximum(per_channel[layer], m)
    if batches == 0:
        raise ValueError(
            f"calibration stream of {n} images yields no full batch of "
            f"{batch_size}")
    scales, keep, widths = {}, {}, {}
    for layer, m in per_channel.items():
        a = float(np.max(m)) / 127.0
        if a <= 0:
            raise ValueError(
                f"calibration saw an all-zero input to {layer} — the "
                "weights are untrained garbage or the stream is empty")
        scales[layer] = a
        # below half an LSB, clip(round(x / a)) is 0: dropping these
        # channels is int8-exact on calibration-range data
        keep[layer] = np.flatnonzero(m >= a / 2).astype(np.int32)
        widths[layer] = int(m.size)
    return CalibrationResult(scales=scales, keep=keep, widths=widths,
                             batches=batches, batch_size=int(batch_size),
                             seed=int(seed))


def _quantized_heads(params, calib: CalibrationResult):
    """Quantize and compact the head stack of a Flax-layout tree. Returns
    (the folded fp32 constants the tier runs, the int8 residency bytes
    the HBM estimate counts)."""
    _, heads = _split_params(params)
    k6, k7, k8 = (calib.keep[layer] for layer in _HEAD_LAYERS)
    a6, a7, a8 = (calib.scales[layer] for layer in _HEAD_LAYERS)
    folded, int8_bytes = {}, 0
    for layer, a, rows, cols in (("fc6", a6, k6, k7), ("fc7", a7, k7, k8),
                                 ("fc8", a8, k8, None)):
        w = np.asarray(heads[layer]["kernel"], np.float32)
        b = np.asarray(heads[layer]["bias"], np.float32)
        wq, s = quantize_dense(w)
        wq = wq[rows]
        if cols is not None:
            wq, s, b = wq[:, cols], s[cols], b[cols]
        # run as the dequantized constant; stored as int8 + fp32 scales
        folded[layer] = {"w": wq.astype(np.float32) * (a * s), "b": b}
        int8_bytes += wq.size + s.size * 4 + b.size * 4
    return folded, int8_bytes


def _q(x: torch.Tensor, a: float) -> torch.Tensor:
    return torch.clamp(torch.round(x / a), -127, 127)


def dense_int8_reference(params, calib: CalibrationResult):
    """Dense int8 emulation (no elision) with the same scales: the oracle
    the compacted tier is held to. Returns heads(x fp32) -> fp32
    logits."""
    _, heads = _split_params(params)
    mats = {}
    for layer in _HEAD_LAYERS:
        wq, s = quantize_dense(np.asarray(heads[layer]["kernel"]))
        a = calib.scales[layer]
        mats[layer] = (torch.from_numpy(wq.astype(np.float32) * (a * s)),
                       torch.from_numpy(np.asarray(heads[layer]["bias"],
                                                   np.float32)))

    def heads_fn(x: torch.Tensor) -> torch.Tensor:
        def dense(layer, h):
            w, b = mats[layer]
            return _q(h, calib.scales[layer]) @ w.to(h.device) \
                + b.to(h.device)
        x = F.relu(dense("fc6", x))
        x = F.relu(dense("fc7", x))
        return dense("fc8", x)

    return heads_fn


def build_int8_engine(base: PredictEngine,
                      calib: Optional[CalibrationResult] = None, *,
                      tiers_cfg: Optional[ServingTiersConfig] = None
                      ) -> PredictEngine:
    """The int8 tier over a base engine: calibrate (unless handed a
    `CalibrationResult`), quantize and compact the heads, and serve the
    trunk -> activation-quantized compacted GEMMs -> fp32 softmax on a
    bucket ladder of its own."""
    params = _head_tree(base._model)
    _split_params(params)
    if not callable(getattr(base._model, "trunk", None)):
        raise ValueError(f"int8 tier runs the CNN-F trunk; "
                         f"{type(base._model).__name__} has none — only "
                         "the vggf family serves this tier")
    cfg = tiers_cfg if tiers_cfg is not None else ServingTiersConfig()
    if calib is None:
        images = calibration_images(
            base.image_size, batches=cfg.calibration_batches,
            batch_size=cfg.calibration_batch_size,
            seed=cfg.calibration_seed)
        calib = calibrate(base, images,
                          batch_size=cfg.calibration_batch_size,
                          seed=cfg.calibration_seed)
    folded, int8_bytes = _quantized_heads(params, calib)
    dev = base.device
    trunk_model = _trunk_view(base._model)
    trunk = _make_trunk(trunk_model, make_device_finish(base._mean,
                                                        base._std))
    k6 = torch.from_numpy(calib.keep["fc6"].astype(np.int64)).to(dev)
    a6, a7, a8 = (calib.scales[layer] for layer in _HEAD_LAYERS)
    (w6, b6), (w7, b7), (w8, b8) = (
        (torch.from_numpy(np.ascontiguousarray(folded[layer]["w"])).to(dev),
         torch.from_numpy(np.ascontiguousarray(folded[layer]["b"])).to(dev))
        for layer in _HEAD_LAYERS)

    def forward(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = trunk(images)
            x = F.relu(torch.index_select(_q(x, a6), 1, k6) @ w6 + b6)
            x = F.relu(_q(x, a7) @ w7 + b7)
            logits = _q(x, a8) @ w8 + b8
            return torch.softmax(logits.float(), dim=-1)

    eng = PredictEngine(
        model_name=base.model_name, model=trunk_model,
        image_size=base.image_size, num_classes=base.num_classes,
        buckets=base.buckets, max_batch=base.buckets[-1],
        image_dtype=base._image_dtype, mean_rgb=base._mean,
        stddev_rgb=base._std, device=dev, tier="int8", forward=forward,
        extra_param_bytes=int8_bytes)
    eng.calibration = calib
    return eng


# ------------------------------------------------------------------ student
def build_student_engine(base: PredictEngine, *,
                         student_model: torch.nn.Module,
                         student_params=None, student_batch_stats=None
                         ) -> PredictEngine:
    """The student tier: the distilled half-width architecture serving the
    flagship's route — its own forward and ladder, the flagship's wire
    and classes. `student_params` (a Flax tree, e.g. weights.load_npz of
    the file train/distill.py writes) is loaded into `student_model`
    when given; otherwise the model holds its weights already."""
    if student_params is not None:
        from distributed_vgg_f_tpu_torch.weights import load_params
        load_params(student_model, student_params, student_batch_stats)
    return PredictEngine(
        model_name=base.model_name, model=student_model,
        image_size=base.image_size, num_classes=base.num_classes,
        buckets=base.buckets, max_batch=base.buckets[-1],
        image_dtype=base._image_dtype, mean_rgb=base._mean,
        stddev_rgb=base._std, device=base.device, tier="student",
        served_by="vggf_student")


def build_tier_engines(base: PredictEngine, cfg: ServingTiersConfig, *,
                       tiers: Sequence[str] = ("bf16", "int8"),
                       calib: Optional[CalibrationResult] = None,
                       student_model=None, student_params=None,
                       student_batch_stats=None) -> Dict[str, PredictEngine]:
    """The requested tier ladder over one base engine. The student tier is
    built when its model is supplied (its weights are not derivable from
    the flagship's checkpoint)."""
    out: Dict[str, PredictEngine] = {}
    for tier in tiers:
        if tier in ("fp32", "student"):
            continue  # the base itself; the student below
        if tier == "bf16":
            out[tier] = build_bf16_engine(base)
        elif tier == "int8":
            out[tier] = build_int8_engine(base, calib, tiers_cfg=cfg)
        else:
            raise ValueError(f"unknown tier {tier!r}; ladder is {TIERS}")
    if student_model is not None:
        out["student"] = build_student_engine(
            base, student_model=student_model, student_params=student_params,
            student_batch_stats=student_batch_stats)
    return out

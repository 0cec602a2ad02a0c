"""Predict mode: classify JPEGs (or u8 arrays) with a trained checkpoint —
the counterpart of the JAX package's ``train/predict.py``, and the single
source of the predict math the serving engine runs (serving/engine.py):
`build_forward` is the forward expression (device finish, model, fp32
softmax) and `top_k_records` the record shape, for both.

`run_predict(trainer, inputs)` restores the trainer's latest checkpoint
(`restore_predict_params`: the EMA weights when the run tracks them;
raises without a checkpoint) and prints one JSON line a file,
``{"file": ..., "top_k": [{"class", "prob"}, ...]}``:

- JPEG files and directories go through the eval decode protocol
  (data/native_jpeg.py `NativeJpegEvalIterator`: the center crop,
  host-normalized float32, the last batch padded and masked);
- `.npy` files of raw u8 (S, S, 3) pixels, all or nothing, skip the
  decode and run through the serving engine's bucketed path, so these
  records and the server's responses come from equal inputs through
  equal code.

Records carry class indices: the wnid index belongs to the imagefolder
layout (ROADMAP A17).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Sequence

import numpy as np
import torch

_JPEG_EXTS = (".jpg", ".jpeg", ".JPG", ".JPEG")
_ARRAY_EXT = ".npy"


def build_forward(model: torch.nn.Module, finish: Callable) -> Callable:
    """images -> fp32 softmax probabilities: the device finish (uint8
    batches normalized once, float batches untouched), the model, then a
    softmax over fp32 logits."""

    def forward(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            logits = model(finish(images))
            return torch.softmax(logits.float(), dim=-1)

    return forward


def top_k_records(row, k: int, full_precision: bool = True) -> list[dict]:
    """One probability row -> its top-k records. The serving responses
    and the array path keep full precision (so they compare bitwise with
    the engine's own run); the JPEG path rounds to 6 digits, as the JAX
    package's does."""
    top = np.argsort(row)[::-1][:k]
    return [{"class": int(c),
             "prob": float(row[c]) if full_precision
             else round(float(row[c]), 6)} for c in top]


def collect_images(inputs: Sequence[str]) -> list[str]:
    """Files and directories (searched for JPEGs) -> a list of paths."""
    out: list[str] = []
    for p in inputs:
        if os.path.isdir(p):
            out.extend(os.path.join(p, f) for f in sorted(os.listdir(p))
                       if f.endswith(_JPEG_EXTS))
        elif os.path.isfile(p):
            out.append(p)
        else:
            raise FileNotFoundError(f"no such file or directory: {p!r}")
    if not out:
        raise FileNotFoundError(f"no images found under {list(inputs)!r}")
    return out


def restore_predict_params(trainer) -> torch.nn.Module:
    """The model of the trainer's checkpoint (`restore_or_init`: the
    latest, or the best slot with `train.restore_from_best`), holding the
    EMA weights and the EMA of the BatchNorm statistics when the run
    tracks them (JAX `train/predict.py:76–77`: the statistics swap with
    the weights), in eval mode. The weights come through
    `trainer.params_tree` (under ZeRO-3, ranks restoring together, a
    collective gather of the shards; a ZeRO-3 checkpoint restored by one
    process is the tree already, checkpoint/retopology.py). Raises
    without a checkpoint: predict never classifies with random weights."""
    if trainer.checkpoints is None \
            or trainer.checkpoints.latest_step() is None:
        raise RuntimeError(
            "predict requires a checkpoint: none found under "
            f"{trainer.cfg.train.checkpoint_dir!r} "
            "(set train.checkpoint_dir)")
    state = trainer.restore_or_init()
    model = state.model
    ema = state.ema_params is not None
    tree = trainer.params_tree(state, ema=ema)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = tree[name]
        if ema:
            stats = state.batch_stats
            for name, v in (state.ema_batch_stats or {}).items():
                stats[name].copy_(v)
    return model.eval()


def _load_u8_array(path: str, size: int) -> np.ndarray:
    arr = np.load(path, allow_pickle=False)
    if arr.dtype != np.uint8 or tuple(arr.shape) != (size, size, 3):
        raise ValueError(
            f"{path}: array inputs must be uint8 ({size}, {size}, 3) raw "
            f"pixels (the u8 wire payload), got {arr.dtype} "
            f"{tuple(arr.shape)}")
    return arr


def _emit(results: list, rec: dict, stream) -> None:
    results.append(rec)
    print(json.dumps(rec), file=stream)


def _predict_arrays(trainer, model, files: list[str], *, top_k: int,
                    batch: int, stream) -> list[dict]:
    """The u8 array path, through the serving engine's bucketed run."""
    from distributed_vgg_f_tpu_torch.serving.engine import PredictEngine
    cfg = trainer.cfg
    engine = PredictEngine(
        model_name=cfg.model.name, model=model,
        image_size=cfg.data.image_size, num_classes=cfg.model.num_classes,
        buckets=(batch,), max_batch=batch,
        image_dtype=cfg.data.image_dtype, mean_rgb=cfg.data.mean_rgb,
        stddev_rgb=cfg.data.stddev_rgb, device=trainer.device)
    k = min(top_k, cfg.model.num_classes)
    results: list[dict] = []
    for start in range(0, len(files), batch):
        chunk = files[start:start + batch]
        probs, _ = engine.run(np.stack(
            [_load_u8_array(p, cfg.data.image_size) for p in chunk]))
        for path, row in zip(chunk, probs):
            _emit(results, {"file": path, "top_k": top_k_records(row, k)},
                  stream)
    return results


def run_predict(trainer, inputs: Sequence[str], *, top_k: int = 5,
                batch: int = 32, stream=None) -> list[dict]:
    """Classify `inputs` with the trainer's checkpoint; prints one JSON
    line an image to `stream` (default stdout) and returns the records.
    `.npy` inputs are all or nothing: mixed with images they raise."""
    from distributed_vgg_f_tpu_torch.data.device_ingest import \
        make_device_finish
    from distributed_vgg_f_tpu_torch.data.native_jpeg import \
        NativeJpegEvalIterator
    stream = stream or sys.stdout
    cfg = trainer.cfg
    files = collect_images(inputs)
    batch = min(batch, max(1, len(files)))
    arrays = [f.endswith(_ARRAY_EXT) for f in files]
    if any(arrays) and not all(arrays):
        raise ValueError("cannot mix .npy array inputs with image files in "
                         "one predict call")
    model = restore_predict_params(trainer)
    if all(arrays):
        return _predict_arrays(trainer, model, files, top_k=top_k,
                               batch=batch, stream=stream)
    forward = build_forward(model, make_device_finish(
        cfg.data.mean_rgb, cfg.data.stddev_rgb,
        image_dtype=cfg.data.image_dtype))
    decoder = NativeJpegEvalIterator(
        files, [0] * len(files), batch, cfg.data.image_size,
        mean=np.asarray(cfg.data.mean_rgb, np.float32),
        std=np.asarray(cfg.data.stddev_rgb, np.float32),
        num_threads=cfg.data.native_threads or None)
    k = min(top_k, cfg.model.num_classes)
    results: list[dict] = []
    try:
        pos = 0
        for b in decoder:
            probs = forward(torch.from_numpy(b["image"]).to(
                trainer.device)).cpu().numpy()
            for row, ok in zip(probs, b["valid"]):
                if ok:
                    _emit(results, {"file": files[pos], "top_k":
                                    top_k_records(row, k,
                                                  full_precision=False)},
                          stream)
                    pos += 1
        if decoder.decode_errors():
            print(f"predict: {decoder.decode_errors()} image(s) failed to "
                  "decode; their predictions are from zero-filled inputs",
                  file=sys.stderr)
    finally:
        decoder.close()
    return results

"""Knowledge distillation for the serving `student` tier — the counterpart
of the JAX package's ``train/distill.py``.

The student (`vggf_student`, models/registry.py: half-width CNN-F) trains
against the teacher task's full logit distribution (data/teacher.py
`Teacher.logits`), not only its argmax labels, with the softened-softmax
head (Hinton et al., arXiv 1503.02531):

    loss = alpha * T^2 * KL(softmax(t/T) || softmax(s/T))
         + (1 - alpha) * CE(s, hard_labels)

where T² keeps the soft-target gradient's scale across temperatures;
alpha = 0 is plain cross-entropy on the teacher's labels.

Batches are normalized with the vggf ingest descriptor's ImageNet
constants, the ones the serving engine's device finish applies to the u8
wire, so the weights written here drop into a `PredictEngine` as they
are. The teacher sees the de-normalized pixels the student sees.

The optimizer is the JAX tool's optax chain, in its order: clip by the
global norm, add the decayed weights, then SGD with momentum (no
dampening, no Nesterov) on a warmup-cosine schedule from 0 (so the first
step's LR is 0). Dropout draws from an explicit `torch.Generator`, and
`init_params` starts the run from given weights (a JAX run's carried
across by weights.py, for one).

The weights file is a flat npz of ``'/'``-joined Flax paths
(`save_params`, `load_params`): each package reads the other's.

    python -m distributed_vgg_f_tpu_torch.train.distill --out student.npz
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from distributed_vgg_f_tpu_torch.models.ingest import ingest_descriptor

#: Disjoint index bases of the teacher task's index space: train draws
#: [0, num_examples), the serving calibration sits at +2^24
#: (serving/tiers.py `calibration_images`), the accuracy-receipt eval
#: shard here.
EVAL_INDEX_BASE = 1 << 20


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 labels: torch.Tensor, *, temperature: float = 2.0,
                 alpha: float = 0.5) -> torch.Tensor:
    """The distillation objective (batch mean). `alpha` mixes the softened
    KL term against hard-label cross-entropy: 0 is plain CE, 1 pure
    distillation."""
    s = student_logits.float()
    t = teacher_logits.float()
    logp_s = F.log_softmax(s / temperature, dim=-1)
    logp_t = F.log_softmax(t / temperature, dim=-1)
    p_t = torch.exp(logp_t)
    kl = torch.sum(p_t * (logp_t - logp_s), dim=-1)
    soft = (temperature ** 2) * torch.mean(kl)
    onehot = F.one_hot(labels.long(), s.shape[-1]).float()
    ce = -torch.mean(torch.sum(onehot * F.log_softmax(s, dim=-1), dim=-1))
    return alpha * soft + (1.0 - alpha) * ce


# ------------------------------------------------------------- params I/O
def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def save_params(path: str, params: Mapping) -> None:
    """A Flax-layout param tree (weights.params_to_flax) as a flat npz of
    '/'-joined paths: the student tier's weights file."""
    np.savez(path, **_flatten(params))


def load_params(path: str) -> dict:
    """The Flax-layout tree of a flat npz (either package's)."""
    from distributed_vgg_f_tpu_torch.weights import load_npz
    return load_npz(path)


# ------------------------------------------------------------ data plumbing
def _serving_norm() -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) as (1, 1, 3): the vggf descriptor's constants, what the
    device finish applies to the u8 wire at serving time."""
    d = ingest_descriptor("vggf")
    return (np.asarray(d.mean_rgb, np.float32).reshape(1, 1, 3),
            np.asarray(d.stddev_rgb, np.float32).reshape(1, 1, 3))


def teacher_eval_shard(image_size: int, num_classes: int,
                       num_examples: int) -> Tuple[np.ndarray, np.ndarray]:
    """The fixed accuracy-receipt shard: u8 images and teacher labels at
    EVAL_INDEX_BASE (disjoint from train and calibration), the labels
    computed on the u8-rounded pixels the serving wire carries."""
    from distributed_vgg_f_tpu_torch.data.teacher import Teacher, _raw_images
    idx = np.arange(num_examples) + EVAL_INDEX_BASE
    raw = _raw_images(idx, image_size, base_seed=11)
    images = np.clip(np.rint(raw), 0, 255).astype(np.uint8)
    teacher = Teacher(image_size, num_classes, seed=7)
    return images, teacher.label(images.astype(np.float32))


def warmup_cosine(lr: float, warmup: int, steps: int
                  ) -> Callable[[int], np.float32]:
    """optax's `warmup_cosine_decay_schedule(0, lr, warmup, steps)`: a
    linear ramp from 0 over `warmup` steps, then cosine decay to 0 over
    the remaining `steps - warmup`, in float32 as optax computes it."""
    from distributed_vgg_f_tpu_torch.train.schedule import (_cosine,
                                                            _linear_warmup)
    ramp = _linear_warmup(lr, warmup)
    decay = _cosine(lr, steps - warmup)
    return lambda count: ramp(count) if count < warmup \
        else decay(count - warmup)


def _build(model_name: str, image_size: int, num_classes: int,
           dropout_rate: float):
    from distributed_vgg_f_tpu_torch.config import ModelConfig
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    cfg = ModelConfig(name=model_name, num_classes=num_classes,
                      dropout_rate=dropout_rate, compute_dtype="float32")
    return cfg, build_model(cfg, image_size=image_size)


# --------------------------------------------------------------- the loop
def train_distilled(model_name: str, *, image_size: int = 32,
                    num_classes: int = 10, steps: int = 1200,
                    batch_size: int = 64, lr: float = 0.02,
                    momentum: float = 0.9, grad_clip: float = 1.0,
                    weight_decay: float = 5e-5, temperature: float = 2.0,
                    alpha: float = 0.5, dropout_rate: float = 0.2,
                    num_examples: int = 4096, seed: int = 0,
                    log_every: int = 200,
                    progress: Optional[Callable] = None,
                    init_params: Optional[Mapping] = None,
                    generator: Optional[torch.Generator] = None,
                    device="cuda"):
    """Train `model_name` on the teacher task with the distillation head.
    Returns (params, history): params a Flax-layout tree ready for
    `save_params` and the student tier (or a flagship engine with
    model_name='vggf'), history ``{"step", "loss"}`` at every
    `log_every`-th step and the last, the loss at full precision. The
    start is `init_params` (a Flax tree) or weights.init_params at
    `seed`; dropout draws from `generator` (a fresh one seeded with
    `seed` on `device` when None)."""
    from distributed_vgg_f_tpu_torch.data.teacher import TeacherTaskDataset
    from distributed_vgg_f_tpu_torch.device import resolve_device
    from distributed_vgg_f_tpu_torch.weights import (init_params as
                                                      seeded_params,
                                                      load_params as load,
                                                      params_to_flax)
    dev = resolve_device(device)
    mean, std = _serving_norm()
    cfg, model = _build(model_name, image_size, num_classes, dropout_rate)
    load(model, init_params if init_params is not None
         else seeded_params(cfg, seed, image_size=image_size))
    model.to(dev).train()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    ds = TeacherTaskDataset(batch_size, image_size, num_classes,
                            seed=seed, num_examples=num_examples,
                            mean=mean, std=std)
    teacher = ds.teacher
    schedule = warmup_cosine(lr, max(1, steps // 20), steps)
    params = list(model.parameters())
    traces = [torch.zeros_like(p) for p in params]

    history = []
    for i in range(steps):
        batch = next(ds)
        images = torch.from_numpy(batch["image"]).to(dev)
        # the teacher looks at the pixels the student sees
        raw = np.asarray(batch["image"], np.float32) * std + mean
        t_logits = torch.from_numpy(teacher.logits(raw)).to(dev)
        labels = torch.from_numpy(batch["label"]).to(dev)
        loss = distill_loss(model(images, train=True, generator=generator),
                            t_logits, labels, temperature=temperature,
                            alpha=alpha)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            # optax: clip_by_global_norm -> add_decayed_weights -> sgd
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if not bool(g_norm < grad_clip):
                grads = [(g / g_norm) * grad_clip for g in grads]
            step_lr = float(schedule(i))
            for p, g, tr in zip(params, grads, traces):
                tr.mul_(momentum).add_(g + weight_decay * p)
                p.add_(-step_lr * tr)
        if i % log_every == 0 or i == steps - 1:
            history.append({"step": i, "loss": float(loss.detach())})
            if progress is not None:
                progress(history[-1])
    return params_to_flax(model.state_dict()), history


def eval_top1(model_name: str, params: Mapping, *, image_size: int = 32,
              num_classes: int = 10, num_examples: int = 512,
              batch_size: int = 64, dropout_rate: float = 0.2,
              device="cuda") -> float:
    """Top-1 against the teacher's labels on the fixed eval shard, through
    the normalization serving applies (the descriptor's constants on
    u8)."""
    from distributed_vgg_f_tpu_torch.device import resolve_device
    from distributed_vgg_f_tpu_torch.weights import load_params as load
    dev = resolve_device(device)
    _, model = _build(model_name, image_size, num_classes, dropout_rate)
    load(model, params)
    model.to(dev).eval()
    mean, std = _serving_norm()
    images, labels = teacher_eval_shard(image_size, num_classes,
                                        num_examples)
    hits = 0
    with torch.inference_mode():
        for i in range(0, len(images), batch_size):
            chunk = images[i:i + batch_size].astype(np.float32)
            x = torch.from_numpy((chunk - mean) / std).to(dev)
            pred = model(x).argmax(dim=1).cpu().numpy()
            hits += int(np.sum(pred == labels[i:i + batch_size]))
    return hits / len(images)


def main(argv=None, *, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        description="Distill (or plain-train, --alpha 0) a zoo model on "
                    "the teacher task; writes an npz the serving tiers "
                    "load.")
    ap.add_argument("--model", default="vggf_student")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--temperature", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-examples", type=int, default=4096)
    ap.add_argument("--eval-examples", type=int, default=512)
    ap.add_argument("--out", required=True, help="npz weights path")
    args = ap.parse_args(argv)

    params, history = train_distilled(
        args.model, image_size=args.image_size,
        num_classes=args.num_classes, steps=args.steps,
        batch_size=args.batch_size, lr=args.lr, alpha=args.alpha,
        temperature=args.temperature, seed=args.seed,
        num_examples=args.num_examples, device=device,
        progress=lambda h: print(json.dumps(
            {"step": h["step"], "loss": round(h["loss"], 4)}), flush=True))
    save_params(args.out, params)
    top1 = eval_top1(args.model, params, image_size=args.image_size,
                     num_classes=args.num_classes,
                     num_examples=args.eval_examples, device=device)
    final = history[-1]["loss"]
    print(json.dumps({"model": args.model, "out": args.out,
                      "eval_top1": round(top1, 4),
                      "final_loss": round(final, 4)
                      if math.isfinite(final) else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

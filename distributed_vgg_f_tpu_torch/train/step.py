"""The single-device train and eval steps.

The counterpart of the JAX package's ``train/step.py`` `build_train_step`
(:66) and `build_eval_step` (:645) on one device: the finish, then the
augment keyed off the step, the forward in training mode, CE (or
lam*CE(y) + (1-lam)*CE(y[perm]) under mixup) plus the coupled L2, the
backward, the global gradient norm and its clip, the SGD update, the EMA
and the non-finite skip. The metric keys are the reference's: `loss`
(the CE), `l2_loss`, `top1`, `grad_norm`, `lr` (the schedule at the step
counter) and, with the skip on, `bad_step`.

One device needs no gradient exchange: the reference's all-reduce over a
one-shard mesh is the identity, and its ZeRO and bucketed exchanges
downgrade to replicated SGD there. Grad accumulation (ROADMAP A6) and a
bfloat16 exchange wire (ROADMAP A7) are not ported and are refused.

Where JAX folds `fold_in(base_rng, step)`, the port seeds fresh
generators from (seed, step, stream): one on the device for dropout, and
CPU ones for the augment draws (data/augment.py). The same (seed, step)
replays the same batch and the same dropout mask.

The non-finite skip reads the step's finiteness on the host (one device
sync a step) before the update: a bad step leaves params, momentum, the
optimizer's count and the EMA bitwise unchanged, and only the step
counter advances. The reference decides on the device with a select per
state leaf instead; the states they leave are the same.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from distributed_vgg_f_tpu_torch.data.augment import AUGMENT_RNG_FOLD
from distributed_vgg_f_tpu_torch.device import resolve_device
from distributed_vgg_f_tpu_torch.ops.losses import (l2_regularization,
                                                    softmax_cross_entropy)
from distributed_vgg_f_tpu_torch.ops.metrics import topk_correct
from distributed_vgg_f_tpu_torch.train.state import TrainState
from distributed_vgg_f_tpu_torch.utils.rng import generator

#: Stream constant of the dropout key, distinct from the augment stream.
DROPOUT_RNG_FOLD = 0xD0

Batch = Mapping[str, object]


def _to_device(value, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(value).to(device, non_blocking=True)


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def _clip_by_global_norm(grads, grad_norm: torch.Tensor,
                        clip_norm: float) -> None:
    """Scale the gradients in place so their global norm is at most
    `clip_norm` (eps 1e-12, as the reference's `_clip_by_global_norm`)."""
    scale = torch.clamp(clip_norm / (grad_norm + 1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)


def build_train_step(schedule: Callable[[int], float],
                     weight_decay: float, *,
                     grad_clip_norm: float = 0.0,
                     ema_decay: float = 0.0,
                     skip_nonfinite: bool = False,
                     device_finish: Optional[Callable] = None,
                     device_augment: Optional[Callable] = None,
                     grad_accum_steps: int = 1,
                     reduce_dtype: str = "float32",
                     device=None) -> Callable:
    """Returns `train_step(state, batch, seed) -> (state, metrics)`.

    `state` (train/state.py) holds the model and the optimizer, so this
    function takes neither. `batch` holds `image` (u8 or finished float,
    NHWC) and integer `label`s, on any device; they are moved to the
    step's device, which is CUDA unless `device="cpu"`. Metric values are
    tensors on the device (the guard and the log read them) except `lr`
    and `bad_step`, which are Python floats."""
    if grad_accum_steps != 1:
        raise NotImplementedError(
            f"train.grad_accum_steps={grad_accum_steps}: micro-batch "
            "accumulation is not ported yet (ROADMAP A6)")
    if reduce_dtype not in (None, "float32"):
        raise NotImplementedError(
            f"mesh.reduce_dtype={reduce_dtype!r}: a narrowed gradient "
            "exchange wire is not ported yet (ROADMAP A7)")
    dev = resolve_device("cuda" if device is None else device)

    def train_step(state: TrainState, batch: Batch, seed: int):
        images = _to_device(batch["image"], dev)
        labels = _to_device(batch["label"], dev).long()
        if device_finish is not None:
            images = device_finish(images)
        step = state.step
        mix_labels = mix_lam = None
        if device_augment is not None:
            images, mix_labels, mix_lam = device_augment(
                (seed, step, AUGMENT_RNG_FOLD), images, labels)
        model, opt = state.model, state.optimizer
        logits = model(images, train=True,
                       generator=generator(seed, step, DROPOUT_RNG_FOLD,
                                           device=dev))
        if mix_labels is not None:
            ce = mix_lam * softmax_cross_entropy(logits, labels) \
                + (1.0 - mix_lam) * softmax_cross_entropy(logits, mix_labels)
        else:
            ce = softmax_cross_entropy(logits, labels)
        l2 = l2_regularization(model.named_parameters(), weight_decay)
        opt.zero_grad(set_to_none=True)
        (ce + l2).backward()
        grads = [p.grad for p in model.parameters()]
        grad_norm = _global_norm(grads)
        if grad_clip_norm > 0:
            _clip_by_global_norm(grads, grad_norm, grad_clip_norm)
        metrics = {
            "loss": ce.detach(),
            "l2_loss": l2.detach(),
            # top1 scores the primary labels (the mixup convention)
            "top1": topk_correct(logits.detach(), labels, 1).float()
            / labels.shape[0],
            "grad_norm": grad_norm,
            "lr": schedule(step),
        }
        ok = True
        if skip_nonfinite:
            ok = bool(torch.isfinite(ce.detach() + l2.detach())
                      & torch.isfinite(grad_norm))
            metrics["bad_step"] = 0.0 if ok else 1.0
        if ok:
            lr = schedule(state.opt_count)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            state.opt_count += 1
            if ema_decay > 0.0 and state.ema_params is not None:
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        state.ema_params[name].mul_(ema_decay).add_(
                            p, alpha=1.0 - ema_decay)
        state.step += 1
        return state, metrics

    return train_step


def build_eval_step(device_finish: Optional[Callable] = None, *,
                    device=None) -> Callable:
    """Returns `eval_step(state, batch, use_ema=False) -> {'top1',
    'top5', 'count'}`: correct counts (int tensors) of the unaugmented
    eval forward, with `batch['valid']` (optional) masking padding rows.
    `use_ema` scores the EMA weights instead of the raw ones."""
    dev = resolve_device("cuda" if device is None else device)

    def eval_step(state: TrainState, batch: Batch, use_ema: bool = False):
        with torch.inference_mode():
            images = _to_device(batch["image"], dev)
            labels = _to_device(batch["label"], dev).long()
            if device_finish is not None:
                images = device_finish(images)
            valid = batch.get("valid")
            valid = None if valid is None else _to_device(valid, dev).bool()
            if use_ema:
                if state.ema_params is None:
                    raise ValueError("use_ema=True but the state has no EMA "
                                     "(train.ema_decay is 0)")
                logits = torch.func.functional_call(
                    state.model, state.ema_params, (images,))
            else:
                logits = state.model(images)
            k5 = min(5, logits.shape[-1])
            return {
                "top1": topk_correct(logits, labels, 1, valid),
                "top5": topk_correct(logits, labels, k5, valid),
                "count": (valid.sum() if valid is not None
                          else torch.tensor(labels.shape[0])),
            }

    return eval_step

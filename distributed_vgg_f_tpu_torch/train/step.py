"""The train and eval steps, with the gradient exchange over a
torch.distributed process group.

The counterpart of the JAX package's ``train/step.py`` `build_train_step`
(:66) and `build_eval_step` (:645): the finish, then the augment keyed
off the step, the forward in training mode (which moves the BatchNorm
statistics in place, over the group with sync-BN, once a micro-batch),
CE (or lam*CE(y) + (1-lam)*CE(y[perm]) under mixup) plus the coupled L2,
the backward, the exchange, the global gradient norm and its clip, the
SGD update, the EMA (of the BatchNorm statistics too, with the same
decay) and the non-finite skip. The metric keys are the reference's:
`loss` (the CE), `l2_loss`, `top1`, `grad_norm`, `lr` (the schedule at
the step counter) and, with the skip on, `bad_step`. `loss`, `l2_loss`
and `top1` are each rank's values averaged over the group in one
all-reduce.

Each process is one replica of the group and steps on its local batch.
The exchange follows JAX `train/step.py:360–531`:

- plain DP: one mean all-reduce per leaf, or one per bucket when
  `comm_bucket_mb > 0` (parallel/buckets.py), then the norm, the clip and
  the per-leaf update;
- ZeRO-1 (`zero1`) and ZeRO-2 (`shard_gradients`): a reduce-scatter per
  bucket into this rank's (S,) mean shard, or one flat reduce-scatter
  unbucketed (parallel/zero.py); the norm is sqrt(all_reduce(sum(shard²)));
  the shard is clipped and updated by the optimizer over the state's
  parameter shard, then all-gathered in fp32 (never narrowed) back into
  the model's parameters.
- ZeRO-3 (`shard_params`, JAX `train/step.py:147–160, 380–405, 481–504`):
  the state's (S,) shard is the parameters' one copy. The step gathers
  them once, up front and outside the micro-batch loop: one all-gather
  per bucket (one of the canonical vector unbucketed), issued async in
  the order the forward consumes the buckets and all waited on before
  the forward (parallel/buckets.py `gather_param_tree`), on the
  `mesh.reduce_dtype` wire. The gradient side is ZeRO-2's; the gathered
  buffers are released once the scatter is done, the optimizer steps the
  resident shard and no trailing gather follows. The EMA is an (S,)
  shard updated from the new shard. At an fp32 wire the step is ZeRO-2's
  arithmetic on the same values, so the two agree bit for bit.

Each bucket's collective is issued, async, from the parameters'
post-accumulate-grad hooks as soon as its last gradient lands; bucket 0
(fc8's) is on the wire while the convs still back-propagate, and every
handle is waited on before the norm. Under ZeRO-2 a leaf's `.grad` is
released once its bucket holds it: no full gradient tree outlives the
backward. `mesh.reduce_dtype="bfloat16"` narrows every exchange leg
(parallel/collectives.py `cast_to_wire`) but ZeRO-1/2's param gather.

Grad accumulation (`grad_accum_steps=k`) splits the local batch into k
micro-batches after the finish and the augment (mixup pairs over the
whole local batch, one lam a step), folds dropout per micro-batch, and
accumulates the full gradients (exchanged once, divided by k first) or,
under `grad_accum_shard` and always under ZeRO-2 with k > 1, scatters
each micro-gradient at once into an (S,) accumulator. Metrics are the
mean over the micro-batches.

On one rank with an fp32 wire the DP mean is the gradient itself and
nothing is exchanged; a ZeRO step always runs its exchange (through a
group of one when one is up, as the identity without a group).

Where JAX folds `fold_in(base_rng, step)` and the replica index, the
port seeds fresh generators from (seed, step, rank, stream)
(utils/rng.py `replica_seed`): one on the device for dropout, and CPU
ones for the augment draws (data/augment.py). Rank 0 draws what a
one-process run draws; the same (seed, step, rank) replays the same
batch and the same dropout mask.

The non-finite skip reads the step's finiteness on the host (one device
sync a step) before the update, from the all-reduced loss and the global
norm, so every rank takes the same branch: a bad step leaves params,
momentum, the optimizer's count, the BatchNorm statistics (copied before
the forward and put back) and both EMAs bitwise unchanged (under
ZeRO it skips the shard update and the gather on every rank), and only
the step counter advances. The reference decides on the device with a
select per state leaf instead; the states they leave are the same.
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional

import torch

from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.data.augment import AUGMENT_RNG_FOLD
from distributed_vgg_f_tpu_torch.device import resolve_device
from distributed_vgg_f_tpu_torch.ops.losses import (l2_regularization,
                                                    softmax_cross_entropy)
from distributed_vgg_f_tpu_torch.ops.metrics import topk_correct
from distributed_vgg_f_tpu_torch.parallel.buckets import (
    BucketExchange, build_bucket_layout, leaf_layout, sharding_basis,
    wire_dtype_of)
from distributed_vgg_f_tpu_torch.parallel.collectives import (
    all_reduce_sum, check_backend, cross_replica_mean, rank_and_size)
from distributed_vgg_f_tpu_torch.parallel.zero import zero_layout
from distributed_vgg_f_tpu_torch.train.state import TrainState
from distributed_vgg_f_tpu_torch.utils.rng import generator, replica_seed

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


def _backward(loss: torch.Tensor, leaves, ex: Optional[BucketExchange],
              release: bool, events: Optional[list]) -> None:
    """loss.backward(), each leaf's gradient handed to the exchange from
    its post-accumulate hook as it lands (and then released from
    `.grad` with `release`)."""
    if ex is None:
        loss.backward()
        return
    names = ex.layout.names

    def on_grad(idx, p):
        if events is not None:
            events.append(("grad", names[idx]))
        ex.add(idx, p.grad)
        if release:
            p.grad = None

    handles = [p.register_post_accumulate_grad_hook(
        functools.partial(on_grad, i)) for i, p in enumerate(leaves)]
    try:
        loss.backward()
    finally:
        for h in handles:
            h.remove()


def build_train_step(schedule: Callable[[int], float],
                     weight_decay: float, *,
                     grad_clip_norm: float = 0.0,
                     ema_decay: float = 0.0,
                     skip_nonfinite: bool = False,
                     device_finish: Optional[Callable] = None,
                     device_augment: Optional[Callable] = None,
                     zero1: bool = False,
                     shard_gradients: bool = False,
                     shard_params: bool = False,
                     comm_bucket_mb: float = 0.0,
                     grad_accum_steps: int = 1,
                     grad_accum_shard: bool = False,
                     reduce_dtype: str = "float32",
                     group=None,
                     event_log: Optional[list] = None,
                     device=None) -> Callable:
    """Returns `train_step(state, batch, seed) -> (state, metrics)`.

    `state` (train/state.py) holds the model and the optimizer; under
    `zero1` it must come from `TrainState.create_sharded` over
    `parallel.zero.zero_layout(model, N, comm_bucket_mb)`. `batch` holds
    this rank's `image` rows (u8 or finished float, NHWC) and integer
    `label`s, on any device; they are moved to the step's device, which
    is CUDA unless `device="cpu"`. `group` is the data-parallel process
    group (None: the default group when one is up, else none; its size
    is the shard count N). `event_log`, when a list, gets ("grad", Flax
    leaf name) as each gradient reaches the exchange and ("issue",
    bucket) as each collective is issued. Metric values are tensors on
    the device (the guard and the log read them) except `lr` and
    `bad_step`, which are Python floats. The step's static exchange
    receipt is `train_step.comm_meta` (filled at the first call); each
    call adds it to the `comm/*` counters (telemetry/registry.py
    `COMM_COUNTERS`). Under `shard_params` the state comes from
    `create_sharded(..., shard_params=True)` and `event_log` also gets
    ("gather", bucket) as each gather is issued."""
    if shard_params and not (zero1 and shard_gradients):
        raise ValueError(
            "shard_params (ZeRO-3) requires shard_gradients (ZeRO-2) — the "
            "sharding ladder is cumulative; params sharded without a "
            "sharded gradient frame would re-materialize O(params) "
            "gradient state every step")
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got "
                         f"{grad_accum_steps}")
    if grad_accum_shard and not (zero1 and grad_accum_steps > 1):
        raise ValueError(
            "grad_accum_shard requires zero1 optimizer-state sharding AND "
            f"grad_accum_steps > 1 (got zero1={zero1}, "
            f"grad_accum_steps={grad_accum_steps}) — without both there is "
            "no sharded accumulator to build")
    if shard_gradients and not zero1:
        raise ValueError(
            "shard_gradients (ZeRO-2) requires zero1 optimizer-state "
            "sharding — there is no shard frame to hold gradients in")
    if comm_bucket_mb < 0:
        raise ValueError(f"comm_bucket_mb {comm_bucket_mb} < 0")
    wire = wire_dtype_of(reduce_dtype)
    dev = resolve_device("cuda" if device is None else device)
    rank, n = rank_and_size(group)
    k = int(grad_accum_steps)
    # ZeRO-2 implies the sharded accumulator whenever there are micro-batches
    grad_accum_shard = grad_accum_shard or (shard_gradients and k > 1)
    bucket_bytes = (int(round(comm_bucket_mb * 1024 * 1024))
                    if comm_bucket_mb else 0)
    # the DP mean over one replica on an fp32 wire is the gradient itself
    exchange_dp = not zero1 and (n > 1 or wire is not None)
    if zero1 or exchange_dp:    # a step that issues collectives
        check_backend(group, dev)
    comm_meta: dict = {}
    layouts: dict = {}

    def layout_for(model):
        # `model` gives the shapes: the state's model, or under ZeRO-3 its
        # meta twin (the model's parameters are zero-size between steps)
        sig = tuple((name, tuple(p.shape))
                    for name, p in model.named_parameters())
        lay = layouts.get(sig)
        if lay is not None:
            return lay
        if zero1:
            lay = zero_layout(model, n, comm_bucket_mb)
        else:
            lay = (build_bucket_layout(model, n, bucket_bytes)
                   or leaf_layout(model, n))
        layouts[sig] = lay
        if not comm_meta:
            comm_meta.update({
                # the EFFECTIVE basis (the caller passes post-downgrade
                # flags)
                "sharding": sharding_basis(zero1, zero1 and shard_gradients,
                                           shard_params),
                "bucketed": bucket_bytes > 0,
                "buckets": (lay.num_buckets if bucket_bytes > 0
                            else (1 if zero1 else len(lay.keys))),
                "bucket_mb": float(comm_bucket_mb or 0.0),
                "reduce_dtype": reduce_dtype or "float32",
                "grad_accum_steps": k,
                # ZeRO-3's just-in-time gather, one a bucket; the one
                # trailing (S,) re-sync gather under ZeRO-1/2
                "gathers": (lay.num_buckets if shard_params
                            else 1 if zero1 else 0),
                **lay.wire_bytes_per_step(zero=zero1, wire_dtype=wire,
                                          shard_params=shard_params)})
            if grad_accum_shard:   # k micro-scatters a step
                comm_meta["scatter_bytes"] *= k
                comm_meta["wire_bytes"] = (comm_meta["scatter_bytes"]
                                           + comm_meta["gather_bytes"])
        return lay

    def train_step(state: TrainState, batch: Batch, seed: int):
        images = _to_device(batch["image"], dev)
        labels = _to_device(batch["label"], dev).long()
        if device_finish is not None:
            images = device_finish(images)
        step = state.step
        rseed = replica_seed(seed, rank)
        mix_labels = mix_lam = None
        if device_augment is not None:
            images, mix_labels, mix_lam = device_augment(
                (rseed, step, AUGMENT_RNG_FOLD), images, labels)
        model, opt = state.model, state.optimizer
        lay = layout_for(state.shapes)
        if zero1 and (state.param_shard is None or state.layout != lay):
            raise ValueError(
                "a ZeRO step needs a state from TrainState.create_sharded "
                "over this step's layout (parallel/zero.py zero_layout with "
                f"{n} shards and comm_bucket_mb={comm_bucket_mb})")
        if not zero1 and state.param_shard is not None:
            raise ValueError("a sharded (ZeRO) state given to a replicated "
                             "step")
        if state.shard_params != shard_params:
            raise ValueError(
                f"a state with shard_params={state.shard_params} given to a "
                f"step with shard_params={shard_params}: ZeRO-3 needs "
                "TrainState.create_sharded(..., shard_params=True) and the "
                "step's shard_params both")
        b = images.shape[0]
        if b % k:
            raise ValueError(f"per-rank batch {b} not divisible by "
                             f"grad_accum_steps={k}")
        micro = b // k
        leaves = lay.leaves(model)
        if shard_params:
            # once a step, outside the micro-batch loop: the params cannot
            # change within it
            state.gather_params(wire_dtype=reduce_dtype, events=event_log)
        if zero1:
            for p in leaves:
                p.grad = None
        else:
            opt.zero_grad(set_to_none=True)
        acc = (torch.zeros(lay.shard_size, dtype=torch.float32, device=dev)
               if grad_accum_shard else None)
        # the forwards move the BatchNorm statistics in place, once a
        # micro-batch in order; a skipped step puts them back
        stats = state.batch_stats
        stats_before = ({k: v.clone() for k, v in stats.items()}
                        if skip_nonfinite and stats else None)
        ex = None
        parts = []
        for i in range(k):
            rows = slice(i * micro, (i + 1) * micro)
            y = labels[rows]
            key = (rseed, step, DROPOUT_RNG_FOLD) + ((i,) if k > 1 else ())
            logits = model(images[rows], train=True,
                           generator=generator(*key, device=dev))
            if mix_labels is not None:
                ce = mix_lam * softmax_cross_entropy(logits, y) \
                    + (1.0 - mix_lam) * softmax_cross_entropy(
                        logits, mix_labels[rows])
            else:
                ce = softmax_cross_entropy(logits, y)
            l2 = l2_regularization(model.named_parameters(), weight_decay)
            # top1 scores the primary labels (the mixup convention)
            parts.append((ce.detach(), l2.detach(),
                          topk_correct(logits.detach(), y, 1).float()
                          / y.shape[0]))
            if grad_accum_shard:
                ex = BucketExchange(lay, scatter=True, group=group,
                                    wire_dtype=wire, events=event_log)
                _backward(ce + l2, leaves, ex, True, event_log)
                acc.add_(ex.finish())
            elif (zero1 or exchange_dp) and i == k - 1:
                ex = BucketExchange(lay, scatter=zero1, group=group,
                                    wire_dtype=wire, divisor=k,
                                    events=event_log)
                _backward(ce + l2, leaves, ex, zero1 and shard_gradients,
                          event_log)
            else:
                (ce + l2).backward()
        if k == 1:
            loss, l2_loss, top1 = parts[0]
        else:
            loss, l2_loss, top1 = (torch.stack(c).mean() for c in zip(*parts))
        metrics = cross_replica_mean(
            {"loss": loss, "l2_loss": l2_loss, "top1": top1}, group)
        if zero1:
            grad_shard = acc.div_(k) if grad_accum_shard else ex.finish()
            if shard_params:
                state.release_params()
            sq = torch.sum(grad_shard * grad_shard)
            all_reduce_sum(sq, group)
            grad_norm = torch.sqrt(sq)
            if grad_clip_norm > 0:
                _clip_by_global_norm([grad_shard], grad_norm, grad_clip_norm)
        else:
            if ex is not None:
                ex.finish([p.grad for p in leaves])
            elif k > 1:
                for p in leaves:
                    p.grad.div_(k)
            grads = [p.grad for p in model.parameters()]
            grad_norm = _global_norm(grads)
            if grad_clip_norm > 0:
                _clip_by_global_norm(grads, grad_norm, grad_clip_norm)
        metrics["grad_norm"] = grad_norm
        metrics["lr"] = schedule(step)
        ok = True
        if skip_nonfinite:
            ok = bool(torch.isfinite(metrics["loss"] + metrics["l2_loss"])
                      & torch.isfinite(grad_norm))
            metrics["bad_step"] = 0.0 if ok else 1.0
        if ok:
            lr = schedule(state.opt_count)
            for g in opt.param_groups:
                g["lr"] = lr
            if zero1:
                state.param_shard.grad = grad_shard
                opt.step()
                state.param_shard.grad = None
                if not shard_params:
                    lay.gather_params(state.param_shard, leaves, group)
            else:
                opt.step()
            state.opt_count += 1
            if ema_decay > 0.0 and state.ema_params is not None:
                with torch.no_grad():
                    if shard_params:   # the (S,) EMA from the new shard
                        state.ema_params.mul_(ema_decay).add_(
                            state.param_shard, alpha=1.0 - ema_decay)
                    else:
                        for name, p in model.named_parameters():
                            state.ema_params[name].mul_(ema_decay).add_(
                                p, alpha=1.0 - ema_decay)
                    # the statistics' EMA, with the same decay (JAX
                    # `train/step.py:546–551`)
                    for name, v in stats.items():
                        state.ema_batch_stats[name].mul_(ema_decay).add_(
                            v, alpha=1.0 - ema_decay)
        elif stats_before is not None:
            with torch.no_grad():
                for name, v in stats.items():
                    v.copy_(stats_before[name])
        state.step += 1
        telemetry.inc("comm/exchanges")
        telemetry.inc("comm/wire_bytes", comm_meta["wire_bytes"])
        if comm_meta["gathers"]:
            telemetry.inc("comm/gathers", comm_meta["gathers"])
            telemetry.inc("comm/gather_wire_bytes", comm_meta["gather_bytes"])
        reg = telemetry.get_registry()
        reg.set_gauge("comm/buckets_per_step", comm_meta["buckets"])
        reg.set_gauge("comm/bucket_mb", comm_meta["bucket_mb"])
        return state, metrics

    train_step.comm_meta = comm_meta
    return train_step


def build_eval_step(device_finish: Optional[Callable] = None, *,
                    device=None) -> Callable:
    """Returns `eval_step(state, batch, use_ema=False) -> {'top1',
    'top5', 'count'}`: correct counts (int tensors) of the unaugmented
    eval forward, with `batch['valid']` (optional) masking padding rows.
    `use_ema` scores the EMA weights, with the EMA of the BatchNorm
    statistics, instead of the raw ones; BatchNorm reads its running
    statistics either way. Under ZeRO-3 it gathers the exact fp32
    weights (or the EMA) and releases them afterwards, as JAX's
    `_param_gather` does (`trainer.py:363–380`), unless the caller holds
    them gathered (`TrainState.gathered`, once an eval pass): a gather is
    collective."""
    dev = resolve_device("cuda" if device is None else device)

    def eval_step(state: TrainState, batch: Batch, use_ema: bool = False):
        if use_ema and state.ema_params is None:
            raise ValueError("use_ema=True but the state has no EMA "
                             "(train.ema_decay is 0)")
        with state.gathered(ema=use_ema):
            return _eval(state, batch, use_ema)

    def _eval(state: TrainState, batch: Batch, use_ema: bool):
        with torch.inference_mode():
            images = _to_device(batch["image"], dev)
            labels = _to_device(batch["label"], dev).long()
            if device_finish is not None:
                images = device_finish(images)
            valid = batch.get("valid")
            valid = None if valid is None else _to_device(valid, dev).bool()
            if use_ema:
                # the averaged weights with the averaged statistics (JAX
                # `train/trainer.py:1766`); under ZeRO-3 the model holds
                # the gathered EMA weights
                logits = torch.func.functional_call(
                    state.model, {**({} if state.shard_params
                                     else state.ema_params),
                                  **(state.ema_batch_stats or {})},
                    (images,))
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

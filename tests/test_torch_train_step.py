"""The port's single-device train step (distributed_vgg_f_tpu_torch/train/
step.py) against the JAX package's `build_train_step` on a one-device CPU
mesh, from the same weights and the same batches, on a narrow VGG-F
(stem 8, convs 16, FC 32, 10 classes, 32 px, fp32 compute, dropout and
augment off).

Tolerances, all fp32:
- param gradients vs Flax: rtol/atol 1e-4 (the forward parity bound of
  tests/test_torch_vggf.py; sums run in another order in the two
  frameworks);
- the 20-step trajectory (warmup, peak, one decay, clipping, EMA):
  losses rtol 2e-6, params and EMA atol 1e-6 + rtol 1e-5 — the
  per-step differences of summation order compound over 20 updates
  (measured: losses within 2.1e-7 relative, params within 6e-8, after
  the params moved by up to 0.14);
- 5 JAX steps continued by 5 port steps vs 10 JAX steps: the same.
The non-finite skip is held bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.models.vggf import VGGF as JaxVGGF
from distributed_vgg_f_tpu.ops.losses import \
    softmax_cross_entropy as jax_ce
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.train.schedule import \
    build_optimizer as jax_build_optimizer
from distributed_vgg_f_tpu.train.state import TrainState as JaxTrainState
from distributed_vgg_f_tpu.train.step import \
    build_train_step as jax_build_train_step
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.models.vggf import VGGF
from distributed_vgg_f_tpu_torch.ops import lrn_cuda
from distributed_vgg_f_tpu_torch.ops.losses import softmax_cross_entropy
from distributed_vgg_f_tpu_torch.resilience.guard import (NonFiniteGuard,
                                                          NonFiniteStepError)
from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
from distributed_vgg_f_tpu_torch.train.state import TrainState
from distributed_vgg_f_tpu_torch.train.step import (build_eval_step,
                                                    build_train_step)
from distributed_vgg_f_tpu_torch.weights import (load_params,
                                                  momentum_from_optax,
                                                  params_to_flax)

WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
SIZE, CLASSES, BATCH = 32, 10, 16
EMA = 0.9


def _optim(cfg):
    # warmup over steps 0-7, the peak over 8-15, one decay at step 16,
    # clipping at global norm 1
    return dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, base_lr=0.05, reference_batch_size=BATCH,
        warmup_epochs=0.125, decay_epochs=(0.125,), grad_clip_norm=1.0))


def _configs():
    """The vggf_teacher preset in both packages, dropout off, batch 16,
    8 steps an epoch, EMA on."""
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_config("vggf_teacher")
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model, dropout_rate=0.0),
            data=dataclasses.replace(cfg.data, global_batch_size=BATCH,
                                     num_train_examples=BATCH * 64),
            train=dataclasses.replace(cfg.train, ema_decay=EMA))
        out.append(_optim(cfg))
    return out


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal(
                 (BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, (BATCH,)).astype(np.int32)}
            for _ in range(n)]


class _Jax:
    """The JAX train step on a one-device CPU mesh, compiled once."""

    def __init__(self):
        self.cfg, _ = _configs()
        self.model = JaxVGGF(num_classes=CLASSES, dropout_rate=0.0,
                             compute_dtype=jnp.float32, **WIDTHS)
        self.mesh = build_mesh(MeshSpec(("data",), (1,)),
                               devices=jax.devices()[:1])
        self.tx, self.schedule = jax_build_optimizer(self.cfg)
        self.step = jax_build_train_step(
            self.model, self.tx, self.mesh, self.cfg.optim.weight_decay,
            schedule=self.schedule, grad_clip_norm=1.0, ema_decay=EMA,
            skip_nonfinite=True)
        self.rng = jax.random.key(1)

    def init(self):
        return JaxTrainState.create(self.model, self.tx, jax.random.key(0),
                                    jnp.zeros((1, SIZE, SIZE, 3)), ema=True)

    def run(self, state, batches):
        losses = []
        for b in batches:
            state, m = self.step(state, {"image": jnp.asarray(b["image"]),
                                         "label": jnp.asarray(b["label"])},
                                 self.rng)
            losses.append(float(m["loss"]))
        self.metric_keys = set(m)
        return state, losses


@pytest.fixture(scope="module")
def jax_side():
    return _Jax()


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _port_state(tree, cfg):
    model = load_params(VGGF(CLASSES, compute_dtype=torch.float32,
                             image_size=SIZE, dropout_rate=0.0, **WIDTHS),
                        tree)
    opt, schedule = build_optimizer(cfg, model.parameters())
    return TrainState.create(model, opt, ema=True), schedule


def _port_step(cfg, schedule):
    return build_train_step(schedule, cfg.optim.weight_decay,
                            grad_clip_norm=cfg.optim.grad_clip_norm,
                            ema_decay=EMA, skip_nonfinite=True,
                            device="cpu")


def _assert_tree_close(got_sd, want_tree, atol=1e-6, rtol=1e-5):
    got = params_to_flax(got_sd)
    for layer in want_tree:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf],
                                       want_tree[layer][leaf], rtol=rtol,
                                       atol=atol, err_msg=f"{layer}/{leaf}")


def test_param_grads_match_flax_narrow_32px(jax_side):
    tree = _tree(jax_side.init().params)
    b = _batches(1, seed=5)[0]

    def loss_fn(p):
        logits = jax_side.model.apply({"params": p}, jnp.asarray(b["image"]),
                                      train=False)
        return jax_ce(logits, jnp.asarray(b["label"]))

    want = _tree(jax.jit(jax.grad(loss_fn))(tree))
    model = load_params(VGGF(CLASSES, compute_dtype=torch.float32,
                             image_size=SIZE, dropout_rate=0.0, **WIDTHS),
                        tree)
    loss = softmax_cross_entropy(model(torch.from_numpy(b["image"]),
                                       train=True),
                                 torch.from_numpy(b["label"]).long())
    loss.backward()
    got = params_to_flax({k: p.grad for k, p in model.named_parameters()})
    for layer in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{layer}/{leaf}")
    assert np.abs(got["conv1"]["kernel"]).max() > 0


def test_20_step_trajectory_matches_jax(jax_side):
    _, cfg = _configs()
    batches = _batches(20)
    jstate = jax_side.init()
    tree = _tree(jstate.params)
    jstate, want_losses = jax_side.run(jstate, batches)

    state, schedule = _port_state(tree, cfg)
    step = _port_step(cfg, schedule)
    losses, lrs = [], []
    for b in batches:
        state, m = step(state, b, 0)
        losses.append(float(m["loss"]))
        lrs.append(m["lr"])
        assert m["bad_step"] == 0.0
    np.testing.assert_allclose(losses, want_losses, rtol=2e-6)
    assert set(m) == jax_side.metric_keys
    assert lrs[0] == 0.0 and lrs[8] == pytest.approx(0.05) \
        and lrs[16] == pytest.approx(0.005)
    assert state.step == 20 and state.opt_count == 20
    _assert_tree_close(state.model.state_dict(), _tree(jstate.params))
    _assert_tree_close(state.ema_params, _tree(jstate.ema_params))
    # the params moved: the comparison is not of two initial states
    assert not np.allclose(params_to_flax(state.model.state_dict())
                           ["fc8"]["kernel"], tree["fc8"]["kernel"])


def test_port_continues_jax_run_through_momentum_bridge(jax_side):
    _, cfg = _configs()
    batches = _batches(10, seed=3)
    jstate = jax_side.init()
    tree = _tree(jstate.params)
    full, _ = jax_side.run(jstate, batches)
    half, _ = jax_side.run(jax_side.init(), batches[:5])

    state, schedule = _port_state(_tree(half.params), cfg)
    state.load_momentum(momentum_from_optax(_tree(half.opt_state)))
    state.step = int(half.step)
    state.opt_count = int(half.opt_state[1].count)
    state.ema_params = {k: v.clone() for k, v in load_params(
        VGGF(CLASSES, compute_dtype=torch.float32, image_size=SIZE,
             **WIDTHS), _tree(half.ema_params)).state_dict().items()}
    step = _port_step(cfg, schedule)
    for b in batches[5:]:
        state, _ = step(state, b, 0)
    assert state.opt_count == 10
    _assert_tree_close(state.model.state_dict(), _tree(full.params))
    _assert_tree_close(state.ema_params, _tree(full.ema_params))
    assert not np.allclose(tree["conv2"]["kernel"],
                           _tree(full.params)["conv2"]["kernel"])


def _fresh(seed=0, dropout=0.5):
    cfg = tcfg.get_config("vggf_teacher")
    model = VGGF(CLASSES, compute_dtype=torch.float32, image_size=SIZE,
                 dropout_rate=dropout, **WIDTHS)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    opt, schedule = build_optimizer(cfg, model.parameters())
    return TrainState.create(model, opt, ema=True), cfg, schedule


def test_nonfinite_batch_leaves_state_bitwise_unchanged():
    state, cfg, schedule = _fresh()
    step = build_train_step(schedule, cfg.optim.weight_decay,
                            ema_decay=0.5, skip_nonfinite=True,
                            device="cpu")
    good, bad = _batches(2, seed=7)
    state, m = step(state, good, 0)
    assert m["bad_step"] == 0.0 and state.opt_count == 1
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    momentum = {k: v.clone() for k, v in state.momentum().items()}
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    bad["image"][0, 0, 0, 0] = np.nan
    state, m = step(state, bad, 0)
    assert m["bad_step"] == 1.0
    assert not np.isfinite(float(m["loss"]))
    assert state.step == 2 and state.opt_count == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for k, v in state.momentum().items():
        assert torch.equal(v, momentum[k]), k
    for k, v in state.ema_params.items():
        assert torch.equal(v, ema[k]), k
    # the next good step applies the update the skipped one did not
    state, m = step(state, good, 0)
    assert m["bad_step"] == 0.0 and state.opt_count == 2


def test_guard_raises_after_max_consecutive_with_lag():
    guard = NonFiniteGuard(max_consecutive=3)
    for s in range(1, 5):
        guard.observe(s, 1.0)  # resolves step s-2
    assert guard.consecutive == 2
    with pytest.raises(NonFiniteStepError, match="3 consecutive"):
        guard.observe(5, torch.tensor(1.0))
    guard = NonFiniteGuard(max_consecutive=2)
    for s, flag in enumerate([1.0, 0.0, 1.0, 0.0], start=1):
        guard.observe(s, flag)
    guard.drain()
    assert guard.total == 2 and guard.consecutive == 0


def test_same_seed_and_step_replays_dropout_mask():
    outs = []
    for _ in range(2):
        state, cfg, schedule = _fresh(seed=1)
        step = build_train_step(schedule, cfg.optim.weight_decay,
                                device="cpu")
        for b in _batches(2, seed=9):
            state, m = step(state, b, 4)
        outs.append((float(m["loss"]), state.model.state_dict()))
    assert outs[0][0] == outs[1][0]
    for k, v in outs[0][1].items():
        assert torch.equal(v, outs[1][1][k]), k
    # another seed draws another mask
    state, cfg, schedule = _fresh(seed=1)
    step = build_train_step(schedule, cfg.optim.weight_decay, device="cpu")
    for b in _batches(2, seed=9):
        state, m = step(state, b, 5)
    assert float(m["loss"]) != outs[0][0]


def test_cpu_step_launches_no_kernel():
    lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
    state, cfg, schedule = _fresh()
    step = build_train_step(schedule, 0.0, device="cpu")
    step(state, _batches(1)[0], 0)
    assert lrn_cuda.LAUNCHES == 0 and lrn_cuda.BWD_LAUNCHES == 0


def test_eval_step_counts_and_valid_mask():
    state, _, _ = _fresh()
    b = _batches(1, seed=2)[0]
    evaluate = build_eval_step(device="cpu")
    with torch.no_grad():
        logits = state.model(torch.from_numpy(b["image"]))
    labels = torch.from_numpy(b["label"]).long()
    want1 = int((logits.argmax(-1) == labels).sum())
    counts = evaluate(state, b)
    assert int(counts["top1"]) == want1 and int(counts["count"]) == BATCH
    assert int(counts["top5"]) >= want1
    valid = np.zeros(BATCH, bool)
    valid[:4] = True
    masked = evaluate(state, {**b, "valid": valid})
    assert int(masked["count"]) == 4
    assert int(masked["top1"]) == int((logits.argmax(-1)[:4]
                                       == labels[:4]).sum())
    ema = evaluate(state, b, use_ema=True)  # EMA == params at creation
    assert int(ema["top1"]) == want1


@pytest.mark.parametrize("kw,error,match", [
    ({"zero1": True, "shard_params": True}, ValueError,
     "shard_params \\(ZeRO-3\\) requires shard_gradients"),
    ({"grad_accum_steps": 2, "grad_accum_shard": True}, ValueError,
     "grad_accum_shard requires zero1"),
    ({"zero1": True, "grad_accum_shard": True}, ValueError,
     "grad_accum_steps > 1")])
def test_unported_options_are_refused(kw, error, match):
    """ZeRO-3 needs ZeRO-2's sharded gradients (JAX `step.py:209`); a
    sharded accumulator needs ZeRO and k > 1."""
    with pytest.raises(error, match=match):
        build_train_step(lambda s: 0.1, 0.0, device="cpu", **kw)


@pytest.mark.parametrize("bucket_mb", [0.0, 0.004])
def test_zero2_step_on_one_process_is_the_replicated_step(bucket_mb):
    """ZeRO-2 with no process group (a group of one): the flat shard is
    the whole (T,) vector, and 3 steps give the replicated step's losses,
    parameters and momentum; load_momentum and momentum() round-trip
    through the flat layout."""
    from distributed_vgg_f_tpu_torch.parallel.zero import zero_layout
    runs = []
    for zero in (False, True):
        state, cfg, schedule = _fresh(seed=2, dropout=0.0)
        if zero:
            layout = zero_layout(state.model, 1, bucket_mb)
            state = TrainState.create_sharded(
                state.model, lambda ps: build_optimizer(cfg, ps)[0], layout)
        step = build_train_step(schedule, cfg.optim.weight_decay,
                                zero1=zero, shard_gradients=zero,
                                comm_bucket_mb=bucket_mb, device="cpu")
        losses = [float(step(state, b, 0)[1]["loss"])
                  for b in _batches(3, seed=4)]
        runs.append((losses, state))
    (want, rep), (got, z2) = runs
    assert got == want
    for k, v in rep.model.state_dict().items():
        assert torch.equal(z2.model.state_dict()[k], v), k
    momentum = rep.momentum()
    for k, v in z2.momentum().items():
        assert torch.equal(v, momentum[k]), k
    assert z2.momentum_global().shape == (layout.total_padded,)
    z2.load_momentum({k: v * 2 for k, v in momentum.items()})
    for k, v in z2.momentum().items():
        assert torch.equal(v, momentum[k] * 2), k
    assert z2.param_shard.grad is None
    assert all(p.grad is None for p in z2.model.parameters())


def test_train_step_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(lambda s: 0.1, 0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_eval_step()


def test_optax_sgd_state_layout_is_what_the_bridge_reads():
    """optax.sgd's state is (TraceState, ScaleByScheduleState): the
    momentum trace and the update count the port's schedule reads."""
    tx = optax.sgd(learning_rate=lambda c: 0.1, momentum=0.9)
    state = tx.init({"fc": {"kernel": jnp.ones((2, 3)),
                            "bias": jnp.zeros(3)}})
    assert hasattr(state[0], "trace") and int(state[1].count) == 0
    buffers = momentum_from_optax(_tree(state))
    assert buffers["fc.weight"].shape == (3, 2)

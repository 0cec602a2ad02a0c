"""The port's LR schedules and SGD (distributed_vgg_f_tpu_torch/train/
schedule.py) against the JAX package's optax schedules and `optax.sgd`.

The step, constant and warmup schedules repeat optax's float32
arithmetic and are held equal; cosine within rtol 1e-6 (numpy's and
XLA's float32 cos may differ in the last bit). Three SGD updates, plain
and Nesterov, within two fp32 eps (rtol 2.4e-7; measured 1.0e-7): torch
may fuse p + (-lr)*buf into one multiply-add where XLA rounds twice."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.train.schedule import \
    build_optimizer as jax_build_optimizer
from distributed_vgg_f_tpu.train.schedule import \
    build_schedule as jax_build_schedule
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.train.schedule import (build_optimizer,
                                                        build_schedule)


def _pair(name, **optim):
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_config(name)
        out.append(dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, **optim)))
    return out


def _boundaries(cfg):
    spe = cfg.steps_per_epoch
    warm = int(cfg.optim.warmup_epochs * spe)
    out = [0, warm] + [warm + int(e * spe) for e in cfg.optim.decay_epochs]
    return sorted({s + d for s in out for d in (-1, 0, 1) if s + d >= 0})


@pytest.mark.parametrize("name,optim", [
    ("vggf_imagenet_dp", {}),
    ("vggf_imagenet_dp", {"warmup_epochs": 2.0}),
    ("vggf_teacher", {}),
    ("vggf_teacher", {"schedule": "constant"}),
    ("vggf_imagenet_dp", {"schedule": "constant"}),
])
def test_lr_either_side_of_every_boundary_is_optax_exactly(name, optim):
    jc, tc = _pair(name, **optim)
    js, ts = jax_build_schedule(jc), build_schedule(tc)
    steps = _boundaries(tc)
    assert len(steps) >= 6
    for s in steps:
        assert ts(s) == float(js(jnp.int32(s))), s


@pytest.mark.parametrize("name", ["vggf_teacher", "vggf_imagenet_dp"])
def test_cosine_schedule_matches_optax(name):
    jc, tc = _pair(name, schedule="cosine", warmup_epochs=1.0)
    js, ts = jax_build_schedule(jc), build_schedule(tc)
    for s in (0, 1, 63, 64, 65, 1250, 1251, 1252, 1000, 2000, 10**6):
        np.testing.assert_allclose(ts(s), float(js(jnp.int32(s))),
                                   rtol=1e-6, atol=1e-12)


def test_warmup_first_update_has_lr_zero():
    _, tc = _pair("vggf_teacher")
    assert tc.optim.warmup_epochs > 0
    assert build_schedule(tc)(0) == 0.0


def test_lr_scale_multiplies_the_whole_schedule():
    jc, tc = _pair("vggf_teacher")
    _, jsched = jax_build_optimizer(jc, lr_scale=0.5)
    model = torch.nn.Linear(2, 2)
    _, tsched = build_optimizer(tc, model.parameters(), lr_scale=0.5)
    for s in (0, 10, 64, 2000):
        np.testing.assert_allclose(tsched(s), float(jsched(jnp.int32(s))),
                                   rtol=1e-7)


@pytest.mark.parametrize("nesterov", [False, True])
def test_three_sgd_updates_match_optax(nesterov):
    jc, tc = _pair("vggf_teacher", nesterov=nesterov)
    tx, _ = jax_build_optimizer(jc)
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    b0 = rng.standard_normal(4).astype(np.float32)
    grads = [(rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal(4).astype(np.float32)) for _ in range(3)]
    # optax, from a state advanced past the warmup's LR-0 first update
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = tx.init(params)
    state = (state[0], state[1]._replace(count=jnp.int32(100)))
    for gw, gb in grads:
        upd, state = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                               state, params)
        params = optax.apply_updates(params, upd)
    # the port: torch SGD with the LR set from the same count
    lin = torch.nn.Linear(3, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0))
        lin.bias.copy_(torch.from_numpy(b0))
    opt, schedule = build_optimizer(tc, lin.parameters())
    for i, (gw, gb) in enumerate(grads):
        lin.weight.grad = torch.from_numpy(gw)
        lin.bias.grad = torch.from_numpy(gb)
        for group in opt.param_groups:
            group["lr"] = schedule(100 + i)
        opt.step()
    assert schedule(100) > 0
    np.testing.assert_allclose(lin.weight.detach().numpy(),
                               np.asarray(params["w"]), rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(lin.bias.detach().numpy(),
                               np.asarray(params["b"]), rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(
        opt.state[lin.weight]["momentum_buffer"].numpy(),
        np.asarray(state[0].trace["w"]), rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("nesterov", [False, True])
def test_three_flat_shard_sgd_updates_match_optax(nesterov):
    """The ZeRO form: one (S,) flat parameter shard, as
    TrainState.create_sharded hands it to build_optimizer, against
    optax's update of the same flat vector."""
    jc, tc = _pair("vggf_teacher", nesterov=nesterov)
    tx, _ = jax_build_optimizer(jc)
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal(37).astype(np.float32)
    grads = [rng.standard_normal(37).astype(np.float32) for _ in range(3)]
    params = jnp.asarray(p0)
    state = tx.init(params)
    state = (state[0], state[1]._replace(count=jnp.int32(100)))
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
    shard = torch.from_numpy(p0.copy())
    opt, schedule = build_optimizer(tc, [shard])
    for i, g in enumerate(grads):
        shard.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = schedule(100 + i)
        opt.step()
    # two fp32 eps of the magnitudes summed: an element that p - lr*step
    # nearly cancels shows the fused rounding relative to its own size
    # (seen: 1.9e-8 absolute, 5.4e-7 relative, on a near-zero element)
    want = np.asarray(params)
    np.testing.assert_allclose(shard.numpy(), want, rtol=2.4e-7,
                               atol=2.4e-7 * float(np.abs(p0).max()))
    np.testing.assert_allclose(opt.state[shard]["momentum_buffer"].numpy(),
                               np.asarray(state[0].trace), rtol=2.4e-7,
                               atol=0)


def test_optimizer_has_no_decoupled_weight_decay():
    _, tc = _pair("vggf_imagenet_dp")
    opt, _ = build_optimizer(tc, torch.nn.Linear(2, 2).parameters())
    group = opt.param_groups[0]
    assert group["weight_decay"] == 0.0 and group["dampening"] == 0.0
    assert group["momentum"] == 0.9 and not group["nesterov"]


def test_unknown_schedule_is_refused():
    _, tc = _pair("vggf_teacher", schedule="linear")
    with pytest.raises(ValueError, match="unknown schedule"):
        build_schedule(tc)

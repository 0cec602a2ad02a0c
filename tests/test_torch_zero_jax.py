"""The port's ZeRO-2 bucketed step in 2- and 4-process gloo groups
(tests/_torch_dp_worker.py) against the JAX package's `build_train_step`
on meshes of the first 2 and 4 of the 8 virtual CPU devices, from the
same weights (JAX's init) and the same batches: narrow VGG-F (stem 8,
convs 16, FC 32, 10 classes, 32 px), fp32, dropout and augment off,
SGD momentum 0.9 at a constant LR, 3 steps at global batch 16, accum 1
and 2.

Tolerances (those of tests/test_torch_train_step.py): losses rtol 2e-6,
params and the (T,) flat momentum atol 1e-6 + rtol 1e-5; the momentum
is JAX's sharded optax trace, gathered, against the port's
`TrainState.momentum_global()`. And the port continues a JAX ZeRO-2 run
through the flat momentum bridge (weights.momentum_shard_from_optax):
2 JAX steps, then 2 port steps, against 4 JAX steps."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dp_worker import run_group
from distributed_vgg_f_tpu.models.vggf import VGGF as JaxVGGF
from distributed_vgg_f_tpu.parallel.buckets import build_bucket_layout
from distributed_vgg_f_tpu.parallel.mesh import (MeshSpec, build_mesh,
                                                 shard_host_batch)
from distributed_vgg_f_tpu.parallel.zero import train_state_specs
from distributed_vgg_f_tpu.train.state import TrainState
from distributed_vgg_f_tpu.train.step import build_train_step
from distributed_vgg_f_tpu_torch.weights import (
    momentum_global_from_shards, momentum_shard_from_optax, params_to_flax)

WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
SIZE, CLASSES, BATCH, LR, WD = 32, 10, 16, 0.05, 1e-4
BUCKET_MB = 0.0005
STEPS = 3
SPEC = {"widths": WIDTHS, "size": SIZE, "classes": CLASSES, "batch": BATCH,
        "lr": LR, "weight_decay": WD}


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


class _Jax:
    """JAX's ZeRO-2 bucketed step on an n-device CPU mesh."""

    def __init__(self, n, accum):
        self.mesh = build_mesh(MeshSpec(("data",), (n,)),
                               devices=jax.devices()[:n])
        self.model = JaxVGGF(num_classes=CLASSES, dropout_rate=0.0,
                             compute_dtype=jnp.float32, **WIDTHS)
        tx = optax.sgd(LR, momentum=0.9)
        sample = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
        shapes = jax.eval_shape(
            lambda r: TrainState.create(self.model, tx, r, sample,
                                        zero1_shards=n), jax.random.key(0))
        layout = build_bucket_layout(shapes.params, n,
                                     int(round(BUCKET_MB * 1024 * 1024)))

        def create(r):
            return TrainState.create(self.model, tx, r, sample,
                                     zero1_shards=n, bucket_layout=layout)

        specs = train_state_specs(jax.eval_shape(create, jax.random.key(0)),
                                  layout.total_padded, "data")
        shardings = jax.tree.map(lambda s: NamedSharding(self.mesh, s),
                                 specs, is_leaf=lambda x: isinstance(x, P))
        self.state = jax.jit(create, out_shardings=shardings)(
            jax.random.key(0))
        self.step = build_train_step(
            self.model, tx, self.mesh, weight_decay=WD, zero1=True,
            state_specs=specs, grad_accum_steps=accum, shard_gradients=True,
            comm_bucket_mb=BUCKET_MB)

    def run(self, state, batches):
        losses = []
        for b in batches:
            state, m = self.step(state, shard_host_batch(b, self.mesh),
                                 jax.random.key(1))
            losses.append(float(jax.device_get(m["loss"])))
        return state, np.array(losses)


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"image": rng.standard_normal(
                 (BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module", params=[2, 4])
def anchored(request, tmp_path_factory):
    """JAX's runs on an n-device mesh and the port's in n gloo processes,
    every case of one size in one launch."""
    n = request.param
    batches = _batches(STEPS + 1)
    arrays = {}
    for i, b in enumerate(batches):
        arrays[f"batch{i}/image"] = b["image"]
        arrays[f"batch{i}/label"] = b["label"]
    jax_out, cases = {}, []
    for accum in (1, 2):
        j = _Jax(n, accum)
        init = _tree(j.state.params)
        state, losses = j.run(j.state, batches[:STEPS])
        jax_out[accum] = (losses, _tree(state.params),
                          np.asarray(state.opt_state[0].trace))
        cases.append(dict(name=f"accum{accum}", zero1=True, zero2=True,
                          bucket_mb=BUCKET_MB, accum=accum, steps=STEPS))
    # the bridge: 2 JAX steps, then the port, against 4 JAX steps
    j = _Jax(n, 1)
    full, _ = j.run(j.state, batches)
    half, _ = j.run(j.state, batches[:2])
    jax_out["full"] = (None, _tree(full.params),
                       np.asarray(full.opt_state[0].trace))
    cases.append(dict(name="resumed", zero1=True, zero2=True,
                      bucket_mb=BUCKET_MB, steps=2, resume="half",
                      resume_step=2, first_batch=2))
    for layer, leaves in init.items():
        for leaf, v in leaves.items():
            arrays[f"params/{layer}/{leaf}"] = v
    for layer, leaves in _tree(half.params).items():
        for leaf, v in leaves.items():
            arrays[f"half/params/{layer}/{leaf}"] = v
    arrays["half/trace"] = jax_out["half_trace"] = np.asarray(
        half.opt_state[0].trace)
    port = run_group(n, dict(SPEC, cases=cases), arrays,
                     str(tmp_path_factory.mktemp(f"zero_jax{n}")))
    return n, jax_out, port


def _port_params(rank_out, case):
    prefix = f"{case}/params/"
    return params_to_flax({k[len(prefix):]: torch.from_numpy(v)
                           for k, v in rank_out.items()
                           if k.startswith(prefix)})


def _assert_tree_close(got, want, atol=1e-6, rtol=1e-5):
    for layer in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{layer}/{leaf}")


@pytest.mark.parametrize("accum", [1, 2])
def test_zero2_bucketed_matches_jax(anchored, accum):
    n, jax_out, port = anchored
    losses, params, trace = jax_out[accum]
    r0 = port[0]
    np.testing.assert_allclose(r0[f"accum{accum}/loss"], losses, rtol=2e-6)
    for r in range(n):
        _assert_tree_close(_port_params(port[r], f"accum{accum}"), params)
    got = r0[f"accum{accum}/momentum"]
    assert got.shape == trace.shape
    np.testing.assert_allclose(got, trace, atol=1e-6, rtol=1e-5)
    assert np.abs(trace).max() > 0


def test_port_continues_jax_zero2_run_through_flat_momentum_bridge(anchored):
    n, jax_out, port = anchored
    _, params, trace = jax_out["full"]
    for r in range(n):
        _assert_tree_close(_port_params(port[r], "resumed"), params)
    np.testing.assert_allclose(port[0]["resumed/momentum"], trace,
                               atol=1e-6, rtol=1e-5)
    # the bridge's two directions: (T,) -> each rank's (S,) -> (T,)
    half = types.SimpleNamespace(trace=jax_out["half_trace"])
    shards = [momentum_shard_from_optax((half,), r, n) for r in range(n)]
    np.testing.assert_array_equal(momentum_global_from_shards(shards),
                                  jax_out["half_trace"])

"""The port's BatchNorm (ops/batch_norm.py) against Flax's, and its
cross-replica form against JAX's `pmean` BatchNorm.

- One process: `BatchNorm` in training mode against `flax.linen.BatchNorm`
  (momentum 0.9, eps 1e-5, dtype the compute dtype, fp32 params) on the
  same NHWC input (the port's NCHW view of it), in fp32 and bf16: the
  output, the new running statistics, and the gradients of x, scale and
  bias of sum(y * dy). Tolerances: fp32 rtol 1e-5 / atol 1e-5 (sums in
  another order); bf16 outputs and dx within one bf16 ulp (rtol 8e-3 with
  atol 8e-3 of the largest value: both round the same fp32 value, whose
  last bits may differ), statistics and the fp32 scale/bias gradients
  rtol 1e-4 (sums of bf16 inputs in another order). Eval mode reads the
  running statistics.
- Two gloo ranks (tests/_torch_zoo_worker.py) fed halves with different
  statistics (rank 1's rows shifted by 3 and scaled by 2) against
  `shard_map` of the same Flax layer with axis_name "data" over a
  2-device CPU mesh: each rank's output, dx, its own dscale and dbias,
  and the running statistics (the same on both ranks); and the gradient
  through collectives.pmean against `lax.pmean`'s transpose. fp32, rtol
  1e-5 / atol 1e-5.
- `axis_name=None` on the same two ranks stays local: each rank matches
  Flax's layer without an axis on its own rows."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_zoo_worker import run_group
from distributed_vgg_f_tpu.parallel.compat import shard_map
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu_torch.ops.batch_norm import BatchNorm
from distributed_vgg_f_tpu_torch.parallel.collectives import pmean

N, H, W, C = 8, 5, 3, 6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32) * 1.5 + 0.5
    x[N // 2:] = x[N // 2:] * 2.0 + 3.0     # rank 1's rows: other stats
    return {"x": x,
            "dy": rng.standard_normal((N, H, W, C)).astype(np.float32),
            "scale": (1.0 + 0.3 * rng.standard_normal(C)).astype(np.float32),
            "bias": (0.2 * rng.standard_normal(C)).astype(np.float32),
            "p": rng.standard_normal((2, C)).astype(np.float32),
            "w": rng.standard_normal((2, C)).astype(np.float32)}


def _flax_bn(dtype, axis_name=None):
    return nn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=dtype, param_dtype=jnp.float32,
                        axis_name=axis_name)


def _variables(a):
    return {"params": {"scale": jnp.asarray(a["scale"]),
                       "bias": jnp.asarray(a["bias"])},
            "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}


def _flax_run(bn, v, x, dy):
    """(y, new stats, dx, dscale, dbias) of sum(y * dy) for one replica."""
    def loss(params, x):
        y, new = bn.apply({**v, "params": params}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * dy), (y, new["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], x)
    return y, stats, gx, gp["scale"], gp["bias"]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(dtype):
    a = _inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(a["x"]).astype(jdt)
    y, stats, gx, gs, gb = _flax_run(_flax_bn(jdt), _variables(a), xj,
                                     jnp.asarray(a["dy"]))
    x = _nchw(a["x"]).to(tdt).requires_grad_()
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(a["scale"]))
        bn.bias.copy_(torch.from_numpy(a["bias"]))
    got = bn(x, train=True)
    assert got.dtype == tdt
    (got.float() * _nchw(a["dy"])).sum().backward()
    fp32 = dtype == "float32"
    for g, w in ((_nhwc(got), y), (_nhwc(x.grad), gx)):
        w = np.asarray(w.astype(jnp.float32))
        tol = 1e-5 if fp32 else 8e-3 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-5 if fp32 else 8e-3,
                                   atol=tol)
    rtol = 1e-5 if fp32 else 1e-4
    for g, w in ((bn.mean, stats["mean"]), (bn.var, stats["var"]),
                 (bn.weight.grad, gs), (bn.bias.grad, gb)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=rtol)
    # eval reads the running statistics
    v = {"params": _variables(a)["params"], "batch_stats": stats}
    want = nn.BatchNorm(use_running_average=True, momentum=0.9,
                        epsilon=1e-5, dtype=jdt).apply(v, xj)
    with torch.no_grad():
        ev = bn(x, train=False)
    np.testing.assert_allclose(
        _nhwc(ev), np.asarray(want.astype(jnp.float32)),
        rtol=1e-5 if fp32 else 8e-3,
        atol=1e-5 if fp32 else 8e-3 * float(np.abs(want).max()))


def _arrays(name, a):
    return {f"{name}/{k}": (_nchw(v).numpy() if k in ("x", "dy") else v)
            for k, v in a.items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    a = _inputs(1)
    cases = [{"name": "sync", "kind": "bn", "axis": "data"},
             {"name": "local", "kind": "bn", "axis": None}]
    arrays = {**_arrays("sync", a), **_arrays("local", a)}
    out = run_group(2, {"cases": cases}, arrays,
                    str(tmp_path_factory.mktemp("sync_bn")))
    return a, out


def test_sync_bn_on_two_ranks_matches_jax_pmean(two_ranks):
    a, out = two_ranks
    mesh = build_mesh(MeshSpec(("data",), (2,)), devices=jax.devices()[:2])
    bn = _flax_bn(jnp.float32, "data")
    v = _variables(a)

    def replica(xs, dys):
        y, stats, gx, gs, gb = _flax_run(bn, v, xs, dys)
        return y, stats, gx, gs[None], gb[None]

    f = shard_map(replica, mesh=mesh, in_specs=(P("data"), P("data")),
                  out_specs=(P("data"), P(), P("data"), P("data"),
                             P("data")), check_vma=False)
    y, stats, gx, gs, gb = jax.jit(f)(jnp.asarray(a["x"]),
                                      jnp.asarray(a["dy"]))
    half = N // 2
    for r, o in enumerate(out):
        rows = slice(r * half, (r + 1) * half)
        for key, want in (("y", y[rows]), ("dx", gx[rows])):
            np.testing.assert_allclose(
                o[f"sync/{key}"].transpose(0, 2, 3, 1), np.asarray(want),
                rtol=1e-5, atol=1e-5, err_msg=f"rank {r} {key}")
        for key, want in (("dscale", gs[r]), ("dbias", gb[r]),
                          ("mean", stats["mean"]), ("var", stats["var"])):
            np.testing.assert_allclose(o[f"sync/{key}"], np.asarray(want),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {key}")
    # the statistics are the global batch's: the ranks agree bit for bit
    np.testing.assert_array_equal(out[0]["sync/mean"], out[1]["sync/mean"])
    np.testing.assert_array_equal(out[0]["sync/var"], out[1]["sync/var"])
    # and they are not either rank's own
    assert not np.allclose(out[0]["sync/mean"],
                           0.1 * a["x"][:half].mean((0, 1, 2)), atol=1e-3)


def test_pmean_gradient_is_the_transpose_of_jax_pmean(two_ranks):
    a, out = two_ranks
    mesh = build_mesh(MeshSpec(("data",), (2,)), devices=jax.devices()[:2])

    def replica(p, w):
        m, g = jax.value_and_grad(
            lambda p: jnp.sum(jax.lax.pmean(p, "data") * w))(p)
        return jax.lax.pmean(p, "data"), g

    f = shard_map(replica, mesh=mesh, in_specs=(P("data"), P("data")),
                  out_specs=(P("data"), P("data")), check_vma=False)
    m, g = jax.jit(f)(jnp.asarray(a["p"]), jnp.asarray(a["w"]))
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["sync/pmean"], np.asarray(m[r]),
                                   rtol=1e-6)
        np.testing.assert_allclose(o["sync/pmean_grad"], np.asarray(g[r]),
                                   rtol=1e-6)
    # the gradient is the mean of both ranks' w, not this rank's own
    np.testing.assert_allclose(out[0]["sync/pmean_grad"],
                               a["w"].mean(0), rtol=1e-6)


def test_pmean_without_a_group_returns_its_input():
    x = torch.arange(4.0, requires_grad=True)
    assert pmean(x) is x


def test_bn_without_axis_stays_local_on_two_ranks(two_ranks):
    a, out = two_ranks
    half = N // 2
    for r, o in enumerate(out):
        rows = slice(r * half, (r + 1) * half)
        y, stats, gx, gs, gb = _flax_run(
            _flax_bn(jnp.float32), _variables(a),
            jnp.asarray(a["x"][rows]), jnp.asarray(a["dy"][rows]))
        np.testing.assert_allclose(o["local/y"].transpose(0, 2, 3, 1),
                                   np.asarray(y), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o["local/dx"].transpose(0, 2, 3, 1),
                                   np.asarray(gx), rtol=1e-5, atol=1e-5)
        for key, want in (("dscale", gs), ("dbias", gb),
                          ("mean", stats["mean"]), ("var", stats["var"])):
            np.testing.assert_allclose(o[f"local/{key}"], np.asarray(want),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {key}")
    assert not np.allclose(out[0]["local/mean"], out[1]["local/mean"])

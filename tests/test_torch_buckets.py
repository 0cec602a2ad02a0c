"""The port's bucket layout and ZeRO flat layout (distributed_vgg_f_tpu_torch/
parallel/buckets.py, parallel/zero.py) against the JAX package's, with no
process group: JAX's `build_bucket_layout` on the Flax params of narrow
VGG-F and of the full-width flagship (shapes from `jax.eval_shape`), the
port's from the port's model. The geometry receipt, the bucket
membership in Flax names and the (T,) `to_global` vectors of the same
weights are held equal element for element; the wire byte accounting
equal for dp, zero1 and zero2 on both wires. Plus the port's mesh config
against the JAX package's checks and presets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.models.vggf import VGGF as JaxVGGF
from distributed_vgg_f_tpu.parallel import buckets as jbuckets
from distributed_vgg_f_tpu.parallel import zero as jzero
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.models.vggf import VGGF
from distributed_vgg_f_tpu_torch.parallel import (buckets,
                                                  collectives, zero)
from distributed_vgg_f_tpu_torch.weights import params_from_flax

NARROW = dict(stem_features=8, conv_features=16, fc_features=32)
FULL = dict(stem_features=64, conv_features=256, fc_features=4096)
MB = 1024 * 1024


def _shapes(widths, size, classes):
    model = JaxVGGF(num_classes=classes, dropout_rate=0.0, **widths)
    return jax.eval_shape(
        lambda r: model.init(r, jnp.zeros((1, size, size, 3)))["params"],
        jax.random.key(0))


def _weights(shapes, seed=0):
    """Random fp32 leaves of the given shapes: distinct values, so any
    permutation of the flat vector shows."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _port_model(widths, size, classes):
    with torch.device("meta"):
        return VGGF(classes, compute_dtype=torch.float32, image_size=size,
                    **widths)


CASES = {   # name: (widths, size, classes, num_shards, bucket MB)
    "narrow_n1_small": (NARROW, 32, 10, 1, 0.0005),
    "narrow_n2_small": (NARROW, 32, 10, 2, 0.0005),
    "narrow_n4_big": (NARROW, 32, 10, 4, 0.004),
    "narrow_n3_big": (NARROW, 32, 10, 3, 0.004),
    "flagship_n4_4mb": (FULL, 224, 1000, 4, 4.0),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    widths, size, classes, n, mb = CASES[request.param]
    shapes = _shapes(widths, size, classes)
    jl = jbuckets.build_bucket_layout(shapes, n, int(round(mb * MB)))
    model = _port_model(widths, size, classes)
    tl = buckets.build_bucket_layout(model, n, int(round(mb * MB)))
    return request.param, shapes, jl, tl, n


def _flax_names(shapes):
    return ["/".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(shapes)[0]]


def test_receipt_and_membership_match_jax(pair):
    name, shapes, jl, tl, n = pair
    assert tl.describe() == jl.describe(), name
    assert list(tl.names) == _flax_names(shapes)
    names = _flax_names(shapes)
    assert [[tl.names[i] for i in b] for b in tl.buckets] == [
        [names[i] for i in b] for b in jl.buckets]
    assert (tl.shard_size, tl.total_padded, tl.shard_sizes()) == (
        jl.shard_size, jl.total_padded, jl.shard_sizes())
    if name.startswith("flagship"):
        # fc8's and fc7's kernels are buckets of their own; more than one
        # bucket is in flight
        assert tl.num_buckets > 2 and tl.buckets[0] == (len(names) - 1,)


def test_to_global_equals_jax_element_for_element(pair):
    name, shapes, jl, tl, n = pair
    tree = _weights(shapes)
    want = np.array(jax.jit(jl.to_global)(tree))
    port = params_from_flax(tree)
    got = tl.to_global(tl.leaves(port)).numpy()
    np.testing.assert_array_equal(got, want, err_msg=name)
    # row r of the (N, S) view is rank r's parameter shard
    np.testing.assert_array_equal(
        tl.local_param_shard(tl.leaves(port), n - 1).numpy(),
        want.reshape(n, -1)[n - 1])
    # and back, exactly, in the port's layout
    back = tl.from_global(torch.from_numpy(want))
    assert set(back) == set(port)
    for k, v in port.items():
        assert torch.equal(back[k], v), k


def test_exchange_legs_without_a_group_are_the_mean_of_one():
    """No process group: the per-bucket mean is the gradient itself, the
    scatter's shard the whole `to_global` vector; a bf16 wire rounds."""
    shapes = _shapes(NARROW, 32, 10)
    port = params_from_flax(_weights(shapes, seed=2))
    layout = buckets.build_bucket_layout(_port_model(NARROW, 32, 10), 1,
                                         2048)
    grads = [g.clone() for g in layout.leaves(port)]
    layout.pmean_buckets(grads)
    assert all(torch.equal(g, w) for g, w in zip(grads,
                                                  layout.leaves(port)))
    shard = layout.scatter_mean_shards(layout.leaves(port))
    assert torch.equal(shard, layout.to_global(layout.leaves(port)))
    narrowed = layout.scatter_mean_shards(layout.leaves(port),
                                          wire_dtype="bfloat16")
    assert torch.equal(narrowed, shard.bfloat16().float())
    full = [torch.zeros_like(g) for g in grads]
    layout.gather_params(shard, full)
    assert all(torch.equal(g, w) for g, w in zip(full, layout.leaves(port)))


def test_collectives_without_a_group_are_one_rank():
    g = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    grads = [g.clone()]
    collectives.all_reduce_gradients(grads)
    assert torch.equal(grads[0], g)
    collectives.all_reduce_gradients(grads, reduce_dtype=torch.bfloat16)
    assert torch.equal(grads[0], g.bfloat16().float())
    assert collectives.cross_replica_mean(g) is g
    metrics = {"loss": g.sum(), "top1": g.mean()}
    assert collectives.cross_replica_mean(metrics) is metrics
    assert collectives.replica_index() == 0
    assert collectives.cast_to_wire(g, None) is g
    assert collectives.cast_from_wire(g.bfloat16(),
                                      torch.float32).dtype == torch.float32


def test_unbucketed_zero_layout_is_jax_ravel_order():
    shapes = _shapes(NARROW, 32, 10)
    tree = _weights(shapes, seed=1)
    total = jzero.flat_param_count(shapes)
    padded = jzero.padded_flat_size(total, 3)
    want = np.asarray(jzero.flatten_params(tree, padded))
    port = params_from_flax(tree)
    model = _port_model(NARROW, 32, 10)
    assert zero.flat_param_count(port) == total
    assert zero.padded_flat_size(total, 3) == padded
    got = zero.flatten_params(port, padded)
    np.testing.assert_array_equal(got.numpy(), want)
    layout = zero.zero_layout(model, 3, 0.0)
    assert layout.total_padded == padded and layout.num_buckets == 1
    np.testing.assert_array_equal(
        layout.to_global(layout.leaves(port)).numpy(), want)
    for k, v in zero.unflatten(got, port).items():
        assert torch.equal(v, port[k]), k
    assert zero.params_layout(got, total) == ("flat", padded)
    assert zero.params_layout(port, total) == ("tree", None)
    # bucketed flatten is `to_global`
    bl = buckets.build_bucket_layout(model, 3, 2048)
    np.testing.assert_array_equal(
        zero.flatten_params(port, padded, bucket_layout=bl).numpy(),
        np.asarray(jzero.flatten_params(
            tree, padded, bucket_layout=jbuckets.build_bucket_layout(
                shapes, 3, 2048))))


def test_layout_receipt_roundtrip_and_mismatch():
    model = _port_model(NARROW, 32, 10)
    layout = buckets.build_bucket_layout(model, 4, 1024)
    rebuilt = buckets.layout_from_receipt(model, layout.describe())
    assert rebuilt == layout
    bad = dict(layout.describe(), total_padded=layout.total_padded + 4)
    with pytest.raises(ValueError, match="does not reproduce"):
        buckets.layout_from_receipt(model, bad)
    # the same total, another partition: the per-bucket sizes catch it
    elems = list(layout.describe()["bucket_elems"])
    swapped = dict(layout.describe(),
                   bucket_elems=[elems[1], elems[0]] + elems[2:])
    with pytest.raises(ValueError, match="does not reproduce"):
        buckets.layout_from_receipt(model, swapped)
    with pytest.raises(ValueError, match="kind"):
        buckets.layout_from_receipt(model, {"kind": "nope"})
    assert buckets.build_bucket_layout(model, 4, 0) is None


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("basis", ["dp", "zero1", "zero2"])
def test_exchange_wire_bytes_match_jax(basis, wire):
    shapes = _shapes(FULL, 224, 1000)
    jl = jbuckets.build_bucket_layout(shapes, 4, 4 * MB)
    tl = buckets.build_bucket_layout(_port_model(FULL, 224, 1000), 4,
                                     4 * MB)
    zero_on = basis != "dp"
    jwire = None if wire == "float32" else jnp.bfloat16
    n_elem = jzero.flat_param_count(shapes)
    want = jbuckets.exchange_wire_bytes(n_elem, jl.total_padded,
                                        zero=zero_on, wire_dtype=jwire)
    assert buckets.exchange_wire_bytes(n_elem, tl.total_padded,
                                       zero=zero_on,
                                       wire_dtype=wire) == want
    assert tl.wire_bytes_per_step(zero=zero_on, wire_dtype=wire) == \
        jl.wire_bytes_per_step(zero=zero_on, wire_dtype=jwire)
    assert buckets.sharding_basis(zero_on, basis == "zero2") == \
        jbuckets.sharding_basis(zero_on, basis == "zero2") == basis


def test_mesh_config_validation():
    with pytest.raises(ValueError, match="comm_bucket_mb"):
        tcfg.MeshConfig(comm_bucket_mb=-1.0)
    with pytest.raises(ValueError, match="shard_params"):
        tcfg.MeshConfig(shard_opt_state=True, shard_params=True)
    assert tcfg.MeshConfig().sharding_label == "dp"
    assert tcfg.MeshConfig(shard_opt_state=True).sharding_label == "zero1"
    assert tcfg.MeshConfig(shard_opt_state=True,
                           shard_gradients=True).sharding_label == "zero2"
    # shard_gradients without the ZeRO-1 frame downgrades, as in JAX
    assert tcfg.MeshConfig(shard_gradients=True).sharding_label == "dp"
    for kw in ({}, {"shard_opt_state": True},
               {"shard_opt_state": True, "shard_gradients": True},
               {"shard_gradients": True}):
        assert tcfg.MeshConfig(**kw).sharding_label == \
            jcfg.MeshConfig(**kw).sharding_label


def test_flagship_ships_zero2_bucketed():
    flag = tcfg.get_config("vggf_imagenet_dp")
    ref = jcfg.get_config("vggf_imagenet_dp")
    for f in ("shard_opt_state", "shard_gradients", "comm_bucket_mb"):
        assert getattr(flag.mesh, f) == getattr(ref.mesh, f), f
    assert (flag.mesh.shard_opt_state, flag.mesh.shard_gradients,
            flag.mesh.comm_bucket_mb) == (True, True, 4.0)
    assert flag.mesh.sharding_label == "zero2"


def test_vit_inherits_the_flagship_mesh():
    assert tcfg.get_config("vit_s16_imagenet").mesh == \
        tcfg.get_config("vggf_imagenet_dp").mesh

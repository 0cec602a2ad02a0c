"""The zoo's two BASELINE models in the port — VGG-16 (models/vgg16.py) and
ResNet-50 (models/resnet.py) — against the JAX package's on the same
weights.

- Trees: at 1000 classes the port's parameters and BatchNorm statistics,
  through weights.flax_leaves and the statistics' Flax names, are JAX's
  leaf for leaf, in `jax.tree.leaves` order, by `jax.eval_shape` of the
  JAX init (VGG-16 138,357,544 in 32 leaves; ResNet-50 25,557,032 in 161
  leaves plus 53,120 statistics in 106 leaves); bn3's scale starts at
  zero, every other at one, the statistics at mean 0 and var 1.
- The weight bridge, statistics included, round-trips bitwise.
- Full depth and width at 64 px, batch 2, fp32: logits in eval and train
  mode (ResNet's BatchNorm on the batch's statistics, dropout off), the
  new running statistics, and the gradients of every parameter of
  sum(logits * w), against JAX's `model.apply` and `jax.grad` on the
  port's weights (ResNet's bn3 scales drawn small but not zero, where
  the init's zeros would zero every residual branch's gradient, and its
  running statistics near the batch's own, so that eval mode is about as
  well conditioned as training). Tolerances: logits and statistics atol
  1e-4 of the largest value with rtol 1e-4 (53 BatchNorms and 16 convs
  summed in another order by two frameworks' fp32 convolutions);
  gradients 1e-4 relative L2 per leaf (measured: at most 1.6e-5 for
  ResNet in train mode, 2.5e-6 for VGG-16).
- Both ResNet stems against JAX's `StemConv`, and the space_to_depth stem
  against the conv7 one on the port (even sizes, and the fallback on odd
  and small ones): atol 1e-5.
- Both models refuse a raw uint8 batch."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu.config import ModelConfig as JaxModelConfig
from distributed_vgg_f_tpu.models import build_model as jax_build_model
from distributed_vgg_f_tpu.models.resnet import StemConv as JaxStemConv
from distributed_vgg_f_tpu_torch.config import ModelConfig
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.models.resnet import StemConv
from distributed_vgg_f_tpu_torch.ops.batch_norm import batch_stats_of
from distributed_vgg_f_tpu_torch.weights import (flax_leaves,
                                                  init_batch_stats,
                                                  init_params, load_params,
                                                  params_from_flax,
                                                  params_to_flax)

COUNTS = {"vgg16": (138_357_544, 32, 0, 0),
          "resnet50": (25_557_032, 161, 53_120, 106)}


def _cfgs(name, dtype="float32", **extra):
    kw = dict(name=name, num_classes=1000, compute_dtype=dtype,
              dropout_rate=0.0, extra=extra)
    return ModelConfig(**kw), JaxModelConfig(**kw)


def _jax_shapes(name):
    model = jax_build_model(_cfgs(name)[1])
    return jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))


def _paths(tree):
    return [("/".join(str(k.key) for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("name", ["vgg16", "resnet50"])
def test_trees_are_jax_leaf_for_leaf(name):
    variables = _jax_shapes(name)
    model = build_model(_cfgs(name)[0], image_size=224)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    got = [(flax, shape) for flax, _, shape in flax_leaves(shapes)]
    want = _paths(variables["params"])
    assert got == want
    stats = batch_stats_of(model)
    want_stats = _paths(variables.get("batch_stats", {}))
    assert sorted((k.replace(".", "/"), tuple(v.shape))
                  for k, v in stats.items()) == want_stats
    n_params = sum(int(np.prod(s)) for _, s in got)
    n_stats = sum(v.numel() for v in stats.values())
    assert (n_params, len(got), n_stats, len(stats)) == COUNTS[name]


def test_resnet_init_scales_and_statistics():
    cfg = _cfgs("resnet50", stage_sizes=(1, 1))[0]
    tree, stats = init_params(cfg, 3, image_size=32), init_batch_stats(cfg)
    for layer in ("stage1_block1", "stage2_block1"):
        block = tree[layer]
        assert not block["bn3"]["scale"].any()
        for bn in ("bn1", "bn2", "bn_proj"):
            assert (block[bn]["scale"] == 1).all()
            assert not block[bn]["bias"].any()
        for bn in ("bn1", "bn2", "bn3", "bn_proj"):
            assert not stats[layer][bn]["mean"].any()
            assert (stats[layer][bn]["var"] == 1).all()
    assert (tree["bn_init"]["scale"] == 1).all()
    assert "bias" not in tree["conv_init"]
    assert tree["conv_init"]["kernel"].shape == (7, 7, 3, 64)


@pytest.mark.parametrize("name", ["vgg16", "resnet50"])
def test_weight_bridge_round_trips_bitwise(name):
    cfg = _cfgs(name)[0]
    tree = init_params(cfg, 1, image_size=64)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        init_batch_stats(cfg))
    model = load_params(build_model(cfg, image_size=64), tree, stats)
    back = params_to_flax(dict(model.named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    got = params_to_flax(batch_stats_of(model))
    assert jax.tree.structure(got) == jax.tree.structure(stats)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, b)
    again = params_from_flax(got)
    for k, v in batch_stats_of(model).items():
        assert torch.equal(again[k], v)
    assert set(params_from_flax(back)) == {
        k for k, _ in model.named_parameters()}


def test_load_params_is_strict_over_the_statistics():
    cfg = _cfgs("resnet50", stage_sizes=(1,))[0]
    model = build_model(cfg, image_size=32)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_params(model, init_params(cfg, 0, image_size=32))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
            rng.standard_normal((2, 1000)).astype(np.float32))


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


@pytest.mark.parametrize("name,extra", [
    ("vgg16", {}),
    ("resnet50", {"bn_axis_name": None}),
    ("resnet50", {"stem": "space_to_depth"}),
])
@pytest.mark.parametrize("train", [False, True])
def test_full_model_forward_and_gradients_match_jax(batch, name, extra,
                                                    train):
    x, w = batch
    cfg, jcfg = _cfgs(name, **extra)
    # JAX's ResNet binds "data" in training; at one replica the port's
    # local statistics are the global ones
    jcfg_run = (_cfgs(name, **{**extra, "bn_axis_name": None})[1]
                if name == "resnet50" else jcfg)
    tree = init_params(cfg, 5, image_size=64)
    stats = init_batch_stats(cfg)
    jmodel = jax_build_model(jcfg_run)
    if stats:
        # bn3's scales at 0.05-0.15, a near-identity branch as early in
        # training (its zeros would zero every branch's gradient; at O(1),
        # train-mode BatchNorm over a batch of 2 is so ill-conditioned
        # that the port's own fp32 and fp64 gradients differ by 2-4%),
        # and running statistics near this batch's own
        # (its means, its variances plus 0.5: at batch 2 a stage-4 channel
        # has 8 values, and a near-zero variance would amplify any
        # rounding by rsqrt(1e-5))
        rng = np.random.default_rng(3)
        tree = jax.tree_util.tree_map_with_path(
            lambda path, a: rng.uniform(0.05, 0.15, a.shape).astype(
                np.float32) if path[-2:] == ("bn3", "scale") else a, tree)
        _, new = jmodel.apply({"params": tree, "batch_stats": stats}, x,
                              train=True, mutable=["batch_stats"])
        stats = jax.tree_util.tree_map_with_path(
            lambda path, n, o: np.asarray((n - 0.9 * o) / 0.1 + (
                0.5 if path[-1].key == "var" else 0.0), np.float32),
            new["batch_stats"], stats)
    model = load_params(build_model(cfg, image_size=64), tree, stats)
    logits = model(torch.from_numpy(x), train=train)
    (logits * torch.from_numpy(w)).sum().backward()

    def loss(params):
        v = {"params": params}
        if stats:
            v["batch_stats"] = stats
        if train and stats:
            out, new = jmodel.apply(v, x, train=True,
                                    mutable=["batch_stats"])
            new = new["batch_stats"]
        else:
            out, new = jmodel.apply(v, x, train=train), stats
        return jnp.sum(out * w), (out, new)

    (_, (want, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(tree)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)
    if stats:
        got = params_to_flax(batch_stats_of(model))
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree.leaves(new_stats)):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(b).max()),
                                       err_msg=str(path))
    got_grads = params_to_flax({k: p.grad for k, p in
                                model.named_parameters()})
    errs = {"/".join(str(k.key) for k in path):
            _rel_l2(a, np.asarray(b))
            for (path, a), b in zip(
                jax.tree_util.tree_leaves_with_path(got_grads),
                jax.tree.leaves(grads))}
    bad = {k: e for k, e in errs.items() if e > 1e-4}
    assert not bad, bad


@pytest.mark.parametrize("stem", ["conv7", "space_to_depth"])
@pytest.mark.parametrize("size", [16, 32, 31, 6])
def test_stems_match_jax(stem, size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((7, 7, 3, 64))).astype(np.float32)
    want = JaxStemConv(64, jnp.float32, stem=stem).apply(
        {"params": {"kernel": kernel}}, x)
    mod = StemConv(64, stem)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
        plain = StemConv(64, "conv7")
        plain.weight.copy_(mod.weight)
        ref = plain(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_unknown_stem_raises():
    with pytest.raises(ValueError, match="stem"):
        StemConv(64, "conv11")


@pytest.mark.parametrize("name", ["vgg16", "resnet50"])
def test_models_refuse_raw_uint8(name):
    cfg = _cfgs(name, **({"stage_sizes": (1,)} if name == "resnet50"
                         else {}))[0]
    model = build_model(cfg, image_size=32)
    with pytest.raises(TypeError, match="uint8"):
        model(torch.zeros((1, 32, 32, 3), dtype=torch.uint8))


def test_vgg16_train_dropout_needs_a_generator():
    cfg = ModelConfig(name="vgg16", num_classes=10, compute_dtype="float32",
                      extra={"block_sizes": (1, 1), "block_features": (4, 8)})
    model = load_params(build_model(cfg, image_size=32),
                        init_params(cfg, 0, image_size=32))
    x = torch.randn(2, 32, 32, 3)
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    a = model(x, train=True, generator=gen())
    b = model(x, train=True, generator=gen())
    assert torch.equal(a, b) and not torch.equal(a, model(x))


def test_flax_batch_norm_is_the_zoo_layer():
    """The JAX ResNet's BatchNorm leaves are `scale`, `bias`, `mean`,
    `var`: the names the bridge maps `weight`, `bias` and the buffers
    to."""
    v = jax.eval_shape(lambda: nn.BatchNorm(use_running_average=True).init(
        jax.random.key(0), jnp.zeros((1, 3))))
    assert sorted(v["params"]) == ["bias", "scale"]
    assert sorted(v["batch_stats"]) == ["mean", "var"]

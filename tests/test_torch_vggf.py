"""The port's VGG-F (distributed_vgg_f_tpu_torch/models/vggf.py), pooling
and weight bridge against the JAX package on the same weights and inputs.

Tolerances: fp32 logits rtol/atol 1e-4 at 32 px and 1e-3 at 224 px (the
reference parity test's bound; sums run in another order in the two
frameworks, and fc6 sums 9216 terms at 224 px). bf16 compute at 32 px:
rtol 2e-2 with atol 2e-2 * max|logit| — both models round every
activation to bf16 (8 mantissa bits, 2**-8 relative), at points that
differ between the two frameworks by at most one rounding per op, and
one such step can carry through the remaining layers.

The stem (JAX `Conv1SpaceToDepth`): the packed 3x3x48 stride-1 conv
against JAX's on the same weights, and against the port's plain 11x11/4
conv, outputs and weight gradients: rtol/atol 1e-5 (JAX's own stem test's
bound; the two convs sum the same 363 products in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu.config import ModelConfig as JaxModelConfig
from distributed_vgg_f_tpu.data.device_ingest import \
    space_to_depth_batch as jax_space_to_depth
from distributed_vgg_f_tpu.models.registry import build_model as jax_build
from distributed_vgg_f_tpu.ops.pooling import maxpool_3x3s2_ceil as jax_pool
from distributed_vgg_f_tpu_torch.config import ModelConfig
from distributed_vgg_f_tpu_torch.data.device_ingest import \
    space_to_depth_batch
from distributed_vgg_f_tpu_torch.models.ingest import reject_raw_uint8
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.models.vggf import (VGGF, depth_to_space,
                                                     pack_stem_weight,
                                                     takes_packed_stem)
from distributed_vgg_f_tpu_torch.ops import lrn_cuda
from distributed_vgg_f_tpu_torch.ops.pooling import maxpool_3x3s2_ceil
from distributed_vgg_f_tpu_torch.weights import (init_params, load_npz,
                                                  load_params,
                                                  params_from_flax,
                                                  params_to_flax)


def _flax(size, num_classes, dtype="float32", name="vggf", seed=0):
    model = jax_build(JaxModelConfig(name=name, num_classes=num_classes,
                                     compute_dtype=dtype))
    x0 = jnp.zeros((1, size, size, 3), jnp.float32)
    params = model.init(jax.random.key(seed), x0, train=False)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(size, num_classes, tree, dtype="float32", name="vggf"):
    model = build_model(ModelConfig(name=name, num_classes=num_classes,
                                    compute_dtype=dtype), image_size=size)
    return load_params(model, tree).eval()


def _images(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


# ----------------------------------------------------------------- pooling
@pytest.mark.parametrize("shape", [(2, 1, 1, 4), (2, 2, 2, 4),
                                   (2, 5, 5, 3), (1, 6, 7, 2),
                                   (1, 54, 54, 3), (1, 13, 13, 2)])
def test_pool_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x)))
    got = maxpool_3x3s2_ceil(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- weight bridge
@pytest.mark.parametrize("name", ["vggf", "vggf_student"])
def test_weight_bridge_round_trip_is_bitwise(name):
    _, tree = _flax(32, 10, name=name)
    sd = params_from_flax(tree)
    assert sd["conv1.weight"].shape[1:] == (3, 11, 11)
    back = params_to_flax(sd)
    assert back.keys() == tree.keys()
    for layer in tree:
        for leaf in ("kernel", "bias"):
            assert back[layer][leaf].dtype == tree[layer][leaf].dtype
            np.testing.assert_array_equal(back[layer][leaf],
                                          tree[layer][leaf])
    # and through a model's state_dict
    model = _port(32, 10, tree, name=name)
    again = params_to_flax(model.state_dict())
    for layer in tree:
        np.testing.assert_array_equal(again[layer]["kernel"],
                                      tree[layer]["kernel"])


def test_load_npz_reads_flat_layer_leaf_file(tmp_path):
    _, tree = _flax(32, 10)
    path = tmp_path / "params.npz"
    np.savez(path, **{f"{layer}/{leaf}": tree[layer][leaf]
                      for layer in tree for leaf in tree[layer]})
    loaded = load_npz(str(path))
    for layer in tree:
        for leaf in tree[layer]:
            np.testing.assert_array_equal(loaded[layer][leaf],
                                          tree[layer][leaf])


def test_init_params_seeded_with_flax_shapes():
    _, tree = _flax(32, 10)
    cfg = ModelConfig(num_classes=10, compute_dtype="float32")
    a = init_params(cfg, 3, image_size=32)
    b = init_params(cfg, 3, image_size=32)
    c = init_params(cfg, 4, image_size=32)
    assert a.keys() == tree.keys()
    for layer in tree:
        for leaf in ("kernel", "bias"):
            assert a[layer][leaf].shape == tree[layer][leaf].shape
            np.testing.assert_array_equal(a[layer][leaf], b[layer][leaf])
        assert not np.array_equal(a[layer]["kernel"], c[layer]["kernel"])
        assert not a[layer]["bias"].any()
        # truncated at two standard deviations of the lecun stddev
        k = a[layer]["kernel"]
        fan_in = int(np.prod(k.shape[:-1]))
        assert np.abs(k).max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.8796 + 1e-6


# ------------------------------------------------------------------ logits
def test_logits_match_flax_32px_fp32():
    flax_model, tree = _flax(32, 10)
    x = _images(3, 32)
    want = np.asarray(flax_model.apply({"params": tree}, jnp.asarray(x),
                                       train=False))
    got = _logits(_port(32, 10, tree), x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.std(want) > 1e-4


def test_logits_match_flax_224px_full_width_fp32():
    flax_model, tree = _flax(224, 1000)
    x = _images(1, 224, seed=1)
    want = np.asarray(flax_model.apply({"params": tree}, jnp.asarray(x),
                                       train=False))
    got = _logits(_port(224, 1000, tree), x)
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_logits_match_flax_32px_bf16():
    flax_model, tree = _flax(32, 10, dtype="bfloat16")
    x = _images(3, 32, seed=2)
    want = np.asarray(flax_model.apply({"params": tree}, jnp.asarray(x),
                                       train=False))
    model = _port(32, 10, tree, dtype="bfloat16")
    got = _logits(model, x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


def test_student_logits_match_flax():
    flax_model, tree = _flax(32, 10, name="vggf_student")
    x = _images(2, 32, seed=3)
    want = np.asarray(flax_model.apply({"params": tree}, jnp.asarray(x),
                                       train=False))
    got = _logits(_port(32, 10, tree, name="vggf_student"), x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_packed_and_plain_input_give_equal_logits():
    flax_model, tree = _flax(32, 10)
    model = _port(32, 10, tree)
    x = _images(2, 32, seed=4)
    packed = space_to_depth_batch(torch.from_numpy(x))
    assert packed.shape == (2, 8, 8, 48)
    with torch.no_grad():
        plain_logits = model(torch.from_numpy(x))
        packed_logits = model(packed)
    assert torch.equal(plain_logits, packed_logits)
    # the JAX stem takes the same packed layout
    want = np.asarray(flax_model.apply(
        {"params": tree}, jax_space_to_depth(jnp.asarray(x)), train=False))
    np.testing.assert_allclose(packed_logits.numpy(), want, rtol=1e-4,
                               atol=1e-4)


# -------------------------------------------------------------------- stem
def _jax_stem(size, features=16, seed=0):
    from distributed_vgg_f_tpu.models.vggf import Conv1SpaceToDepth
    mod = Conv1SpaceToDepth(features=features, compute_dtype=jnp.float32)
    variables = mod.init(jax.random.key(seed),
                         jnp.zeros((1, size, size, 3), jnp.float32))
    return mod, variables


def _port_stem(variables, size):
    """A narrow port VGG-F whose conv1 holds the JAX stem's weights."""
    kernel = np.asarray(variables["params"]["kernel"])     # HWIO
    model = VGGF(10, compute_dtype=torch.float32, image_size=max(size, 32),
                 stem_features=kernel.shape[-1], conv_features=8,
                 fc_features=8)
    with torch.no_grad():
        model.conv1.weight.copy_(torch.from_numpy(
            kernel.transpose(3, 2, 0, 1).copy()))
        model.conv1.bias.copy_(torch.from_numpy(
            np.array(variables["params"]["bias"])))
    return model


def _stem_nhwc(model, x):
    return model.stem(x).permute(0, 2, 3, 1)


@pytest.mark.parametrize("size", [224, 32, 12])
@pytest.mark.parametrize("packed", [False, True])
def test_packed_stem_matches_jax_conv1_space_to_depth(size, packed):
    mod, variables = _jax_stem(size, seed=size)
    x = _images(2, size, seed=size)
    xin = space_to_depth_batch(torch.from_numpy(x)) if packed \
        else torch.from_numpy(x)
    want = np.asarray(mod.apply(variables, jnp.asarray(xin.numpy())))
    model = _port_stem(variables, size)
    assert takes_packed_stem(*xin.shape[1:])
    with torch.no_grad():
        got = _stem_nhwc(model, xin).numpy()
    assert got.shape == want.shape == (2, (size - 11) // 4 + 1,
                                       (size - 11) // 4 + 1, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_packed_stem_equals_the_plain_conv_and_its_weight_gradient():
    """The packed conv and the plain 11x11/4 conv on the same weight: the
    outputs, and the weight's gradient through the rearrangement (the
    padded 12th tap's gradient dropped by the pad's backward)."""
    torch.manual_seed(0)
    w = (torch.randn(16, 3, 11, 11) * 0.05).requires_grad_()
    x = torch.from_numpy(_images(3, 64, seed=11))
    g = torch.randn(3, 16, 14, 14)
    packed = torch.nn.functional.conv2d(
        space_to_depth_batch(x).permute(0, 3, 1, 2), pack_stem_weight(w))
    (gw_packed,) = torch.autograd.grad((packed * g).sum(), w)
    plain = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, stride=4)
    (gw_plain,) = torch.autograd.grad((plain * g).sum(), w)
    assert packed.shape == plain.shape == (3, 16, 14, 14)
    np.testing.assert_allclose(packed.detach().numpy(),
                               plain.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw_packed.numpy(), gw_plain.numpy(),
                               rtol=1e-5,
                               atol=1e-5 * float(gw_plain.abs().max()))
    assert pack_stem_weight(w).shape == (16, 48, 3, 3)


@pytest.mark.parametrize("size", [30, 8])
def test_stem_falls_back_where_jax_does(size):
    """H not a multiple of 4 (30) or under 12 (8): the plain 11x11/4
    conv, as JAX's stem; at 8 px both give an empty map."""
    mod, variables = _jax_stem(size, seed=size)
    x = _images(2, size, seed=size)
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    model = _port_stem(variables, size)
    assert not takes_packed_stem(size, size, 3)
    with torch.no_grad():
        got = _stem_nhwc(model, torch.from_numpy(x))
        plain = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), model.conv1.weight,
            model.conv1.bias, stride=4).permute(0, 2, 3, 1) \
            if size >= 11 else got
    assert got.shape == want.shape
    assert want.size == 0 or size == 30
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_depth_to_space_inverts_space_to_depth():
    x = torch.from_numpy(_images(2, 16, seed=5))
    assert torch.equal(depth_to_space(space_to_depth_batch(x)), x)


def test_raw_uint8_batch_is_rejected():
    _, tree = _flax(32, 10)
    model = _port(32, 10, tree)
    raw = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match="raw uint8"):
        reject_raw_uint8(raw, "VGGF")
    with pytest.raises(TypeError, match="raw uint8"):
        model(raw)
    reject_raw_uint8(raw.float(), "VGGF")


def test_cpu_forward_launches_no_kernel():
    _, tree = _flax(32, 10)
    lrn_cuda.LAUNCHES = 0
    _logits(_port(32, 10, tree), _images(1, 32))
    assert lrn_cuda.LAUNCHES == 0


# --------------------------------------------------------------- gradients
def test_param_grads_match_flax_224px_full_width_fp32():
    """The one full-width CPU gradient check: batch 1, dropout off, the CE
    loss's gradient for every parameter, conv1 (through both LRN
    backwards) included, on the input of the 224 px logits test.
    Tolerance: atol 2e-5 of the layer's largest gradient plus rtol 1e-4
    (measured: within 3.1e-6 of the largest gradient in every layer).

    The gradient is discontinuous where a ReLU input is 0, so an input
    that puts a pre-activation within fp32 rounding of 0 can flip one
    ReLU between any two fp32 implementations: with the images of seed 8
    one conv3 unit flips, and the port's fp32 conv1-conv3 gradients then
    differ from its own fp64 gradients (and from Flax's) by 1-5% of the
    largest gradient, while conv4-fc8 still agree within 3e-6."""
    from distributed_vgg_f_tpu.ops.losses import \
        softmax_cross_entropy as jax_ce
    from distributed_vgg_f_tpu_torch.ops.losses import \
        softmax_cross_entropy
    flax_model, tree = _flax(224, 1000)
    x = _images(1, 224, seed=1)
    label = np.array([417], np.int32)

    def loss_fn(p):
        return jax_ce(flax_model.apply({"params": p}, jnp.asarray(x),
                                       train=False), jnp.asarray(label))

    want = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jax.grad(loss_fn))(tree))
    model = build_model(ModelConfig(num_classes=1000, dropout_rate=0.0,
                                    compute_dtype="float32"))
    model = load_params(model, tree)
    softmax_cross_entropy(model(torch.from_numpy(x), train=True),
                          torch.from_numpy(label).long()).backward()
    got = params_to_flax({k: p.grad for k, p in model.named_parameters()})
    for layer in want:
        for leaf in ("kernel", "bias"):
            w = want[layer][leaf]
            np.testing.assert_allclose(got[layer][leaf], w, rtol=1e-4,
                                       atol=2e-5 * np.abs(w).max(),
                                       err_msg=f"{layer}/{leaf}")
    assert np.abs(got["conv1"]["kernel"]).max() > 0

"""The port's ViT (distributed_vgg_f_tpu_torch/models/vit.py) against the
JAX package's Flax ViT on the same weights and inputs, at a narrow width
(hidden 64, depth 2, 2 heads of 32, MLP 128, 10 classes), on the CPU;
the JAX flash layout runs its Pallas kernels in interpret mode
(`INTERPRET` patched and restored), the port its plain versions.

Tolerances, fp32: logits rtol/atol 1e-4 (the VGG-F forward parity bound;
sums run in another order, and the port's LayerNorm takes a two-pass
variance where Flax takes E[x^2] - E[x]^2); parameter gradients within
1e-4 relative L2 per leaf; the 20-step trajectory: losses rtol 1e-5,
params atol 1e-6 + rtol 1e-5 (per-step rounding differences compound
over 20 updates). bf16 logits: 2e-2 of the largest logit (every
activation rounds to 8 mantissa bits through the blocks). The weight
bridge round trip is bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.models.vit import ViT as JaxViT
from distributed_vgg_f_tpu.ops import flash_attention as jflash
from distributed_vgg_f_tpu.ops.losses import \
    softmax_cross_entropy as jax_ce
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.train.schedule import \
    build_optimizer as jax_build_optimizer
from distributed_vgg_f_tpu.train.state import TrainState as JaxTrainState
from distributed_vgg_f_tpu.train.step import \
    build_train_step as jax_build_train_step
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.config import ModelConfig
from distributed_vgg_f_tpu_torch.data.synthetic import SyntheticU8
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.ops import flash_cuda
from distributed_vgg_f_tpu_torch.ops.losses import softmax_cross_entropy
from distributed_vgg_f_tpu_torch.serving.engine import build_engine
from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
from distributed_vgg_f_tpu_torch.train.state import TrainState
from distributed_vgg_f_tpu_torch.train.step import build_train_step
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.weights import (init_params, load_params,
                                                  momentum_from_optax,
                                                  params_to_flax)

WIDTHS = dict(hidden_dim=64, depth=2, num_heads=2, mlp_dim=128)
CLASSES = 10
LAYOUTS = ("head_major", "token_major", "flash")


@pytest.fixture(autouse=True)
def interpret():
    old = jflash.INTERPRET
    jflash.INTERPRET = True    # CPU: run the Pallas kernels interpreted
    try:
        yield
    finally:
        jflash.INTERPRET = old


def _extra(layout, patch=16):
    return dict(WIDTHS, patch_size=patch, attention_layout=layout)


def _jax_model(layout, dtype=jnp.float32, patch=16, dropout=0.0):
    return JaxViT(num_classes=CLASSES, dropout_rate=dropout,
                  compute_dtype=dtype, **_extra(layout, patch))


def _flax_tree(size, patch=16, seed=0):
    variables = _jax_model("head_major", patch=patch).init(
        {"params": jax.random.key(seed)}, jnp.zeros((1, size, size, 3)),
        train=False)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _port(layout, size, tree, dtype="float32", patch=16):
    cfg = ModelConfig(name="vit_s16", num_classes=CLASSES,
                      compute_dtype=dtype, dropout_rate=0.0,
                      extra=_extra(layout, patch))
    return load_params(build_model(cfg, image_size=size), tree)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _rel_l2(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("size", [32, 224])
def test_logits_match_flax_fp32(layout, size):
    """224 px is ViT's 197 tokens, which the JAX flash path pads to 256
    and masks; 32 px is 5 tokens in one block."""
    tree = _flax_tree(size)
    x = _images(2, size)
    want = np.asarray(_jax_model(layout).apply({"params": tree},
                                               jnp.asarray(x)))
    with torch.no_grad():
        got = _port(layout, size, tree)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["head_major", "flash"])
def test_logits_match_flax_bf16(layout):
    tree = _flax_tree(64)
    x = _images(2, 64, seed=1)
    want = np.asarray(_jax_model(layout, jnp.bfloat16).apply(
        {"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(layout, 64, tree, "bfloat16")(
            torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("layout", ["head_major", "flash"])
def test_param_grads_match_flax(layout):
    """Every parameter's gradient of the CE loss, patch_embed, qkv,
    pos_embed and cls included, at 224 px (197 tokens)."""
    size = 224
    tree = _flax_tree(size)
    x = _images(2, size, seed=2)
    labels = np.array([3, 7])

    def loss_fn(p):
        logits = _jax_model(layout).apply({"params": p}, jnp.asarray(x))
        return jax_ce(logits, jnp.asarray(labels))

    want = _leaves(jax.grad(loss_fn)(tree))
    model = _port(layout, size, tree)
    loss = softmax_cross_entropy(model(torch.from_numpy(x), train=True),
                                 torch.from_numpy(labels))
    loss.backward()
    got = _leaves(params_to_flax({k: p.grad for k, p in
                                  model.named_parameters()},
                                 num_heads=WIDTHS["num_heads"]))
    assert set(got) == set(want)
    errs = {k: _rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= 1e-4, errs
    for k in ("cls", "pos_embed", "patch_embed/kernel",
              "block0/attn/qkv/kernel"):
        assert np.abs(got[k]).max() > 0, k


def test_weight_bridge_round_trip_is_bitwise():
    tree = _flax_tree(32)
    model = _port("flash", 32, tree)
    back = _leaves(params_to_flax(model.state_dict(),
                                  num_heads=WIDTHS["num_heads"]))
    want = _leaves(tree)
    assert set(back) == set(want)
    for k in want:
        assert back[k].dtype == want[k].dtype and back[k].shape \
            == want[k].shape, k
        assert np.array_equal(back[k], want[k]), k
    sd = model.state_dict()
    assert sd["block0.attn.qkv.weight"].shape == (3 * 64, 64)
    assert sd["block0.attn.qkv.bias"].shape == (3 * 64,)
    assert sd["block0.attn.out.weight"].shape == (64, 64)
    assert sd["patch_embed.weight"].shape == (64, 3, 16, 16)
    assert sd["block1.ln2.weight"].shape == (64,)


def test_params_to_flax_needs_the_head_count():
    model = _port("flash", 32, _flax_tree(32))
    with pytest.raises(ValueError, match="num_heads"):
        params_to_flax(model.state_dict())


def test_init_params_has_the_flax_tree_and_initializers():
    cfg = ModelConfig(name="vit_s16", num_classes=CLASSES,
                      compute_dtype="float32", extra=_extra("flash"))
    tree = _leaves(init_params(cfg, 0, image_size=224))
    flax = _leaves(_flax_tree(224))
    assert {k: v.shape for k, v in tree.items()} \
        == {k: v.shape for k, v in flax.items()}
    assert all(v.dtype == np.float32 for v in tree.values())
    assert (tree["block0/ln1/scale"] == 1).all()
    assert (tree["block1/mlp/fc2/bias"] == 0).all()
    assert (tree["cls"] == 0).all()
    assert 0.015 < tree["pos_embed"].std() < 0.025
    # lecun normal over the contracted axes: qkv contracts D = 64, the
    # out projection (H, hd) = 64, the patch embedding 16*16*3
    for k, fan_in in (("block0/attn/qkv/kernel", 64),
                      ("block0/attn/out/kernel", 64),
                      ("patch_embed/kernel", 768)):
        assert abs(tree[k].std() * np.sqrt(fan_in) - 1.0) < 0.1, k
    again = _leaves(init_params(cfg, 0, image_size=224))
    assert all(np.array_equal(again[k], tree[k]) for k in tree)


@pytest.mark.parametrize("extra,match", [
    ({"attention_layout": "auto"}, "ROADMAP B8"),
    ({"attention_layout": "flash", "attention_dropout_rate": 0.1},
     "attention-weight dropout"),
    ({"attention_layout": "bogus"}, "unknown attention layout")])
def test_refused_layouts(extra, match):
    cfg = ModelConfig(name="vit_s16", num_classes=CLASSES,
                      extra=dict(WIDTHS, **extra))
    with pytest.raises(ValueError, match=match):
        build_model(cfg, image_size=32)


def test_head_major_attention_dropout_runs_and_raw_uint8_is_refused():
    cfg = ModelConfig(name="vit_s16", num_classes=CLASSES,
                      compute_dtype="float32",
                      extra=dict(WIDTHS, attention_dropout_rate=0.1))
    model = load_params(build_model(cfg, image_size=32),
                        init_params(cfg, 0, image_size=32))
    x = torch.from_numpy(_images(2, 32))
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)
    out = model(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
    with pytest.raises(TypeError, match="raw uint8"):
        model(torch.zeros(1, 32, 32, 3, dtype=torch.uint8))


# ------------------------------------------------------------- trajectory
SIZE, PATCH, BATCH = 32, 8, 8


def _configs():
    """vit_s16_imagenet in both packages, narrowed, dropout and augment
    off, batch 8, 8 steps an epoch: warmup over steps 0-7, then cosine."""
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_config("vit_s16_imagenet")
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model, num_classes=CLASSES,
                                      dropout_rate=0.0,
                                      compute_dtype="float32"),
            optim=dataclasses.replace(cfg.optim, base_lr=0.05,
                                      reference_batch_size=BATCH,
                                      warmup_epochs=1.0),
            data=dataclasses.replace(cfg.data, image_size=SIZE,
                                     global_batch_size=BATCH,
                                     num_train_examples=BATCH * 8),
            train=dataclasses.replace(cfg.train, epochs=4.0))
        out.append(cfg)
    return out


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal(
                 (BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, (BATCH,)).astype(np.int32)}
            for _ in range(n)]


def test_20_step_trajectory_matches_jax():
    jcfg_, cfg = _configs()
    model = _jax_model("flash", patch=PATCH)
    mesh = build_mesh(MeshSpec(("data",), (1,)), devices=jax.devices()[:1])
    tx, schedule = jax_build_optimizer(jcfg_)
    jstep = jax_build_train_step(model, tx, mesh, jcfg_.optim.weight_decay,
                                 schedule=schedule, skip_nonfinite=True)
    jstate = JaxTrainState.create(model, tx, jax.random.key(0),
                                  jnp.zeros((1, SIZE, SIZE, 3)))
    tree = jax.tree_util.tree_map(np.asarray, jstate.params)
    batches = _batches(20)
    want = []
    for b in batches:
        jstate, m = jstep(jstate, {"image": jnp.asarray(b["image"]),
                                   "label": jnp.asarray(b["label"])},
                          jax.random.key(1))
        want.append(float(m["loss"]))

    torch_model = _port("flash", SIZE, tree, patch=PATCH)
    opt, sched = build_optimizer(cfg, torch_model.parameters())
    state = TrainState.create(torch_model, opt)
    step = build_train_step(sched, cfg.optim.weight_decay,
                            skip_nonfinite=True, device="cpu")
    got = []
    for b in batches:
        state, m = step(state, b, 0)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    back = _leaves(params_to_flax(state.model.state_dict(),
                                  num_heads=WIDTHS["num_heads"]))
    final = _leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k in final:
        np.testing.assert_allclose(back[k], final[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the params moved, and the momentum bridge walks the nested trace
    assert not np.allclose(back["head/kernel"], _leaves(tree)["head/kernel"])
    mom = momentum_from_optax(jax.tree_util.tree_map(
        np.asarray, jstate.opt_state))
    port_mom = state.momentum()
    errs = {k: _rel_l2(port_mom[k].numpy(), buf.numpy())
            for k, buf in mom.items()}
    assert set(errs) == set(dict(state.model.named_parameters()))
    assert max(errs.values()) <= 1e-4, errs


def test_trainer_runs_the_flash_preset_with_dropout_and_augment():
    """The core loop needs nothing of its own for ViT: vit_s16_imagenet
    (narrowed, flash, dropout 0.1, flip and mixup) through Trainer.fit on
    the CPU, with no kernel launched."""
    cfg = tcfg.get_config("vit_s16_imagenet")
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, num_classes=CLASSES,
                                  extra=_extra("flash", PATCH)),
        data=dataclasses.replace(cfg.data, image_size=SIZE,
                                 global_batch_size=4),
        train=dataclasses.replace(cfg.train, log_every=1))
    assert cfg.data.augment.enabled and cfg.data.augment.mixup_alpha > 0
    before = flash_cuda.FWD_LAUNCHES + flash_cuda.DQ_LAUNCHES \
        + flash_cuda.DKV_LAUNCHES
    tr = Trainer(cfg, device="cpu")
    tr.fit(tr.init_state(), SyntheticU8(4, SIZE, CLASSES), num_steps=3)
    losses = [r["loss"] for r in tr.records if r["event"] == "train"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert flash_cuda.FWD_LAUNCHES + flash_cuda.DQ_LAUNCHES \
        + flash_cuda.DKV_LAUNCHES == before


def test_engine_serves_vit_with_the_flash_layout():
    engine = build_engine("vit_s16", SIZE, CLASSES, (1, 2), 2,
                          device="cpu", compute_dtype="float32",
                          extra=_extra("flash", PATCH))
    assert engine._model.block0.attn.layout == "flash"
    engine.warmup()
    imgs = np.random.default_rng(0).integers(
        0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    probs, bucket = engine.run(imgs)
    assert bucket == 2 and probs.shape == (2, CLASSES)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)
    one, _ = engine.run(imgs[:1])
    np.testing.assert_allclose(one[0], probs[0], rtol=1e-5, atol=1e-6)

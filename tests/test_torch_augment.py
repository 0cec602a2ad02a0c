"""The port's on-device augmentation (distributed_vgg_f_tpu_torch/data/
augment.py) and dropout (models/vggf.py) against the JAX package, with
the JAX draws injected: torch and JAX draw different numbers from one
seed, so each op is fed the flip bits, permutation and lam that the JAX
op drew from its key. Flip is held bitwise; mixup within 1e-6 (rtol and
atol; both compute x*lam + x[perm]*(1-lam) in fp32, and one side may fuse
a multiply-add). Also the port's own replay contract: the same
(seed, step) gives the same batch and the same dropout mask."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu.data.augment import _hflip as jax_hflip
from distributed_vgg_f_tpu.data.augment import _mix as jax_mix
from distributed_vgg_f_tpu.data.augment import \
    make_device_augment as jax_make_augment
from distributed_vgg_f_tpu_torch.config import AugmentConfig, get_config
from distributed_vgg_f_tpu_torch.data.augment import (AUGMENT_RNG_FOLD,
                                                      draw_hflip, draw_mixup,
                                                      hflip,
                                                      make_device_augment,
                                                      mixup)
from distributed_vgg_f_tpu_torch.data.device_ingest import \
    space_to_depth_batch
from distributed_vgg_f_tpu_torch.models.vggf import VGGF
from distributed_vgg_f_tpu_torch.utils.rng import generator


def _batch(b=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, s, 3)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flip_with_jax_draws_is_bitwise(seed):
    x, _ = _batch(seed=seed)
    key = jax.random.key(seed)
    bits = np.array(jax.random.bernoulli(key, 0.5, (x.shape[0],)))
    want = np.asarray(jax_hflip(key, jnp.asarray(x)))
    got = hflip(torch.from_numpy(x), torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert bits.any() and not np.array_equal(got, x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_with_jax_draws_matches(seed):
    x, labels = _batch(seed=seed)
    key = jax.random.key(seed)
    k_perm, k_lam, _, _ = jax.random.split(key, 4)
    perm = np.array(jax.random.permutation(k_perm, x.shape[0]))
    lam = np.array(jax.random.beta(k_lam, 0.2, 0.2))
    want_x, want_labels, want_lam = jax_mix(key, jnp.asarray(x),
                                            jnp.asarray(labels), 0.2, 0.0)
    got_x, got_labels, got_lam = mixup(
        torch.from_numpy(x), torch.from_numpy(labels).long(),
        torch.from_numpy(perm).long(), torch.from_numpy(lam))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_labels.numpy(),
                                  np.asarray(want_labels))
    assert float(got_lam) == float(want_lam)


def test_draws_are_distributed_as_the_reference_asks():
    flips = draw_hflip(generator(0, 1), 4096)
    assert flips.dtype == torch.bool and 0.45 < flips.float().mean() < 0.55
    perm, lam = draw_mixup(generator(0, 2), 64, 0.2)
    assert sorted(perm.tolist()) == list(range(64))
    assert lam.dtype == torch.float32 and 0.0 <= float(lam) <= 1.0
    # Beta(0.2, 0.2) puts most mass near 0 and 1
    lams = [float(draw_mixup(generator(0, s), 2, 0.2)[1])
            for s in range(200)]
    assert np.mean([min(v, 1 - v) < 0.1 for v in lams]) > 0.5


def _flagship_aug():
    return get_config("vggf_imagenet_dp").data.augment


def test_same_seed_and_step_replays_the_augmented_batch():
    aug = make_device_augment(_flagship_aug())
    x, labels = _batch(b=16, seed=4)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels).long()
    a = aug((3, 7, AUGMENT_RNG_FOLD), xt, lt)
    b = aug((3, 7, AUGMENT_RNG_FOLD), xt, lt)
    c = aug((3, 8, AUGMENT_RNG_FOLD), xt, lt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float(a[2]) == float(b[2])
    assert not torch.equal(a[0], c[0])


def test_order_is_finish_augment_then_space_to_depth():
    aug_cfg = _flagship_aug()
    packed = make_device_augment(aug_cfg, space_to_depth=True)
    plain = make_device_augment(aug_cfg)
    x, labels = _batch(b=4, s=16, seed=5)
    key = (0, 0, AUGMENT_RNG_FOLD)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels).long()
    got = packed(key, xt, lt)[0]
    assert got.shape == (4, 4, 4, 48)
    assert torch.equal(got, space_to_depth_batch(plain(key, xt, lt)[0]))


def test_bf16_batch_stays_bf16_and_flip_only_has_no_mix():
    aug = make_device_augment(AugmentConfig(enabled=True, hflip=True))
    x, labels = _batch(b=4, seed=6)
    out, mix_labels, mix_lam = aug((1, 2, 3), torch.from_numpy(x).bfloat16(),
                                   torch.from_numpy(labels).long())
    assert out.dtype == torch.bfloat16
    assert mix_labels is None and mix_lam is None


def test_disabled_stage_is_absent_in_both_packages():
    assert make_device_augment(AugmentConfig(enabled=False)) is None
    jax_cfg = dataclasses.replace(_flagship_aug(), enabled=False)
    assert jax_make_augment(jax_cfg, (0.0,) * 3, (1.0,) * 3) is None


@pytest.mark.parametrize("field,value", [("crop_jitter", 4),
                                         ("cutmix_alpha", 1.0),
                                         ("rand_ops", 2)])
def test_unported_ops_are_refused(field, value):
    cfg = AugmentConfig(enabled=True, mixup_alpha=0.2, **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        make_device_augment(cfg)


def test_augment_refuses_raw_u8_and_packed_batches():
    aug = make_device_augment(_flagship_aug())
    labels = torch.zeros(2, dtype=torch.long)
    with pytest.raises(TypeError, match="after the device finish"):
        aug((0, 0), torch.zeros(2, 8, 8, 3, dtype=torch.uint8), labels)
    with pytest.raises(ValueError, match=r"\(B, S, S, 3\)"):
        aug((0, 0), torch.zeros(2, 2, 2, 48), labels)


# ----------------------------------------------------------------- dropout
def _vggf(p=0.5):
    return VGGF(10, compute_dtype=torch.float32, image_size=32,
                stem_features=8, conv_features=16, fc_features=32,
                dropout_rate=p)


@pytest.mark.parametrize("p", [0.5, 0.2])
def test_dropout_keep_rate_and_scaling(p):
    x = torch.ones(512, 256)
    y = _vggf(p)._dropout(x, generator(0, 1))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - p)))


def test_dropout_mask_replays_from_seed_and_is_off_in_eval():
    model = _vggf()
    for prm in model.parameters():
        torch.nn.init.normal_(prm, std=0.3, generator=generator(5, 0))
    x = torch.from_numpy(_batch(b=4, s=32, seed=7)[0])
    with torch.no_grad():
        a = model(x, train=True, generator=generator(1, 2))
        b = model(x, train=True, generator=generator(1, 2))
        c = model(x, train=True, generator=generator(1, 3))
        e1, e2 = model(x), model(x, train=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(e1, e2) and not torch.equal(a, e1)
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)

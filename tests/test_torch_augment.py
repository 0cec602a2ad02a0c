"""The port's on-device augmentation (distributed_vgg_f_tpu_torch/data/
augment.py) and dropout (models/vggf.py) against the JAX package, with
the JAX draws injected: torch and JAX draw different numbers from one
seed, so each op is fed the draws the JAX op made from its key
(tests/_torch_jax_draws.py). Also the port's own replay contract: the
same (seed, step) gives the same batch and the same dropout mask, and a
resumed run redraws the uninterrupted run's augmentations.

Tolerances:
- flip, crop jitter and cutmix (the box, the pasted pixels, lam and
  labels[perm]): bitwise. The choice between cutmix and mixup: the same
  branch and lam.
- mixup: 1e-6 (rtol and atol; both compute x*lam + x[perm]*(1-lam) in
  fp32, and one side may fuse a multiply-add).
- RandAugment-lite against JAX's op-by-op (eager) function: atol 2e-6 on
  the normalised values (a few ulps at |x| <= 2.7: contrast's mean is a
  reduction another library may sum in another order). Against JAX's
  jitted function (the form its train step runs), XLA contracts
  `x * std + mean` and `(p - pivot) * factor + pivot` into fused
  multiply-adds for some elements, so p can land one ulp off an integer
  pixel value where the port's separate ops land on it, and posterize's
  floor then moves that pixel by one quantisation step (2^k levels). Each
  such flip is held to exactly one step at a posterized element, and
  their count to `_FLIP_SHARE` of the posterized elements (measured over
  6 seeds at 32 images of 8 px: 1.9-6.5% in one round in fp32, none in
  bf16); every other element within atol 2e-6. Over two rounds a flip
  in the first moves the image's contrast pivot in the second, so all of
  that image's channel moves by a fraction of a level: there the
  elements apart are held to images that drew posterize, to at most one
  largest step (8 levels) stretched by the largest contrast factor, and
  to `_TWO_ROUND_SHARE` of those images'
  elements (measured: 5.3-23.6% in fp32, 0.2-1.2% in bf16)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_draws import (jax_augment_draws, jax_flip, jax_jitter,
                              jax_mix, jax_rand)
from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu.data.augment import _crop_jitter as jax_jitter_op
from distributed_vgg_f_tpu.data.augment import _hflip as jax_hflip
from distributed_vgg_f_tpu.data.augment import _mix as jax_mix_op
from distributed_vgg_f_tpu.data.augment import _rand_ops as jax_rand_op
from distributed_vgg_f_tpu.data.augment import \
    make_device_augment as jax_make_augment
from distributed_vgg_f_tpu.data.device_ingest import \
    make_device_finish as jax_make_finish
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.config import AugmentConfig, get_config
from distributed_vgg_f_tpu_torch.data import augment as paug
from distributed_vgg_f_tpu_torch.data.augment import (AUGMENT_RNG_FOLD,
                                                      cutmix, cutmix_box,
                                                      draw_crop_jitter,
                                                      draw_hflip, draw_mix,
                                                      draw_rand_ops,
                                                      crop_jitter, hflip,
                                                      make_device_augment,
                                                      mix, mixup, rand_ops)
from distributed_vgg_f_tpu_torch.data.device_ingest import (
    make_device_finish, space_to_depth_batch)
from distributed_vgg_f_tpu_torch.models.vggf import VGGF
from distributed_vgg_f_tpu_torch.telemetry.schema import \
    validate_augment_block
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.utils.rng import generator

MEAN = tcfg.DataConfig().mean_rgb
STD = tcfg.DataConfig().stddev_rgb
_P_MEAN = torch.tensor(MEAN, dtype=torch.float32)
_P_INV = torch.tensor(1.0) / torch.tensor(STD, dtype=torch.float32)
_J_MEAN = jnp.asarray(MEAN, jnp.float32)
_J_INV = jnp.float32(1.0) / jnp.asarray(STD, jnp.float32)

#: Largest share of posterized elements a compiler's fused multiply-add
#: may move by one quantisation step (module docstring)
_FLIP_SHARE = 0.08
#: The same over two rounds, where a flip spreads through the contrast
#: pivot (module docstring)
_TWO_ROUND_SHARE = 0.30
#: Every other element of RandAugment's output, normalised units
_RAND_ATOL = 2e-6

#: All of JAX's ops on, at 16 px
ALL_ON = AugmentConfig(enabled=True, hflip=True, crop_jitter=2,
                       mixup_alpha=0.2, cutmix_alpha=1.0, rand_ops=2,
                       rand_magnitude=0.5)


def _batch(b=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, s, 3)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int32))


def _finished(b, s, seed, dtype):
    """Seeded u8 pixels through both finishes (bitwise equal), as fp32."""
    px = np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                              dtype=np.uint8)
    x = make_device_finish(MEAN, STD, image_dtype=dtype)(
        torch.from_numpy(px)).float()
    want = np.asarray(jax_make_finish(MEAN, STD, image_dtype=dtype)(
        jnp.asarray(px)).astype(jnp.float32))
    assert np.array_equal(x.numpy(), want)
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flip_with_jax_draws_is_bitwise(seed):
    x, _ = _batch(seed=seed)
    key = jax.random.key(seed)
    bits = jax_flip(key, x.shape[0])
    want = np.asarray(jax_hflip(key, jnp.asarray(x)))
    got = hflip(torch.from_numpy(x), bits).numpy()
    np.testing.assert_array_equal(got, want)
    assert bits.any() and not np.array_equal(got, x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_with_jax_draws_matches(seed):
    x, labels = _batch(seed=seed)
    key = jax.random.key(seed)
    d = jax_mix(key, x.shape[0], 16, 16, 0.2, 0.0)
    want_x, want_labels, want_lam = jax_mix_op(key, jnp.asarray(x),
                                               jnp.asarray(labels), 0.2,
                                               0.0)
    got_x, got_labels, got_lam = mixup(
        torch.from_numpy(x), torch.from_numpy(labels).long(), d.perm, d.lam)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_labels.numpy(),
                                  np.asarray(want_labels))
    assert float(got_lam) == float(want_lam)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_px", [1, 4])
def test_crop_jitter_with_jax_draws_is_bitwise(seed, max_px):
    x, _ = _batch(seed=seed)
    key = jax.random.key(seed)
    dy, dx = jax_jitter(key, x.shape[0], max_px)
    want = np.asarray(jax_jitter_op(key, jnp.asarray(x), max_px))
    got = crop_jitter(torch.from_numpy(x), dy, dx).numpy()
    np.testing.assert_array_equal(got, want)
    assert (dy != 0).any() and not np.array_equal(got, x)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_cutmix_with_jax_draws_is_bitwise(seed, alpha):
    x, labels = _batch(seed=seed)
    key = jax.random.key(seed)
    d = jax_mix(key, x.shape[0], 16, 16, 0.0, alpha)
    assert d.use_cut
    want_x, want_labels, want_lam = jax_mix_op(key, jnp.asarray(x),
                                               jnp.asarray(labels), 0.0,
                                               alpha)
    got_x, got_labels, got_lam = mix(
        torch.from_numpy(x), torch.from_numpy(labels).long(), d)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_labels.numpy(),
                                  np.asarray(want_labels))
    assert got_lam.dtype == torch.float32
    assert float(got_lam) == float(want_lam)


#: Seeds whose coins fall both ways (test_the_seeds_above_take_both_branches)
_CHOICE_SEEDS = range(0, 24, 3)


@pytest.mark.parametrize("seed", _CHOICE_SEEDS)
def test_cutmix_or_mixup_choice_with_jax_draws(seed):
    """Both alphas on: one coin a step picks the op; lam is the chosen
    op's (cutmix's re-derived from its box)."""
    x, labels = _batch(seed=seed)
    key = jax.random.key(seed)
    d = jax_mix(key, x.shape[0], 16, 16, 0.2, 1.0)
    want_x, want_labels, want_lam = jax_mix_op(
        key, jnp.asarray(x), jnp.asarray(labels), 0.2, 1.0)
    got_x, got_labels, got_lam = mix(
        torch.from_numpy(x), torch.from_numpy(labels).long(), d)
    if d.use_cut:
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    else:
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_labels.numpy(),
                                  np.asarray(want_labels))
    assert float(got_lam) == float(want_lam)


def test_the_seeds_above_take_both_branches():
    picks = {jax_mix(jax.random.key(s), 8, 16, 16, 0.2, 1.0).use_cut
             for s in _CHOICE_SEEDS}
    assert picks == {True, False}


def test_cutmix_lam_comes_from_the_clipped_box():
    """A box centred in a corner is clipped to a quarter of its drawn
    size: lam counts the pixels pasted, not the drawn lam0."""
    x, labels = _batch(b=4, seed=9)
    xt = torch.from_numpy(x)
    perm = torch.tensor([1, 2, 3, 0])
    lam0 = torch.tensor(0.5)
    assert cutmix_box(lam0, 16, 16, 0, 0) == (0, 6, 0, 6)  # 11 x 11 drawn
    out, mixed, lam = cutmix(xt, torch.from_numpy(labels).long(), perm,
                             lam0, 0, 0)
    assert float(lam) == 1.0 - 36.0 / 256.0
    assert torch.equal(out[:, :6, :6], xt[perm, :6, :6])
    assert torch.equal(out[:, 6:], xt[:, 6:])
    assert torch.equal(out[:, :, 6:], xt[:, :, 6:])
    assert mixed.tolist() == labels[perm.numpy()].tolist()


# -------------------------------------------------------- RandAugment-lite
@functools.lru_cache(maxsize=None)
def _jax_rand_jitted(n_ops, magnitude):
    return jax.jit(lambda k, v: jax_rand_op(k, v, _J_MEAN, _J_INV, n_ops,
                                            magnitude))


def _rand_pair(x, op, u, n_ops, magnitude, key):
    """The port's output and JAX's, op by op and jitted, on one batch."""
    got = rand_ops(x, op, u, _P_MEAN, _P_INV, magnitude).numpy()
    xj = jnp.asarray(x.numpy())
    eager = np.asarray(jax_rand_op(key, xj, _J_MEAN, _J_INV, n_ops,
                                   magnitude))
    jitted = np.asarray(_jax_rand_jitted(n_ops, magnitude)(key, xj))
    return got, eager, jitted


def _flips(got, want, posterized, step):
    """Elements further apart than _RAND_ATOL: each must sit at a
    posterized element, one quantisation step apart (`step` in
    normalised units, per element); returns their count."""
    far = np.abs(got - want) > _RAND_ATOL
    assert not (far & ~posterized).any(), "a flip outside posterize"
    if step is not None:
        np.testing.assert_allclose(np.abs(got - want)[far], step[far],
                                   rtol=1e-5)
    return int(far.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("magnitude", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("op_name", ["identity", "brightness", "contrast",
                                     "posterize"])
def test_rand_ops_per_op_with_jax_draws(op_name, magnitude, dtype):
    """One round: the images that drew `op_name` against JAX's."""
    k = paug.RAND_OPS.index(op_name)
    x = _finished(32, 8, 11, dtype)
    key = jax.random.key(3)
    op, u = jax_rand(key, 32, 1)
    sel = (op[0] == k).numpy()
    assert sel.sum() >= 4
    got, eager, jitted = _rand_pair(x, op, u, 1, magnitude, key)
    np.testing.assert_allclose(got[sel], eager[sel], rtol=0,
                               atol=_RAND_ATOL)
    # the posterize step of each image, in normalised units a channel
    shift = np.round(np.abs(u[0].numpy()) * np.float32(magnitude)
                     * np.float32(3.0))
    step = (np.exp2(shift)[:, None, None, None]
            * _P_INV.numpy()[None, None, None, :]) * np.ones_like(got)
    posterized = np.broadcast_to((op[0] == 3).numpy()[:, None, None, None],
                                 got.shape)
    n = _flips(got[sel], jitted[sel], posterized[sel], step[sel])
    assert n <= _FLIP_SHARE * posterized[sel].sum() + 1e-9, n
    if op_name != "posterize":
        assert n == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("magnitude", [0.0, 0.5, 1.0])
def test_rand_ops_two_rounds_with_jax_draws(magnitude, dtype):
    x = _finished(32, 8, 12, dtype)
    key = jax.random.key(5)
    op, u = jax_rand(key, 32, 2)
    got, eager, jitted = _rand_pair(x, op, u, 2, magnitude, key)
    np.testing.assert_allclose(got, eager, rtol=0, atol=_RAND_ATOL)
    posterized = np.broadcast_to(
        (op == 3).any(0).numpy()[:, None, None, None], got.shape)
    n = _flips(got, jitted, posterized, None)
    assert n <= _TWO_ROUND_SHARE * posterized.sum(), n
    # one largest step, stretched by the largest contrast factor
    assert np.abs(got - jitted).max() <= (
        8.0 * (1.0 + 0.8 * magnitude) * float(_P_INV.max()) * 1.001)
    p = got * STD_NP + MEAN_NP
    assert p.min() >= -1e-3 and p.max() <= 255.001


STD_NP = np.asarray(STD, np.float32)
MEAN_NP = np.asarray(MEAN, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_stage_with_jax_draws_packed(dtype, monkeypatch):
    """Every op on, packed after augmenting, the port's stage fed JAX's
    draws against JAX's jitted stage on the same key: equal labels[perm]
    and lam; the elements further apart than an ulp of the batch's dtype
    are the two-round posterize flips above, counted and bounded."""
    monkeypatch.setattr(paug, "draw_augment", jax_augment_draws)
    x = _finished(16, 16, 13, dtype).to(getattr(torch, dtype))
    labels = np.arange(16, dtype=np.int32)
    key = jax.random.key(21)
    got, got_labels, got_lam = make_device_augment(
        ALL_ON, MEAN, STD, space_to_depth=True)(
        key, x, torch.from_numpy(labels).long())
    jax_aug = jax_make_augment(dataclasses.replace(
        jcfg.AugmentConfig(), **dataclasses.asdict(ALL_ON)), MEAN, STD,
        space_to_depth=True)
    want, want_labels, want_lam = jax.jit(jax_aug)(
        key, jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)),
        jnp.asarray(labels))
    assert got.shape == (16, 4, 4, 48) and got.dtype == x.dtype
    np.testing.assert_array_equal(got_labels.numpy(),
                                  np.asarray(want_labels))
    assert abs(float(got_lam) - float(want_lam)) <= 1e-7
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    # one ulp of the output dtype at |x| <= 2.7 besides
    ulp = 2e-6 if dtype == "float32" else 2.0 ** -6
    far = np.abs(g - w) > ulp
    d = jax_augment_draws(ALL_ON, key, 16, 16, 16)
    assert d.rand is not None and (d.rand[0] == 3).any()
    # two rounds' flips, spread by contrast and by the mix (measured over
    # keys 21-24: 7.2-23.5% of the elements in fp32, at most 0.2% in bf16)
    assert far.sum() <= _TWO_ROUND_SHARE * g.size, far.sum()
    assert np.abs(g - w).max() <= 8.0 * 1.4 * float(_P_INV.max()) + ulp


# ------------------------------------------------------------------- draws
def test_draws_are_distributed_as_the_reference_asks():
    flips = draw_hflip(generator(0, 1), 4096)
    assert flips.dtype == torch.bool and 0.45 < flips.float().mean() < 0.55
    d = draw_mix(generator(0, 2), 64, 16, 16, 0.2, 0.0)
    assert sorted(d.perm.tolist()) == list(range(64)) and not d.use_cut
    assert d.lam.dtype == torch.float32 and 0.0 <= float(d.lam) <= 1.0
    # Beta(0.2, 0.2) puts most mass near 0 and 1
    lams = [float(draw_mix(generator(0, s), 2, 16, 16, 0.2, 0.0).lam)
            for s in range(200)]
    assert np.mean([min(v, 1 - v) < 0.1 for v in lams]) > 0.5
    # jitter: uniform over [-3, 3]
    dy, dx = draw_crop_jitter(generator(0, 3), 7000, 3)
    for v in (dy, dx):
        counts = np.bincount(v.numpy() + 3, minlength=7)
        assert len(counts) == 7 and v.min() == -3 and v.max() == 3
        assert np.all(np.abs(counts / 7000 - 1 / 7) < 0.02), counts
    # RandAugment: ops uniform over the 4, u uniform over [-1, 1)
    op, u = draw_rand_ops(generator(0, 4), 4000, 2)
    assert op.shape == u.shape == (2, 4000) and u.dtype == torch.float32
    assert np.all(np.abs(np.bincount(op.numpy().ravel(), minlength=4)
                         / 8000 - 0.25) < 0.02)
    assert -1.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean())) < 0.03
    # cutmix (Beta(1, 1)): the box's area fraction is 1 - lam0, the
    # centre uniform over the image; the choice is a fair coin
    draws = [draw_mix(generator(0, 5, s), 4, 64, 64, 0.0, 1.0)
             for s in range(400)]
    lam0 = np.array([float(d.lam) for d in draws])
    assert all(d.use_cut for d in draws)
    assert abs(lam0.mean() - 0.5) < 0.05
    for d in draws[:50]:
        ratio = np.sqrt(np.float32(1.0) - np.float32(d.lam))
        side = int(np.round(ratio * 64))
        assert abs(side * side / 4096 - (1 - float(d.lam))) < 2 * 64 / 4096
    cys = np.array([d.cy for d in draws])
    assert cys.min() >= 0 and cys.max() <= 63 and abs(cys.mean() - 31.5) < 4
    picks = [draw_mix(generator(0, 6, s), 4, 16, 16, 0.2, 1.0).use_cut
             for s in range(400)]
    assert 0.43 < np.mean(picks) < 0.57


# ----------------------------------------------------------------- replay
def _flagship_aug():
    return get_config("vggf_imagenet_dp").data.augment


def test_same_seed_and_step_replays_the_augmented_batch():
    aug = make_device_augment(ALL_ON, MEAN, STD)
    x, labels = _batch(b=16, seed=4)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels).long()
    a = aug((3, 7, AUGMENT_RNG_FOLD), xt, lt)
    b = aug((3, 7, AUGMENT_RNG_FOLD), xt, lt)
    c = aug((3, 8, AUGMENT_RNG_FOLD), xt, lt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float(a[2]) == float(b[2])
    assert not torch.equal(a[0], c[0])


#: The flagship narrowed for the resume case: every augment op on
_RESUME = {"model.num_classes": "10", "model.compute_dtype": "float32",
           "model.dropout_rate": "0.0",
           "model.extra.stem_features": "8",
           "model.extra.conv_features": "16",
           "model.extra.fc_features": "32", "data.image_size": "32",
           "data.global_batch_size": "8", "data.augment.crop_jitter": "2",
           "data.augment.cutmix_alpha": "1.0", "data.augment.rand_ops": "2",
           "data.augment.rand_magnitude": "0.5",
           "optim.reference_batch_size": "8", "train.seed": "0",
           "train.log_every": "1"}


def test_a_resumed_step_redraws_the_uninterrupted_runs_augmentations():
    """JAX's test_mixup_pairing_deterministic_across_restart for the
    port: a fresh Trainer continuing from step 2 trains steps 3 and 4 to
    the uninterrupted run's losses, bit for bit: the draws depend only on
    (seed, step, rank)."""
    cfg = tcfg.apply_overrides(get_config("vggf_imagenet_dp"), _RESUME)
    rng = np.random.default_rng(17)
    batches = [{"image": torch.from_numpy(
        rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)),
        "label": torch.from_numpy(rng.integers(0, 10, (8,)).astype(
            np.int32))} for _ in range(4)]

    def losses(trainer):
        return [r["loss"] for r in trainer.records if r["event"] == "train"]

    whole = Trainer(cfg, device="cpu")
    whole.fit(whole.init_state(), batches, num_steps=4)
    first = Trainer(cfg, device="cpu")
    state = first.fit(first.init_state(), batches[:2], num_steps=2)
    again = Trainer(cfg, device="cpu")
    again.fit(state, batches[2:], num_steps=4)
    assert len(losses(whole)) == 4
    assert losses(first) + losses(again) == losses(whole)


def test_order_is_finish_augment_then_space_to_depth():
    packed = make_device_augment(ALL_ON, MEAN, STD, space_to_depth=True)
    plain = make_device_augment(ALL_ON, MEAN, STD)
    x, labels = _batch(b=4, s=16, seed=5)
    key = (0, 0, AUGMENT_RNG_FOLD)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels).long()
    got = packed(key, xt, lt)[0]
    assert got.shape == (4, 4, 4, 48)
    assert torch.equal(got, space_to_depth_batch(plain(key, xt, lt)[0]))


def test_bf16_batch_stays_bf16_and_flip_only_has_no_mix():
    aug = make_device_augment(AugmentConfig(enabled=True, hflip=True),
                              MEAN, STD)
    x, labels = _batch(b=4, seed=6)
    out, mix_labels, mix_lam = aug((1, 2, 3), torch.from_numpy(x).bfloat16(),
                                   torch.from_numpy(labels).long())
    assert out.dtype == torch.bfloat16
    assert mix_labels is None and mix_lam is None
    out = make_device_augment(ALL_ON, MEAN, STD)(
        (1, 2, 3), torch.from_numpy(x).bfloat16(),
        torch.from_numpy(labels).long())[0]
    assert out.dtype == torch.bfloat16


def test_disabled_stage_is_absent_in_both_packages():
    assert make_device_augment(AugmentConfig(enabled=False), MEAN,
                               STD) is None
    assert make_device_augment(None, MEAN, STD) is None
    jax_cfg = dataclasses.replace(_flagship_aug(), enabled=False)
    assert jax_make_augment(jax_cfg, (0.0,) * 3, (1.0,) * 3) is None


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("value", [-0.1, 1.5])
def test_rand_magnitude_outside_the_unit_interval_is_refused(value):
    with pytest.raises(ValueError, match="rand_magnitude"):
        AugmentConfig(enabled=True, rand_ops=2, rand_magnitude=value)
    with pytest.raises(ValueError, match="rand_magnitude"):
        jcfg.AugmentConfig(enabled=True, rand_ops=2, rand_magnitude=value)


@pytest.mark.parametrize("field,value", [("crop_jitter", -1),
                                         ("mixup_alpha", -0.2),
                                         ("cutmix_alpha", -1.0),
                                         ("rand_ops", -1)])
def test_a_negative_jitter_alpha_or_op_count_is_refused(field, value):
    with pytest.raises(ValueError, match=field.split("_")[0]):
        AugmentConfig(enabled=True, **{field: value})


def test_every_augment_key_is_taken_through_parse_cli():
    argv = ["--config", "vggf_imagenet_dp",
            "--set", "data.augment.rand_magnitude=0.3",
            "--set", "data.augment.crop_jitter=8",
            "--set", "data.augment.cutmix_alpha=1.0",
            "--set", "data.augment.rand_ops=2"]
    port = tcfg.parse_cli(argv).data.augment
    ref = jcfg.parse_cli(argv).data.augment
    assert (port.rand_magnitude, port.crop_jitter, port.cutmix_alpha,
            port.rand_ops) == (0.3, 8, 1.0, 2)
    assert port.describe() == ref.describe()
    assert make_device_augment(port, MEAN, STD) is not None
    errors = []
    validate_augment_block(port.describe(), "train", errors)
    assert errors == []
    validate_augment_block({**port.describe(), "rand_magnitude": 1.5},
                           "train", errors)
    assert errors == ["train: 'rand_magnitude' not in [0, 1]"]


def test_augment_refuses_raw_u8_and_packed_batches():
    aug = make_device_augment(_flagship_aug(), MEAN, STD)
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

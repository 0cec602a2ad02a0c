"""The port's distillation tool (distributed_vgg_f_tpu_torch/train/
distill.py) and teacher task (data/teacher.py) against the JAX
package's, on the CPU (``device="cpu"``):

- `distill_loss` and its gradient with respect to the student's logits
  within 1e-6 of JAX's, at several temperatures and alphas; alpha = 0 is
  plain cross-entropy and the KL term vanishes at equal logits;
- `Teacher` weights, logits and labels, and `_raw_images`, equal to
  JAX's (numpy on both sides: the same bits);
- `TeacherTaskDataset`'s first batches (images, labels, across the
  reshuffle) equal to JAX's;
- `teacher_eval_shard` equal;
- 3 steps of `train_distilled` on vggf_student at 32 px from JAX's own
  initial parameters (carried across by weights.py) with dropout 0: each
  loss within 1e-5 relative of JAX's, and the parameters after the 3
  steps within 1e-4 relative L2 of JAX's (the second step has the peak
  LR, the third half of it, through clipping, decay and momentum);
- the npz weights file read across both ways."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_vgg_f_tpu.data import teacher as jteacher
from distributed_vgg_f_tpu.train import distill as jdistill
from distributed_vgg_f_tpu_torch.data import teacher as tteacher
from distributed_vgg_f_tpu_torch.train import distill as tdistill


def _logits(seed, n=8, c=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, c)).astype(np.float32) * 3,
            rng.standard_normal((n, c)).astype(np.float32) * 3,
            rng.integers(0, c, n))


@pytest.mark.parametrize("temperature,alpha", [(2.0, 0.5), (1.0, 0.0),
                                               (4.0, 1.0), (8.0, 0.3)])
def test_distill_loss_and_gradient_match_jax(temperature, alpha):
    s, t, labels = _logits(int(temperature * 10 + alpha * 3))
    want, want_g = jax.value_and_grad(
        lambda x: jdistill.distill_loss(x, jnp.asarray(t),
                                        jnp.asarray(labels),
                                        temperature=temperature,
                                        alpha=alpha))(jnp.asarray(s))
    x = torch.from_numpy(s).requires_grad_(True)
    got = tdistill.distill_loss(x, torch.from_numpy(t),
                                torch.from_numpy(labels),
                                temperature=temperature, alpha=alpha)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6,
                                                abs=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)


def test_alpha_zero_is_cross_entropy_and_kl_vanishes_at_equal_logits():
    s, t, labels = _logits(5)
    ce = torch.nn.functional.cross_entropy(torch.from_numpy(s),
                                           torch.from_numpy(labels))
    got = tdistill.distill_loss(torch.from_numpy(s), torch.from_numpy(t),
                                torch.from_numpy(labels), alpha=0.0)
    assert float(got) == pytest.approx(float(ce), abs=1e-5)
    for temp in (1.0, 2.0, 8.0):
        kl = tdistill.distill_loss(torch.from_numpy(s), torch.from_numpy(s),
                                   torch.from_numpy(labels), alpha=1.0,
                                   temperature=temp)
        assert abs(float(kl)) < 1e-5


@pytest.mark.parametrize("size,classes", [(32, 10), (64, 5)])
def test_teacher_and_raw_images_equal_jax(size, classes):
    ours = tteacher.Teacher(size, classes, seed=7)
    theirs = jteacher.Teacher(size, classes, seed=7)
    for name in ("w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name))
    idx = np.arange(6) + 1000
    got = tteacher._raw_images(idx, size, base_seed=11)
    want = jteacher._raw_images(idx, size, base_seed=11)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(ours.logits(got), theirs.logits(want))
    np.testing.assert_array_equal(ours.label(got), theirs.label(want))


def test_teacher_task_dataset_batches_equal_jax():
    mean, std = tdistill._serving_norm()
    kw = dict(seed=3, num_examples=40, mean=mean, std=std)
    ours = tteacher.TeacherTaskDataset(16, 32, 10, **kw)
    theirs = jteacher.TeacherTaskDataset(16, 32, 10, **kw)
    for _ in range(4):  # 40 examples at 16: a reshuffle at the third
        a, b = next(ours), next(theirs)
        assert a["image"].dtype == b["image"].dtype == np.float32
        assert a["image"].tobytes() == b["image"].tobytes()
        np.testing.assert_array_equal(a["label"], b["label"])
    with pytest.raises(ValueError, match="float32"):
        tteacher.TeacherTaskDataset(4, 32, 10, seed=0, num_examples=8,
                                    image_dtype="bfloat16")


def test_teacher_eval_shard_equals_jax():
    got = tdistill.teacher_eval_shard(32, 10, 24)
    want = jdistill.teacher_eval_shard(32, 10, 24)
    assert tdistill.EVAL_INDEX_BASE == jdistill.EVAL_INDEX_BASE
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_warmup_cosine_is_optax():
    import optax
    for lr, warmup, steps in ((0.02, 1, 3), (0.02, 60, 1200), (0.5, 5, 7)):
        want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)
        ours = tdistill.warmup_cosine(lr, warmup, steps)
        for count in range(steps + 2):
            assert float(ours(count)) == pytest.approx(
                float(want(count)), rel=1e-6, abs=1e-9), count


def _jax_initial_params(model_name, seed, size, classes):
    """JAX train_distilled's own initial parameters (its PRNG split)."""
    from distributed_vgg_f_tpu.config import ModelConfig
    from distributed_vgg_f_tpu.models.registry import build_model
    model = build_model(ModelConfig(name=model_name, num_classes=classes,
                                    dropout_rate=0.0,
                                    compute_dtype="float32"))
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    params = model.init(init_rng, jnp.zeros((1, size, size, 3)),
                        train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_three_steps_match_jax_from_carried_params(monkeypatch):
    kw = dict(image_size=32, num_classes=10, steps=3, batch_size=8,
              num_examples=64, seed=0, log_every=1, dropout_rate=0.0)
    # JAX's history rounds each loss to 4 digits; read it unrounded
    monkeypatch.setattr(jdistill, "round", lambda x, n=None: x,
                        raising=False)
    want_params, want = jdistill.train_distilled("vggf_student", **kw)
    init = _jax_initial_params("vggf_student", 0, 32, 10)
    got_params, got = tdistill.train_distilled(
        "vggf_student", init_params=init, device="cpu", **kw)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(float(w["loss"]), rel=1e-5)
    flat_got = tdistill._flatten(got_params)
    flat_want = tdistill._flatten(jax.tree_util.tree_map(np.asarray,
                                                         want_params))
    assert sorted(flat_got) == sorted(flat_want)
    moved = 0
    for key, w in flat_want.items():
        g = flat_got[key]
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err < 1e-4, (key, err)
        moved += int(not np.array_equal(w, init[key.split("/")[0]][
            key.split("/")[1]]))
    assert moved == len(flat_want)  # every leaf took a step


def test_params_npz_reads_across_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    params = {"fc6": {"kernel": rng.standard_normal((4, 3))
                      .astype(np.float32),
                      "bias": np.zeros(3, np.float32)},
              "conv1": {"kernel": np.ones((2, 2, 1, 1), np.float32)}}
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    tdistill.save_params(ours, params)
    jdistill.save_params(theirs, params)
    for back in (jdistill.load_params(ours), tdistill.load_params(theirs),
                 tdistill.load_params(ours)):
        assert set(back) == {"fc6", "conv1"}
        for layer, leaves in params.items():
            for leaf, arr in leaves.items():
                np.testing.assert_array_equal(np.asarray(back[layer][leaf]),
                                              arr)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)

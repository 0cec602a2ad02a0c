"""The port's losses and metrics (distributed_vgg_f_tpu_torch/ops/
losses.py, ops/metrics.py) against the JAX package's on the same inputs.

Tolerance 1e-6 (rtol and atol): both sides compute in fp32; the
log-sum-exp and the sums run in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu.ops.losses import \
    l2_regularization as jax_l2
from distributed_vgg_f_tpu.ops.losses import \
    softmax_cross_entropy as jax_ce
from distributed_vgg_f_tpu.ops.metrics import topk_correct as jax_topk
from distributed_vgg_f_tpu_torch.config import ModelConfig
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.ops.losses import (is_decayable,
                                                    l2_regularization,
                                                    softmax_cross_entropy)
from distributed_vgg_f_tpu_torch.ops.metrics import topk_correct
from distributed_vgg_f_tpu_torch.weights import init_params, load_params


def _logits(b=32, c=10, seed=0, scale=4.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, c)) * scale).astype(np.float32),
            rng.integers(0, c, (b,)).astype(np.int32))


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
@pytest.mark.parametrize("c", [10, 1000])
def test_cross_entropy_matches_jax(smoothing, c):
    logits, labels = _logits(c=c, seed=c)
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                        label_smoothing=smoothing))
    got = float(softmax_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels).long(),
                                      label_smoothing=smoothing))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_cross_entropy_upcasts_bf16_logits():
    logits, labels = _logits(seed=3)
    lb = torch.from_numpy(logits).bfloat16()
    want = float(jax_ce(jnp.asarray(logits).astype(jnp.bfloat16),
                        jnp.asarray(labels)))
    got = softmax_cross_entropy(lb, torch.from_numpy(labels).long())
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_l2_matches_jax_and_skips_biases():
    cfg = ModelConfig(num_classes=10, compute_dtype="float32")
    tree = init_params(cfg, 0, image_size=32)
    for layer in tree:  # non-zero biases, so skipping them shows
        tree[layer]["bias"] = tree[layer]["bias"] + 0.5
    model = load_params(build_model(cfg, image_size=32), tree)
    for wd in (5e-4, 5e-5):
        want = float(jax_l2(jax_tree(tree), wd))
        got = float(l2_regularization(model.named_parameters(),
                                      wd).detach())
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    assert float(l2_regularization(model.named_parameters(), 0.0)) == 0.0


def jax_tree(tree):
    return {k: {leaf: jnp.asarray(v) for leaf, v in leaves.items()}
            for k, leaves in tree.items()}


def test_decayable_names():
    w2, w1 = torch.zeros(2, 2), torch.zeros(2)
    assert is_decayable("fc6.weight", w2)
    assert not is_decayable("fc6.bias", w2)
    assert not is_decayable("norm.scale", w2)
    assert not is_decayable("pos_embed", w2)
    assert not is_decayable("cls", w2)
    assert not is_decayable("fc6.weight", w1)


@pytest.mark.parametrize("k", [1, 5])
def test_topk_correct_matches_jax_with_valid_mask(k):
    logits, labels = _logits(b=64, c=20, seed=k)
    valid = np.random.default_rng(9).random(64) < 0.7
    for v in (None, valid):
        want = int(jax_topk(jnp.asarray(logits), jnp.asarray(labels), k,
                            None if v is None else jnp.asarray(v)))
        got = int(topk_correct(torch.from_numpy(logits),
                               torch.from_numpy(labels).long(), k,
                               None if v is None else torch.from_numpy(v)))
        assert got == want

"""The checkpoint's momentum layouts (distributed_vgg_f_tpu_torch/parallel/
zero.py `convert_opt_state`, checkpoint/retopology.py) against the JAX
package's and across process groups.

`convert_opt_state` against JAX `parallel/zero.py convert_opt_state` on
the same numpy momentum of narrow VGG-F (stem 8, convs 16, FC 32, 10
classes, 32 px; -0.0 among the values): per-parameter tree <-> canonical
flat <-> bucket-major flat, from N to M shards for N, M in {1, 2, 4}, bit
for bit. Then ZeRO-2 checkpoints through `Trainer` in gloo groups
(tests/_torch_dp_worker.py): saved at 2 ranks and restored at 2, each
rank's params and (S,) momentum shard bit-equal; restored at 1 process
(2 -> 1) and a 1-process checkpoint restored at 2 ranks (1 -> 2) through
the migration, bit-equal."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dp_worker import checkpoint_config, run_group
from distributed_vgg_f_tpu.models.vggf import VGGF as JaxVGGF
from distributed_vgg_f_tpu.parallel import buckets as jbuckets
from distributed_vgg_f_tpu.parallel import zero as jzero
from distributed_vgg_f_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_vgg_f_tpu_torch.models.vggf import VGGF
from distributed_vgg_f_tpu_torch.parallel import zero
from distributed_vgg_f_tpu_torch.train.trainer import Trainer
from distributed_vgg_f_tpu_torch.weights import (params_from_flax,
                                                 params_to_flax)

WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
SIZE, CLASSES, BATCH, LR, WD = 32, 10, 16, 0.05, 1e-4
BUCKET_MB = 0.0005
SPEC = {"widths": WIDTHS, "size": SIZE, "classes": CLASSES, "batch": BATCH,
        "lr": LR, "weight_decay": WD}


# ------------------------------------------------- the layouts against JAX
@pytest.fixture(scope="module")
def momentum():
    model = JaxVGGF(num_classes=CLASSES, dropout_rate=0.0, **WIDTHS)
    shapes = jax.eval_shape(
        lambda r: model.init(r, jnp.zeros((1, SIZE, SIZE, 3)))["params"],
        jax.random.key(0))
    rng = np.random.default_rng(0)

    def leaf(s):
        a = rng.standard_normal(s.shape).astype(np.float32)
        a.reshape(-1)[::7] = -0.0
        return a

    tree = jax.tree.map(leaf, shapes)
    with torch.device("meta"):
        port_model = VGGF(CLASSES, compute_dtype=torch.float32,
                          image_size=SIZE, **WIDTHS)
    return shapes, tree, port_model


def _layouts(shapes, port_model, n, kind):
    """(JAX layout or None, port layout or None, padded length) of one
    target or source frame."""
    total = jzero.flat_param_count(shapes)
    if kind == "tree":
        return None, None, None
    if kind == "canonical":
        return None, None, jzero.padded_flat_size(total, n)
    jlay = jbuckets.build_bucket_layout(
        shapes, n, int(round(BUCKET_MB * 1024 * 1024)))
    return jlay, zero.zero_layout(port_model, n, BUCKET_MB), \
        jlay.total_padded


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("n,m", [(n, m) for n in (1, 2, 4)
                                 for m in (1, 2, 4)])
def test_convert_opt_state_equals_jax(momentum, n, m):
    shapes, tree, port_model = momentum
    tx = optax.sgd(0.1, momentum=0.9)
    total = jzero.flat_param_count(shapes)
    for src in ("tree", "canonical", "bucketed"):
        jsrc, psrc, padded_src = _layouts(shapes, port_model, n, src)
        if src == "tree":
            vec = tree
        elif src == "canonical":
            vec = np.asarray(jzero.flatten_params(tree, padded_src))
        else:
            vec = np.asarray(jsrc.to_global(tree))
        state = tx.init(jax.tree.map(jnp.asarray, vec))
        state = (state[0]._replace(trace=jax.tree.map(jnp.asarray, vec)),
                 *state[1:])
        port_src = (params_from_flax(tree) if src == "tree"
                    else torch.from_numpy(np.array(vec)))
        for dst in ("tree", "canonical", "bucketed"):
            jdst, pdst, padded = _layouts(shapes, port_model, m, dst)
            want = jzero.convert_opt_state(
                state, tx, shapes, padded, src_bucket_layout=jsrc,
                target_bucket_layout=jdst)[0].trace
            got = zero.convert_opt_state(
                port_src, port_model, padded, src_bucket_layout=psrc,
                target_bucket_layout=pdst)
            what = f"{src}({n}) -> {dst}({m})"
            if dst == "tree":
                got = params_to_flax(got)
                for layer in want:
                    for name in want[layer]:
                        np.testing.assert_array_equal(
                            _bits(got[layer][name]),
                            _bits(want[layer][name]), err_msg=what)
            else:
                assert got.shape == (padded,), what
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=what)
                if dst == "canonical":
                    assert not np.any(_bits(got[total:])), what


def test_opt_state_layout_reads_shapes(momentum):
    _, tree, port_model = momentum
    total = zero.flat_param_count(port_model)
    assert zero.params_layout(params_from_flax(tree), total) == (
        "tree", None)
    assert zero.params_layout(torch.zeros(total + 2), total) == (
        "flat", total + 2)
    with pytest.raises(ValueError, match="target_padded"):
        zero.convert_opt_state(params_from_flax(tree), port_model, 10,
                               target_bucket_layout=zero.zero_layout(
                                   port_model, 2, BUCKET_MB))


# ------------------------------------------------ ZeRO-2 across groups
def _batches(n):
    rng = np.random.default_rng(1)
    return [{"image": rng.standard_normal(
                 (BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """A 1-process run and a 2-rank ZeRO-2 run of 2 steps each, both with
    checkpoints; the 2 ranks restore their own and the 1-process one; one
    process restores the 2-rank one."""
    tmp = tmp_path_factory.mktemp("ckpt_zero")
    batches = _batches(2)
    one, two = str(tmp / "one"), str(tmp / "two")
    case = dict(name="save", checkpoint=two, steps=2, bucket_mb=BUCKET_MB,
                every=2, reload=True)
    solo = Trainer(checkpoint_config(SPEC, dict(case, checkpoint=one)),
                   device="cpu")
    solo_state = solo.fit(None, batches, num_steps=2)
    arrays = {}
    for i, b in enumerate(batches):
        arrays[f"batch{i}/image"] = b["image"]
        arrays[f"batch{i}/label"] = b["label"]
    ranks = run_group(2, dict(SPEC, cases=[
        case, dict(case, name="grow", checkpoint=one, restore_only=True,
                   reload=False)]), arrays, str(tmp / "group"))
    shrink = Trainer(checkpoint_config(SPEC, case), device="cpu")
    yield solo_state, ranks, shrink, shrink.restore_or_init(), two
    shutil.rmtree(tmp, ignore_errors=True)


def _params(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _assert_bits(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=f"{what}: {k}")


def test_zero2_saved_at_two_ranks_restores_at_two_bit_equal(groups):
    _, ranks, _, _, two = groups
    for r, out in enumerate(ranks):
        assert int(out["save/reload/restored_step"]) == 2
        assert int(out["save/reload/step"]) == int(out["save/step"]) == 2
        assert int(out["save/reload/opt_count"]) == int(
            out["save/opt_count"]) == 2
        _assert_bits(_params(out, "save/reload/params/"),
                     _params(out, "save/params/"), f"rank {r} params")
        np.testing.assert_array_equal(_bits(out["save/reload/shard"]),
                                      _bits(out["save/shard"]))
    mgr = CheckpointManager(two)
    assert mgr.all_steps() == [1, 2] and mgr.verify_step(2)
    extra = mgr.extra_at(2)
    assert extra["opt_layout"]["num_shards"] == 2
    assert extra["examples_seen"] == 2 * BATCH
    assert mgr.state_metadata(2)["opt/trace"].shape == (
        extra["opt_layout"]["total_padded"],)


def test_zero2_checkpoint_restores_on_one_process(groups):
    _, ranks, shrink, state, _ = groups
    assert state.param_shard is None and state.step == 2
    assert [r["step"] for r in shrink.records if r["event"] == "restore"] \
        == [2]
    _assert_bits({k: v.numpy() for k, v in state.model.state_dict().items()},
                 _params(ranks[0], "save/params/"), "params")
    lay = zero.zero_layout(state.model, 2, BUCKET_MB)
    want = lay.from_global(torch.from_numpy(ranks[0]["save/momentum"]))
    _assert_bits({k: v.numpy() for k, v in state.momentum().items()},
                 {k: v.numpy() for k, v in want.items()}, "momentum")


def test_one_process_checkpoint_restores_on_two_ranks(groups):
    solo_state, ranks, _, _, _ = groups
    lay = zero.zero_layout(solo_state.model, 2, BUCKET_MB)
    vec = lay.to_global(lay.leaves(solo_state.momentum()))
    rows = vec.view(2, -1).numpy()
    for r, out in enumerate(ranks):
        assert int(out["grow/restored_step"]) == 2
        _assert_bits(_params(out, "grow/params/"),
                     {k: v.numpy() for k, v in
                      solo_state.model.state_dict().items()}, "params")
        np.testing.assert_array_equal(_bits(out["grow/shard"]),
                                      _bits(rows[r]))

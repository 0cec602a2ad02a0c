"""The port's gradient exchange (distributed_vgg_f_tpu_torch/train/step.py,
parallel/buckets.py, parallel/zero.py) in 2- and 4-process gloo groups,
against the port's one-process replicated step (itself held against JAX
by tests/test_torch_train_step.py).

One group of each size runs every case in one launch
(tests/_torch_dp_worker.py): narrow VGG-F (stem 8, convs 16, FC 32, 10
classes, 32 px), fp32, dropout and augment off, 3 steps at global batch
16 — dp (one all-reduce per leaf), dp with buckets at two sizes, zero1,
zero1 bucketed, zero2 flat and bucketed at two sizes; at accum 2 dp,
zero1 (full-tree accumulator, and the sharded one of grad_accum_shard),
zero2 and zero2 bucketed; the bf16 wire for dp and zero2 bucketed.

Tolerances, measured on the CPU with torch 2.13:
- accum 1, fp32: losses EQUAL across every case (the exchange permutes
  flat layouts, never the elementwise math; gloo's reduce-scatter sums
  as its all-reduce does), params within atol 1e-6 + rtol 1e-5 (two
  all-reduce sizes may sum four ranks in another order: 1 ulp seen);
  grad norms rtol 1e-5 (the sharded norm sums in another order);
- dp against the one-process step: losses rtol 2e-6 (measured 1.04e-7),
  params atol 1e-6 + rtol 1e-5;
- accum 2 against dp: losses rtol 2e-5 (measured 1.03e-7);
- the bf16 wire against dp: losses rtol 1e-5 (measured 1.03e-6), params
  atol 5e-4 (measured 1.3e-4), grad norms rtol 1e-2 (measured 3.0e-3).
The 2-process group also runs the issue-order, non-finite-skip and
per-rank-draw cases."""

import json

import numpy as np
import pytest
import torch

from _torch_dp_worker import make_config, make_model, run_group
from distributed_vgg_f_tpu_torch.models.vggf import VGGF
from distributed_vgg_f_tpu_torch.parallel.buckets import (
    build_bucket_layout, exchange_wire_bytes)
from distributed_vgg_f_tpu_torch.parallel.zero import zero_layout
from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
from distributed_vgg_f_tpu_torch.train.state import TrainState
from distributed_vgg_f_tpu_torch.train.step import build_train_step
from distributed_vgg_f_tpu_torch.weights import params_to_flax

WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
SPEC = {"widths": WIDTHS, "size": 32, "classes": 10, "batch": 16,
        "lr": 0.05, "weight_decay": 1e-4}
SMALL, BIG = 0.0005, 0.004      # MB: two bucket geometries
STEPS = 3
GRID = {
    "dp": {},
    "dp_bucket_small": dict(bucket_mb=SMALL),
    "dp_bucket_big": dict(bucket_mb=BIG),
    "zero1": dict(zero1=True),
    "zero1_bucket": dict(zero1=True, bucket_mb=SMALL),
    "zero2": dict(zero1=True, zero2=True),
    "zero2_bucket_small": dict(zero1=True, zero2=True, bucket_mb=SMALL),
    "zero2_bucket_big": dict(zero1=True, zero2=True, bucket_mb=BIG),
}
ACCUM = {
    "dp_accum2": dict(accum=2),
    "zero1_accum2": dict(zero1=True, accum=2),
    "zero1_accum2_shard": dict(zero1=True, accum=2, accum_shard=True),
    "zero2_accum2": dict(zero1=True, zero2=True, accum=2),
    "zero2_bucket_accum2": dict(zero1=True, zero2=True, bucket_mb=SMALL,
                                accum=2),
}
BF16 = {
    "dp_bucket_bf16": dict(bucket_mb=SMALL, reduce_dtype="bfloat16"),
    "zero2_bucket_bf16": dict(zero1=True, zero2=True, bucket_mb=SMALL,
                              reduce_dtype="bfloat16"),
}
# the 2-process group's extra cases
EXTRA = [
    dict(name="issue_order", zero1=True, zero2=True, bucket_mb=SMALL,
         steps=1, events=True),
    dict(name="nonfinite", zero1=True, zero2=True, bucket_mb=SMALL,
         steps=3, skip_nonfinite=True, nan=[1, 1]),
    dict(name="masks", steps=1, dropout=0.5, masks=True, seed=3),
    dict(name="masks_replay", steps=1, dropout=0.5, masks=True, seed=3),
]


def _params():
    """Seeded narrow VGG-F params (a Flax tree)."""
    model = VGGF(SPEC["classes"], compute_dtype=torch.float32,
                 image_size=SPEC["size"], dropout_rate=0.0, **WIDTHS)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return params_to_flax(model.state_dict())


def _arrays(tree):
    rng = np.random.default_rng(0)
    out = {f"params/{layer}/{leaf}": v for layer, leaves in tree.items()
           for leaf, v in leaves.items()}
    for i in range(STEPS):
        out[f"batch{i}/image"] = rng.standard_normal(
            (SPEC["batch"], SPEC["size"], SPEC["size"], 3)).astype(np.float32)
        out[f"batch{i}/label"] = rng.integers(
            0, SPEC["classes"], SPEC["batch"]).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (every rank's outputs)} for 2 and 4 gloo processes, and
    the one-process reference."""
    tree = _params()
    arrays = _arrays(tree)
    out = {"tree": tree, "arrays": arrays}
    for world in (2, 4):
        cases = [dict(name=n, steps=STEPS, **kw)
                 for n, kw in {**GRID, **ACCUM, **BF16}.items()]
        if world == 2:
            cases += EXTRA
        out[world] = run_group(world, dict(SPEC, cases=cases), arrays,
                               str(tmp_path_factory.mktemp(f"dp{world}")))
    # the one-process replicated step at the global batch, and the same
    # accumulating two micro-batches
    cfg = make_config(SPEC)
    for accum in (1, 2):
        model = make_model(SPEC, tree)
        state = TrainState.create(model, build_optimizer(
            cfg, model.parameters())[0])
        step = build_train_step(lambda s: SPEC["lr"], SPEC["weight_decay"],
                                grad_accum_steps=accum, device="cpu")
        losses = []
        for i in range(STEPS):
            state, m = step(state, {"image": arrays[f"batch{i}/image"],
                                    "label": arrays[f"batch{i}/label"]}, 0)
            losses.append(float(m["loss"]))
        out["ref" if accum == 1 else "ref_accum2"] = (
            np.array(losses), model.state_dict(), state)
    return out


def _params_of(rank_out, case):
    prefix = f"{case}/params/"
    return {k[len(prefix):]: v for k, v in rank_out.items()
            if k.startswith(prefix)}


def _assert_params_close(got, want, atol=1e-6, rtol=1e-5, what=""):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_losses_equal_across_dp_zero1_zero2_bucketed_or_not(runs, world):
    r0 = runs[world][0]
    ref = r0["dp/loss"]
    for case in GRID:
        np.testing.assert_array_equal(r0[f"{case}/loss"], ref,
                                      err_msg=case)
        np.testing.assert_allclose(r0[f"{case}/grad_norm"],
                                   r0["dp/grad_norm"], rtol=1e-5,
                                   err_msg=case)
        _assert_params_close(_params_of(r0, case), _params_of(r0, "dp"),
                             what=case)
    # the params moved
    assert not np.allclose(r0["dp/params/fc8.weight"],
                           runs["tree"]["fc8"]["kernel"].T)


@pytest.mark.parametrize("world", [2, 4])
def test_group_matches_the_one_process_step(runs, world):
    r0 = runs[world][0]
    losses, params, _ = runs["ref"]
    np.testing.assert_allclose(r0["dp/loss"], losses, rtol=2e-6)
    _assert_params_close(_params_of(r0, "dp"),
                         {k: v.numpy() for k, v in params.items()})


def test_one_process_accumulation_matches_the_whole_batch(runs):
    losses, params, _ = runs["ref"]
    acc_losses, acc_params, state = runs["ref_accum2"]
    np.testing.assert_allclose(acc_losses, losses, rtol=2e-5)
    _assert_params_close({k: v.numpy() for k, v in acc_params.items()},
                         {k: v.numpy() for k, v in params.items()})
    assert state.opt_count == STEPS


@pytest.mark.parametrize("world", [2, 4])
def test_every_replica_holds_the_same_params(runs, world):
    for case in GRID:
        want = _params_of(runs[world][0], case)
        for r in range(1, world):
            got = _params_of(runs[world][r], case)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{case} rank {r} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_grad_accumulation_within_tolerance(runs, world):
    r0 = runs[world][0]
    for case in ACCUM:
        np.testing.assert_allclose(r0[f"{case}/loss"], r0["dp/loss"],
                                   rtol=2e-5, err_msg=case)
        np.testing.assert_allclose(r0[f"{case}/grad_norm"],
                                   r0["dp/grad_norm"], rtol=1e-5,
                                   err_msg=case)
        _assert_params_close(_params_of(r0, case), _params_of(r0, "dp"),
                             what=case)
        meta = json.loads(str(r0[f"{case}/comm_meta"]))
        assert meta["grad_accum_steps"] == 2
        kw = ACCUM[case]
        if kw.get("zero2") or kw.get("accum_shard"):
            # each micro-gradient is scattered: 2 scatter legs a step
            assert meta["scatter_bytes"] == 2 * meta["gather_bytes"]
        elif kw.get("zero1"):
            assert meta["scatter_bytes"] == meta["gather_bytes"]
        else:
            assert meta["gathers"] == 0 and meta["allreduce_bytes"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_wire_within_measured_tolerance(runs, world):
    r0 = runs[world][0]
    for case in BF16:
        np.testing.assert_allclose(r0[f"{case}/loss"], r0["dp/loss"],
                                   rtol=1e-5, err_msg=case)
        np.testing.assert_allclose(r0[f"{case}/grad_norm"],
                                   r0["dp/grad_norm"], rtol=1e-2,
                                   err_msg=case)
        _assert_params_close(_params_of(r0, case), _params_of(r0, "dp"),
                             atol=5e-4, rtol=0, what=case)
        # the wire narrowed: not the fp32 run's bits
        assert not np.array_equal(r0[f"{case}/grad_norm"],
                                  r0["dp/grad_norm"])


@pytest.mark.parametrize("world", [2, 4])
def test_zero_momentum_is_the_dp_momentum_laid_out(runs, world):
    """The (T,) flat momentum of a ZeRO run is the layout's `to_global`
    of the replicated run's per-leaf momentum."""
    r0 = runs[world][0]
    model = make_model(SPEC, runs["tree"])
    prefix = "dp/momentum/"
    dp = {k[len(prefix):]: torch.from_numpy(v) for k, v in r0.items()
          if k.startswith(prefix)}
    for case, kw in GRID.items():
        if not kw.get("zero1"):
            continue
        layout = zero_layout(model, world, kw.get("bucket_mb", 0.0))
        want = layout.to_global(layout.leaves(dp)).numpy()
        np.testing.assert_allclose(r0[f"{case}/momentum"], want, atol=1e-6,
                                   rtol=1e-5, err_msg=case)
        assert r0[f"{case}/momentum"].shape == (layout.total_padded,)


@pytest.mark.parametrize("world", [2, 4])
def test_comm_meta_receipt(runs, world):
    r0 = runs[world][0]
    model = make_model(SPEC, runs["tree"])
    n_elem = sum(p.numel() for p in model.parameters())
    for case, kw in {**GRID, **BF16}.items():
        meta = json.loads(str(r0[f"{case}/comm_meta"]))
        zero = kw.get("zero1", False)
        layout = zero_layout(model, world, kw.get("bucket_mb", 0.0))
        wire = kw.get("reduce_dtype", "float32")
        assert meta["sharding"] == ("zero2" if kw.get("zero2")
                                    else "zero1" if zero else "dp"), case
        assert meta["bucketed"] == bool(kw.get("bucket_mb")), case
        assert meta["gathers"] == (1 if zero else 0), case
        assert meta["reduce_dtype"] == wire
        if kw.get("bucket_mb"):
            assert meta["buckets"] == build_bucket_layout(
                model, world, int(round(kw["bucket_mb"] * 2 ** 20))
            ).num_buckets > 1, case
        else:
            assert meta["buckets"] == (1 if zero else 16), case
        want = exchange_wire_bytes(n_elem, layout.total_padded, zero=zero,
                                   wire_dtype=wire)
        assert {k: meta[k] for k in want} == want, case


def test_bucket_zero_is_issued_before_conv1_gradients_exist(runs):
    """The port's form of the overlap property: fc8's bucket is on the
    wire before the backward has produced conv1's gradients."""
    events = [tuple(e) for e in json.loads(str(
        runs[2][0]["issue_order/events"]))]
    issued = events.index(("issue", 0))
    assert issued < events.index(("grad", "conv1/kernel"))
    assert issued < events.index(("grad", "conv1/bias"))
    assert events[0] in (("grad", "fc8/kernel"), ("grad", "fc8/bias"))
    # every bucket is issued once, right as its last gradient lands
    model = make_model(SPEC, runs["tree"])
    layout = build_bucket_layout(model, 2, int(round(SMALL * 2 ** 20)))
    issues = [j for j, e in enumerate(events) if e[0] == "issue"]
    assert sorted(events[j][1] for j in issues) == list(
        range(layout.num_buckets))
    for j in issues:
        names = {layout.names[i] for i in layout.buckets[events[j][1]]}
        landed = {e[1] for e in events[:j] if e[0] == "grad"}
        assert names <= landed and events[j - 1][1] in names
    assert sum(e[0] == "grad" for e in events) == 16


def test_nonfinite_batch_on_one_rank_skips_on_every_rank(runs):
    """A NaN in rank 1's batch at step 1 makes both ranks skip it, leaves
    each rank's params, momentum shard and count bitwise unchanged, and
    the next step runs (no rank waits on a collective its peer skipped)."""
    for r in range(2):
        out = runs[2][r]
        np.testing.assert_array_equal(out["nonfinite/bad_step"], [0, 1, 0])
        assert not np.isfinite(out["nonfinite/loss"][1])
        np.testing.assert_array_equal(out["nonfinite/snap1"],
                                      out["nonfinite/snap0"])
        assert out["nonfinite/snap1"][-1] == 1
        assert out["nonfinite/snap2"][-1] == 2
        assert not np.array_equal(out["nonfinite/snap2"],
                                  out["nonfinite/snap1"])


def test_ranks_draw_their_own_dropout_masks_and_replay(runs):
    r0, r1 = runs[2]
    for i in range(2):     # fc6's and fc7's masks
        a, b = r0[f"masks/mask{i}"], r1[f"masks/mask{i}"]
        assert a.shape == b.shape == (8, 32)
        assert not np.array_equal(a, b)
        np.testing.assert_array_equal(a, r0[f"masks_replay/mask{i}"])
        np.testing.assert_array_equal(b, r1[f"masks_replay/mask{i}"])
    # rank 0 draws what a one-process step draws on the same rows
    model = make_model(SPEC, runs["tree"], dropout=0.5)
    cfg = make_config(SPEC, 0.5)
    state = TrainState.create(model, build_optimizer(cfg,
                                                     model.parameters())[0])
    drop, masks = model._dropout, []

    def recorded(x, generator):
        y = drop(x, generator)
        masks.append((y != 0).numpy())
        return y
    model._dropout = recorded
    arrays = runs["arrays"]
    step = build_train_step(lambda s: SPEC["lr"], SPEC["weight_decay"],
                            device="cpu")
    step(state, {"image": arrays["batch0/image"][:8],
                 "label": arrays["batch0/label"][:8]}, 3)
    for i in range(2):
        np.testing.assert_array_equal(masks[i], r0[f"masks/mask{i}"])

"""The port's ZeRO-3 (`mesh.shard_params`: train/step.py, train/state.py,
parallel/buckets.py `gather_param_tree`) in 2- and 4-process gloo groups,
against the port's ZeRO-2 on the same ranks.

One group of each size runs every case in one launch
(tests/_torch_dp_worker.py): narrow VGG-F (stem 8, convs 16, FC 32, 10
classes, 32 px), fp32, dropout and augment off, grad clip 1.0, 3 steps at
global batch 16. The equality grid is ZeRO-3 against ZeRO-2 over
{unbucketed, ~0.5 KB buckets} x {accum 1, 2} x {no EMA, EMA 0.9}, each
pair at an fp32 wire: losses, grad norms, the gathered params, the (T,)
momentum and the gathered EMA are all EQUAL, bit for bit — ZeRO-3 runs
ZeRO-2's arithmetic on the same values, only the gather moves up front.
Between steps every parameter holds no storage: the rank keeps its (S,)
shard and its (S,) EMA shard. On the bf16 wire the gather narrows too
(the one basis where both legs do), so the forward runs on the
bf16-rounded weights: held to the ZeRO-2 bf16 run (whose gather stays
fp32) at losses rtol 1e-4 (measured 1.72e-5 on the CPU with torch 2.13,
2 and 4 ranks), grad norms rtol 1e-2 (measured 6.7e-4) and params atol
5e-4 (measured 4.8e-5; tests/test_torch_zero.py's bf16 bound), and not
bit-equal to it. The 2-process group also runs the gather order and the
non-finite skip."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_dp_worker import make_config, make_model, run_group
from distributed_vgg_f_tpu_torch import config as tcfg
from distributed_vgg_f_tpu_torch.models.vggf import VGGF
from distributed_vgg_f_tpu_torch.parallel.buckets import (
    build_bucket_layout, exchange_wire_bytes, sharding_basis)
from distributed_vgg_f_tpu_torch.parallel.zero import zero_layout
from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
from distributed_vgg_f_tpu_torch.train.state import TrainState
from distributed_vgg_f_tpu_torch.train.step import build_train_step
from distributed_vgg_f_tpu_torch.weights import params_to_flax

WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
SPEC = {"widths": WIDTHS, "size": 32, "classes": 10, "batch": 16,
        "lr": 0.05, "weight_decay": 1e-4, "clip": 1.0}
SMALL = 0.0005
STEPS = 3
#: the equality grid: (bucket_mb, accum, ema) -> a ZeRO-2 and a ZeRO-3 case
GRID = [(mb, accum, ema) for mb in (0.0, SMALL) for accum in (1, 2)
        for ema in (0.0, 0.9)]


def _name(basis, mb, accum, ema):
    return f"{basis}_b{int(bool(mb))}_a{accum}_e{int(bool(ema))}"


def _cases(world):
    cases = []
    for mb, accum, ema in GRID:
        for basis in ("zero2", "zero3"):
            cases.append(dict(name=_name(basis, mb, accum, ema), zero1=True,
                              zero2=True, zero3=basis == "zero3",
                              bucket_mb=mb, accum=accum, ema=ema,
                              steps=STEPS))
    for basis in ("zero2", "zero3"):
        cases.append(dict(name=f"{basis}_bf16", zero1=True, zero2=True,
                          zero3=basis == "zero3", bucket_mb=SMALL,
                          reduce_dtype="bfloat16", steps=STEPS))
    if world == 2:
        cases += [
            dict(name="order", zero1=True, zero2=True, zero3=True,
                 bucket_mb=SMALL, steps=1, events=True),
            dict(name="nonfinite", zero1=True, zero2=True, zero3=True,
                 bucket_mb=SMALL, ema=0.9, steps=3, skip_nonfinite=True,
                 nan=[1, 1])]
    return cases


def _params():
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
    tree = _params()
    arrays = _arrays(tree)
    out = {"tree": tree}
    for world in (2, 4):
        out[world] = run_group(world, dict(SPEC, cases=_cases(world)), arrays,
                               str(tmp_path_factory.mktemp(f"z3_{world}")))
    return out


def _of(rank_out, case, what):
    prefix = f"{case}/{what}/"
    return {k[len(prefix):]: v for k, v in rank_out.items()
            if k.startswith(prefix)}


def test_config_ladder_and_refusals():
    assert tcfg.MeshConfig(shard_opt_state=True, shard_gradients=True,
                           shard_params=True).sharding_label == "zero3"
    with pytest.raises(ValueError, match="shard_params"):
        tcfg.MeshConfig(shard_opt_state=True, shard_params=True)
    flagship = tcfg.get_config("vggf_imagenet_dp")
    assert flagship.mesh.shard_params is False
    assert flagship.mesh.sharding_label == "zero2"
    on = tcfg.apply_overrides(flagship, {"mesh.shard_params": "true"})
    assert on.mesh.sharding_label == "zero3"
    assert sharding_basis(True, True, True) == "zero3"
    with pytest.raises(ValueError, match="shard_params"):
        build_train_step(lambda s: 0.1, 0.0, zero1=True,
                         shard_gradients=False, shard_params=True,
                         device="cpu")
    with pytest.raises(KeyError, match="A13b"):
        tcfg.apply_overrides(flagship, {"mesh.elastic.batch_policy": "x"})


def test_elastic_resize_stays_refused_naming_a13b():
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    cfg = tcfg.get_config("vggf_imagenet_dp")
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, shard_params=True,
        elastic=tcfg.ElasticConfig(enabled=True)))
    with pytest.raises(NotImplementedError, match="A13b"):
        Trainer(cfg, device="cpu")


def test_one_process_zero3_releases_and_matches_zero2():
    """Without a group (N = 1, the gather a copy): the same grid point
    bit-equal, the parameters zero-size between steps, and a ZeRO-3 state
    refused by a ZeRO-2 step and the converse."""
    tree, cfg = _params(), make_config(SPEC)
    batch = {k: v[:8] for k, v in
             (("image", _arrays(tree)["batch0/image"]),
              ("label", _arrays(tree)["batch0/label"]))}
    got = {}
    for z3 in (False, True):
        model = make_model(SPEC, tree)
        state = TrainState.create_sharded(
            model, lambda ps: build_optimizer(cfg, ps)[0],
            zero_layout(model, 1, SMALL), ema=True, shard_params=z3)
        step = build_train_step(lambda s: 0.05, 1e-4, zero1=True,
                                shard_gradients=True, shard_params=z3,
                                comm_bucket_mb=SMALL, ema_decay=0.9,
                                device="cpu")
        other = build_train_step(lambda s: 0.05, 1e-4, zero1=True,
                                 shard_gradients=True, shard_params=not z3,
                                 comm_bucket_mb=SMALL, device="cpu")
        with pytest.raises(ValueError, match="shard_params"):
            other(state, batch, 0)
        for _ in range(2):
            state, m = step(state, batch, 0)
        got[z3] = (float(m["loss"]), state.params_tree(),
                   state.params_tree(ema=True), state.momentum_global())
        if z3:
            assert all(p.numel() == 0 for p in model.parameters())
            assert {k: tuple(p.shape) for k, p in
                    state.shapes.named_parameters()} == {
                k: tuple(v.shape) for k, v in got[False][1].items()}
    assert got[True][0] == got[False][0]
    for i in (1, 2):
        for k, v in got[False][i].items():
            assert torch.equal(got[True][i][k], v), k
    assert torch.equal(got[True][3], got[False][3])


@pytest.mark.parametrize("world", [2, 4])
def test_equality_grid_zero3_equals_zero2(runs, world):
    for r in range(world):
        out = runs[world][r]
        for mb, accum, ema in GRID:
            z2, z3 = (_name(b, mb, accum, ema) for b in ("zero2", "zero3"))
            np.testing.assert_array_equal(out[f"{z3}/loss"],
                                          out[f"{z2}/loss"], err_msg=z3)
            np.testing.assert_array_equal(out[f"{z3}/grad_norm"],
                                          out[f"{z2}/grad_norm"], err_msg=z3)
            for what in ("params", "ema"):
                want = _of(out, z2, what)
                got = _of(out, z3, what)
                assert set(got) == set(want) and (bool(want) == bool(ema)
                                                  or what == "params")
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k],
                                                  err_msg=f"{z3} {what} {k}")
            np.testing.assert_array_equal(out[f"{z3}/momentum"],
                                          out[f"{z2}/momentum"], err_msg=z3)
    # the params moved and every rank holds the same ones
    r0 = runs[world][0]
    assert not np.allclose(r0["zero3_b1_a1_e0/params/fc8.weight"],
                           runs["tree"]["fc8"]["kernel"].T)
    for r in range(1, world):
        for k, v in _of(r0, "zero3_b1_a2_e1", "params").items():
            np.testing.assert_array_equal(
                runs[world][r][f"zero3_b1_a2_e1/params/{k}"], v)


@pytest.mark.parametrize("world", [2, 4])
def test_only_the_shards_persist_between_steps(runs, world):
    model = make_model(SPEC, runs["tree"])
    for mb, accum, ema in GRID:
        case = _name("zero3", mb, accum, ema)
        layout = zero_layout(model, world, mb)
        for r in range(world):
            resident = runs[world][r][f"{case}/resident"]
            assert list(resident[:STEPS]) == [0] * STEPS, case
            assert resident[STEPS] == layout.shard_size
            assert resident[STEPS + 1] == (layout.shard_size if ema else 0)
        assert layout.shard_size * world == layout.total_padded


@pytest.mark.parametrize("world", [2, 4])
def test_comm_meta_gathers_and_bytes(runs, world):
    model = make_model(SPEC, runs["tree"])
    n_elem = sum(p.numel() for p in model.parameters())
    for mb, accum, _ in GRID:
        for basis in ("zero2", "zero3"):
            case = _name(basis, mb, accum, 0.0)
            meta = json.loads(str(runs[world][0][f"{case}/comm_meta"]))
            layout = zero_layout(model, world, mb)
            buckets = (build_bucket_layout(model, world,
                                           int(round(mb * 2 ** 20)))
                       .num_buckets if mb else 1)
            assert meta["sharding"] == basis
            assert meta["buckets"] == buckets
            assert meta["gathers"] == (buckets if basis == "zero3" else 1)
            want = exchange_wire_bytes(n_elem, layout.total_padded,
                                       zero=True,
                                       shard_params=basis == "zero3")
            if accum > 1:   # k micro-scatters a step
                want["scatter_bytes"] *= accum
                want["wire_bytes"] = (want["scatter_bytes"]
                                      + want["gather_bytes"])
            assert {k: meta[k] for k in want} == want, case
            # the comm/* counters moved by comm_meta a step
            comm = json.loads(str(runs[world][0][f"{case}/comm"]))
            assert comm == {
                "comm/exchanges": STEPS,
                "comm/wire_bytes": STEPS * meta["wire_bytes"],
                "comm/gathers": STEPS * meta["gathers"],
                "comm/gather_wire_bytes": STEPS * meta["gather_bytes"]}
    bf16 = json.loads(str(runs[world][0]["zero3_bf16/comm_meta"]))
    fp32 = json.loads(str(runs[world][0]["zero3_b1_a1_e0/comm_meta"]))
    assert bf16["gather_bytes"] * 2 == fp32["gather_bytes"]
    z2_bf16 = json.loads(str(runs[world][0]["zero2_bf16/comm_meta"]))
    assert z2_bf16["gather_bytes"] == fp32["gather_bytes"]


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_gather_wire_within_tolerance(runs, world):
    r0 = runs[world][0]
    np.testing.assert_allclose(r0["zero3_bf16/loss"], r0["zero2_bf16/loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(r0["zero3_bf16/grad_norm"],
                               r0["zero2_bf16/grad_norm"], rtol=1e-2)
    want = _of(r0, "zero2_bf16", "params")
    got = _of(r0, "zero3_bf16", "params")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-4, rtol=0,
                                   err_msg=k)
    # the gather narrowed: not the fp32-gather run's bits
    assert not np.array_equal(r0["zero3_bf16/grad_norm"],
                              r0["zero2_bf16/grad_norm"])


def test_gathers_are_issued_in_forward_order_before_any_gradient(runs):
    events = [tuple(e) for e in json.loads(str(runs[2][0]["order/events"]))]
    model = make_model(SPEC, runs["tree"])
    layout = build_bucket_layout(model, 2, int(round(SMALL * 2 ** 20)))
    gathers = [e for e in events if e[0] == "gather"]
    assert gathers == [("gather", b) for b in
                       reversed(range(layout.num_buckets))]
    first_grad = min(i for i, e in enumerate(events) if e[0] == "grad")
    assert max(events.index(g) for g in gathers) < first_grad
    assert events[first_grad] in (("grad", "fc8/kernel"),
                                  ("grad", "fc8/bias"))


def test_nonfinite_step_leaves_the_shards_unchanged(runs):
    for r in range(2):
        out = runs[2][r]
        np.testing.assert_array_equal(out["nonfinite/bad_step"], [0, 1, 0])
        np.testing.assert_array_equal(out["nonfinite/snap1"],
                                      out["nonfinite/snap0"])
        assert out["nonfinite/snap1"][-1] == 1
        assert out["nonfinite/snap2"][-1] == 2
        assert not np.array_equal(out["nonfinite/snap2"],
                                  out["nonfinite/snap1"])
        assert list(out["nonfinite/resident"][:3]) == [0, 0, 0]

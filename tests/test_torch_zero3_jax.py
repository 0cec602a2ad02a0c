"""The port's ZeRO-3 against the JAX package's: the layout conversion,
the step, the exchange receipt, and the zoo lane.

- `parallel.zero.convert_params` against JAX's on numpy arrays of the
  narrow VGG-F, bit-equal: tree -> flat, flat -> tree, canonical <->
  bucketed, N -> M for (4 -> 2, 2 -> 4, 4 -> 1), and the ValueErrors on a
  length that disagrees with a layout.
- The port's ZeRO-3 step in 2- and 4-process gloo groups
  (tests/_torch_dp_worker.py) against JAX's `build_train_step(...,
  shard_params=True)` on meshes of the first 2 and 4 virtual CPU
  devices, from the same weights (JAX's init) and batches: narrow VGG-F
  (stem 8, convs 16, FC 32, 10 classes, 32 px), fp32, dropout and augment
  off, SGD momentum 0.9 at a constant LR, ~0.5 KB buckets, 3 steps at
  global batch 16, accum 1 with the EMA (0.9) and accum 2. Tolerances of
  tests/test_torch_zero_jax.py: losses rtol 2e-6, the params, the EMA
  and the (T,) flat momentum atol 1e-6 + rtol 1e-5 (JAX's (T,) params
  and EMA vectors read through its layout's `from_global`). On the bf16
  wire both legs narrow, and gloo and XLA sum a bucket's bf16 gradients
  over 4 ranks in different orders, so a momentum element can land one
  bf16 ulp apart (4.88e-4 at |m| in [0.0625, 0.125); |m| < 0.25 here):
  the momentum atol 1e-3 (measured 4.88e-4 in 197 of 15020 elements on
  4 ranks, 1.3e-8 on 2, on the CPU with torch 2.13), the params atol
  1e-4 (measured 3.3e-5: the LR times that ulp), losses rtol 1e-5
  (measured 7.2e-7).
- `comm_meta` against JAX's: the sharding, the gathers (one a bucket)
  and `exchange_wire_bytes` with `shard_params`, equal.
- The zoo lane (JAX `tests/test_zero3.py:393`): a narrow ResNet with
  cross-replica sync-BN and a narrow ViT, each through the port's
  `Trainer.fit` on 2 gloo ranks (tests/_torch_zoo_worker.py), ZeRO-3
  against ZeRO-2, bucketed and not: losses, params, the statistics and
  (ResNet) the EMA equal bit for bit."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dp_worker import run_group
from _torch_zoo_worker import run_group as run_zoo_group
from distributed_vgg_f_tpu.models.vggf import VGGF as JaxVGGF
from distributed_vgg_f_tpu.parallel import buckets as jbuckets
from distributed_vgg_f_tpu.parallel import zero as jzero
from distributed_vgg_f_tpu.parallel.mesh import (MeshSpec, build_mesh,
                                                 shard_host_batch)
from distributed_vgg_f_tpu.train.state import TrainState as JaxState
from distributed_vgg_f_tpu.train.step import build_train_step as jax_step
from distributed_vgg_f_tpu_torch.models.vggf import VGGF
from distributed_vgg_f_tpu_torch.parallel import buckets as pbuckets
from distributed_vgg_f_tpu_torch.parallel import zero as pzero
from distributed_vgg_f_tpu_torch.weights import load_params, params_to_flax

WIDTHS = dict(stem_features=8, conv_features=16, fc_features=32)
SIZE, CLASSES, BATCH, LR, WD = 32, 10, 16, 0.05, 1e-4
BUCKET_MB = 0.0005
BUCKET_BYTES = int(round(BUCKET_MB * 1024 * 1024))
STEPS = 3
SPEC = {"widths": WIDTHS, "size": SIZE, "classes": CLASSES, "batch": BATCH,
        "lr": LR, "weight_decay": WD}


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


def _flax_tree():
    """Seeded narrow VGG-F params as a Flax tree (numpy)."""
    model = VGGF(CLASSES, compute_dtype=torch.float32, image_size=SIZE,
                 dropout_rate=0.0, **WIDTHS)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return params_to_flax(model.state_dict())


def _port_model(tree):
    return load_params(VGGF(CLASSES, compute_dtype=torch.float32,
                            image_size=SIZE, dropout_rate=0.0, **WIDTHS),
                       tree)


# ---------------------------------------------------------- convert_params
def _layouts(n, bucketed, tree, model):
    """(JAX layout or None, port layout or None, padded) for n shards."""
    if not bucketed:
        total = jzero.flat_param_count(tree)
        return None, None, jzero.padded_flat_size(total, n)
    jl = jbuckets.build_bucket_layout(tree, n, BUCKET_BYTES)
    pl = pbuckets.build_bucket_layout(model, n, BUCKET_BYTES)
    assert jl.total_padded == pl.total_padded
    return jl, pl, jl.total_padded


def _port_tree(tree):
    return {k: v.detach().clone()
            for k, v in _port_model(tree).named_parameters()}


def _to_flax(port):
    return _tree(params_to_flax({k: v for k, v in port.items()}))


#: (source (n, bucketed) or "tree", target (n, bucketed) or "tree")
CONVERSIONS = [
    ("tree", (4, False)), ("tree", (2, True)),
    ((4, False), "tree"), ((4, True), "tree"),
    ((4, False), (4, True)), ((4, True), (4, False)),
    ((4, True), (2, True)), ((2, True), (4, True)), ((4, True), (1, True)),
    ((4, False), (2, False)), ((2, False), (4, True)),
    ((4, False), (1, False)),
]


@pytest.mark.parametrize("src,dst", CONVERSIONS,
                         ids=[f"{s}->{d}" for s, d in CONVERSIONS])
def test_convert_params_equals_jax(src, dst):
    tree = _flax_tree()
    model = _port_model(tree)
    if src == "tree":
        j_in, p_in, j_src, p_src = tree, _port_tree(tree), None, None
    else:
        j_src, p_src, padded = _layouts(src[0], src[1], tree, model)
        j_in = np.asarray(jzero.flatten_params(tree, padded,
                                               bucket_layout=j_src))
        p_in = torch.from_numpy(j_in.copy())
    if dst == "tree":
        j_dst, p_dst, target = None, None, None
    else:
        j_dst, p_dst, target = _layouts(dst[0], dst[1], tree, model)
    want = jzero.convert_params(j_in, tree, target, src_bucket_layout=j_src,
                                target_bucket_layout=j_dst)
    got = pzero.convert_params(p_in, model, target, src_bucket_layout=p_src,
                               target_bucket_layout=p_dst)
    if dst == "tree":
        want, got = _tree(want), _to_flax(got)
        for layer in want:
            for leaf in want[layer]:
                np.testing.assert_array_equal(got[layer][leaf],
                                              want[layer][leaf])
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (target,)


def test_convert_params_refuses_lengths_as_jax_does():
    tree = _flax_tree()
    model = _port_model(tree)
    j4, p4, padded = _layouts(4, True, tree, model)
    j2, p2, padded2 = _layouts(2, True, tree, model)
    vec = np.asarray(jzero.flatten_params(tree, padded, bucket_layout=j4))
    for conv, src, dst, v in (
            (jzero.convert_params, j2, j4, vec),
            (pzero.convert_params, p2, p4, torch.from_numpy(vec.copy()))):
        arg = tree if conv is jzero.convert_params else model
        with pytest.raises(ValueError, match="does not match the saved "
                                             "flat params length"):
            conv(v, arg, padded, src_bucket_layout=src,
                 target_bucket_layout=dst)
        with pytest.raises(ValueError, match="disagrees with the target"):
            conv(v, arg, padded + 1, src_bucket_layout=dst,
                 target_bucket_layout=dst)


# ---------------------------------------------------------------- the step
class _Jax:
    """JAX's ZeRO-3 bucketed step on an n-device CPU mesh."""

    def __init__(self, n, accum, ema, wire):
        self.mesh = build_mesh(MeshSpec(("data",), (n,)),
                               devices=jax.devices()[:n])
        model = JaxVGGF(num_classes=CLASSES, dropout_rate=0.0,
                        compute_dtype=jnp.float32, **WIDTHS)
        tx = optax.sgd(LR, momentum=0.9)
        sample = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
        shapes = jax.eval_shape(
            lambda r: JaxState.create(model, tx, r, sample, zero1_shards=n),
            jax.random.key(0))
        self.p_struct = shapes.params
        self.layout = jbuckets.build_bucket_layout(self.p_struct, n,
                                                   BUCKET_BYTES)

        def create(r):
            return JaxState.create(model, tx, r, sample, zero1_shards=n,
                                   bucket_layout=self.layout,
                                   shard_params=True, ema=ema > 0)

        specs = jzero.train_state_specs(
            jax.eval_shape(create, jax.random.key(0)),
            self.layout.total_padded, "data", shard_params=True)
        shardings = jax.tree.map(lambda s: NamedSharding(self.mesh, s),
                                 specs, is_leaf=lambda x: isinstance(x, P))
        self.state = jax.jit(create, out_shardings=shardings)(
            jax.random.key(0))
        self.step = jax_step(
            model, tx, self.mesh, weight_decay=WD, zero1=True,
            state_specs=specs, grad_accum_steps=accum, shard_gradients=True,
            shard_params=True, params_struct=self.p_struct,
            comm_bucket_mb=BUCKET_MB, reduce_dtype=wire, ema_decay=ema)

    def tree_of(self, vec):
        return _tree(self.layout.from_global(
            jnp.asarray(jax.device_get(vec))))

    def run(self, batches):
        state, losses = self.state, []
        for b in batches:
            state, m = self.step(state, shard_host_batch(b, self.mesh),
                                 jax.random.key(1))
            losses.append(float(jax.device_get(m["loss"])))
        return state, np.array(losses)


#: name -> (accum, ema, wire)
STEP_CASES = {"accum1_ema": (1, 0.9, "float32"),
              "accum2": (2, 0.0, "float32"),
              "bf16": (1, 0.0, "bfloat16")}


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"image": rng.standard_normal(
                 (BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module", params=[2, 4])
def anchored(request, tmp_path_factory):
    n = request.param
    batches = _batches(STEPS)
    arrays = {}
    for i, b in enumerate(batches):
        arrays[f"batch{i}/image"] = b["image"]
        arrays[f"batch{i}/label"] = b["label"]
    jax_out, cases, init = {}, [], None
    for name, (accum, ema, wire) in STEP_CASES.items():
        j = _Jax(n, accum, ema, wire)
        init = j.tree_of(j.state.params)
        state, losses = j.run(batches)
        jax_out[name] = {
            "loss": losses, "params": j.tree_of(state.params),
            "ema": j.tree_of(state.ema_params) if ema else None,
            "trace": np.asarray(state.opt_state[0].trace),
            "comm_meta": dict(j.step.comm_meta)}
        cases.append(dict(name=name, zero1=True, zero2=True, zero3=True,
                          bucket_mb=BUCKET_MB, accum=accum, ema=ema,
                          reduce_dtype=wire, steps=STEPS))
    for layer, leaves in init.items():
        for leaf, v in leaves.items():
            arrays[f"params/{layer}/{leaf}"] = v
    port = run_group(n, dict(SPEC, cases=cases), arrays,
                     str(tmp_path_factory.mktemp(f"zero3_jax{n}")))
    return n, jax_out, port


def _port_tree_out(rank_out, case, what="params"):
    prefix = f"{case}/{what}/"
    return _to_flax({k[len(prefix):]: torch.from_numpy(v)
                     for k, v in rank_out.items() if k.startswith(prefix)})


def _assert_tree_close(got, want, atol, rtol):
    for layer in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{layer}/{leaf}")


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_zero3_step_matches_jax(anchored, case):
    n, jax_out, port = anchored
    want = jax_out[case]
    fp32 = STEP_CASES[case][2] == "float32"
    loss_rtol, atol, rtol, mom_atol = ((2e-6, 1e-6, 1e-5, 1e-6) if fp32
                                       else (1e-5, 1e-4, 0.0, 1e-3))
    np.testing.assert_allclose(port[0][f"{case}/loss"], want["loss"],
                               rtol=loss_rtol)
    for r in range(n):
        _assert_tree_close(_port_tree_out(port[r], case), want["params"],
                           atol, rtol)
        if want["ema"] is not None:
            _assert_tree_close(_port_tree_out(port[r], case, "ema"),
                               want["ema"], atol, rtol)
    got = port[0][f"{case}/momentum"]
    assert got.shape == want["trace"].shape
    np.testing.assert_allclose(got, want["trace"], atol=mom_atol, rtol=rtol)
    assert np.abs(want["trace"]).max() > 0


def test_comm_meta_equals_jax(anchored):
    n, jax_out, port = anchored
    model = _port_model(_flax_tree())
    layout = pbuckets.build_bucket_layout(model, n, BUCKET_BYTES)
    for case, (accum, _, wire) in STEP_CASES.items():
        got = json.loads(str(port[0][f"{case}/comm_meta"]))
        want = jax_out[case]["comm_meta"]
        for key in ("sharding", "bucketed", "buckets", "gathers",
                    "wire_bytes", "scatter_bytes", "gather_bytes",
                    "allreduce_bytes", "grad_accum_steps"):
            assert got[key] == want[key], (case, key, got[key], want[key])
        assert got["sharding"] == "zero3"
        assert got["gathers"] == got["buckets"] == layout.num_buckets
        n_elem = sum(p.numel() for p in model.parameters())
        jw = jbuckets.exchange_wire_bytes(
            n_elem, layout.total_padded, zero=True,
            wire_dtype=jnp.bfloat16 if wire == "bfloat16" else None,
            shard_params=True)
        pw = pbuckets.exchange_wire_bytes(n_elem, layout.total_padded,
                                          zero=True, wire_dtype=wire,
                                          shard_params=True)
        assert pw == jw


# ----------------------------------------------------------- the zoo lane
ZOO_BATCH, ZOO_SIZE, ZOO_STEPS = 16, 32, 3
#: dotted keys of the narrow runs (the rest is the preset's)
ZOO_COMMON = {"model.num_classes": "10", "model.compute_dtype": "float32",
              "model.dropout_rate": "0.0", "data.image_size": str(ZOO_SIZE),
              "data.global_batch_size": str(ZOO_BATCH),
              "data.name": "synthetic", "data.num_train_examples": "160",
              "data.augment.enabled": "false",
              "data.autotune.enabled": "false",
              "optim.reference_batch_size": str(ZOO_BATCH),
              "optim.warmup_epochs": "0", "optim.base_lr": "0.002",
              "mesh.shard_opt_state": "true",
              "mesh.shard_gradients": "true",
              "train.seed": "0", "train.log_every": "1",
              "train.ema_decay": "0.9"}
ZOO = {
    "resnet": ("resnet50_imagenet", {"stage_sizes": [1, 1, 1, 1]}),
    "vit": ("vit_s16_imagenet",
            {"hidden_dim": 64, "depth": 2, "num_heads": 2, "mlp_dim": 128,
             "patch_size": 8, "attention_layout": "flash"}),
}


@pytest.fixture(scope="module")
def zoo_runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    arrays = {}
    for i in range(ZOO_STEPS):
        image = rng.standard_normal(
            (ZOO_BATCH, ZOO_SIZE, ZOO_SIZE, 3)).astype(np.float32)
        image[ZOO_BATCH // 2:] = image[ZOO_BATCH // 2:] * 1.5 + 1.0
        arrays[f"batch{i}/image"] = image
        arrays[f"batch{i}/label"] = rng.integers(0, 10, ZOO_BATCH).astype(
            np.int32)
    cases = []
    for model, (preset, extra) in ZOO.items():
        for mb in ("0.0", "0.0005"):
            for z3 in ("false", "true"):
                cases.append(dict(
                    name=f"{model}_b{mb}_z3{z3}", preset=preset, extra=extra,
                    steps=ZOO_STEPS,
                    overrides={**ZOO_COMMON, "mesh.comm_bucket_mb": mb,
                               "mesh.shard_params": z3}))
    return run_zoo_group(2, {"cases": cases}, arrays,
                         str(tmp_path_factory.mktemp("zoo_zero3")))


@pytest.mark.parametrize("model", list(ZOO))
@pytest.mark.parametrize("mb", ["0.0", "0.0005"])
def test_zoo_lane_zero3_equals_zero2(zoo_runs, model, mb):
    z2, z3 = f"{model}_b{mb}_z3false", f"{model}_b{mb}_z3true"
    for r in range(2):
        out = zoo_runs[r]
        meta = json.loads(str(out[f"{z3}/comm_meta"]))
        assert meta["sharding"] == "zero3"
        assert meta["gathers"] == meta["buckets"]
        np.testing.assert_array_equal(out[f"{z3}/loss"], out[f"{z2}/loss"])
        assert str(out[f"{z3}/stats_sha"]) == str(out[f"{z2}/stats_sha"])
        for what in ("params", "stats", "ema", "ema_stats"):
            prefix2, prefix3 = f"{z2}/{what}/", f"{z3}/{what}/"
            want = {k[len(prefix2):]: v for k, v in out.items()
                    if k.startswith(prefix2)}
            got = {k[len(prefix3):]: v for k, v in out.items()
                   if k.startswith(prefix3)}
            assert set(got) == set(want), what
            assert want or (what in ("stats", "ema_stats")
                            and model == "vit")
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{z3} {what} {k}")
    assert np.isfinite(zoo_runs[0][f"{z3}/loss"]).all()


def test_zero3_comm_block_passes_both_validators(anchored):
    """A zero3 run's `comm` block: the port's record validator and JAX's
    accept it, and both refuse a negative gather count."""
    from distributed_vgg_f_tpu.telemetry import schema as jschema
    from distributed_vgg_f_tpu_torch.telemetry import schema as pschema
    _, _, port = anchored
    for case in STEP_CASES:
        block = json.loads(str(port[0][f"{case}/comm_meta"]))
        for validate in (pschema.validate_comm_block,
                         jschema.validate_comm_block):
            errors = []
            validate(block, "comm", errors)
            assert errors == [], (case, errors)
            errors = []
            validate(dict(block, gathers=-1), "comm", errors)
            assert errors and "gathers" in errors[0]

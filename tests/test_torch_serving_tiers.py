"""The port's serving tier ladder (distributed_vgg_f_tpu_torch/serving/
tiers.py and the (model, tier) router of serving/server.py) against the
JAX package's on the same weights, at 32 px and 5 classes on the CPU
(``device="cpu"``), buckets 1, 2, 4 — every case of the JAX package's
tests/test_serving_tiers.py that reads no bench artifact, plus parity:

- `calibration_images` byte-equal to JAX's; `quantize_dense` equal.
- fp32-compute base: the fp32 tier's probabilities within 1e-5 absolute
  of JAX's fp32 engine; the int8 tier, built from JAX's own
  `CalibrationResult` (scales, kept sets, widths: the two trunks differ by
  float ulps, which could move an activation across a rounding boundary),
  within 1e-5 of JAX's int8 tier; the bf16 tier within 1e-2.
- An independent port calibration: scales within 1e-5 relative of JAX's
  and the kept sets equal, asserted only after every channel's maximum
  is shown to lie at least 1e-3 relative from the keep threshold a/2.
- The compacted int8 tier equal to the port's dense int8 reference
  within 1e-4 on calibration-range inputs.
- Each tier's served response bit-equal to that tier's own `engine.run`.
- The student tier from a student npz the JAX package wrote, against
  JAX's student engine within 1e-5.
- A ResNet base gets bf16 but its int8 is refused with JAX's text;
  `serve_from_params` serves a ResNet with its BatchNorm statistics,
  within 1e-5 of JAX's engine on the same params and statistics."""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu import config as jcfg
from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.config import (SERVING_TIERS, DataConfig,
                                                ExperimentConfig,
                                                ModelConfig, ServingConfig,
                                                ServingTiersConfig)
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.serving import tiers as tiers_mod
from distributed_vgg_f_tpu_torch.serving.engine import PredictEngine
from distributed_vgg_f_tpu_torch.serving.server import (PredictServer,
                                                        serve_from_params)
from distributed_vgg_f_tpu_torch.weights import load_params

SIZE, CLASSES = 32, 5


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _flax_init(name, seed, **extra):
    from distributed_vgg_f_tpu.models.registry import build_model as jbuild
    model = jbuild(jcfg.ModelConfig(name=name, num_classes=CLASSES,
                                    compute_dtype="float32", extra=extra))
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros((1, SIZE, SIZE, 3), np.float32),
                           train=False)
    return model, jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.fixture(scope="module")
def jax_ladder():
    """JAX's ladder as tests/test_serving_tiers.py builds it."""
    from distributed_vgg_f_tpu.serving.engine import \
        PredictEngine as JaxEngine
    from distributed_vgg_f_tpu.serving import tiers as jtiers
    model, variables = _flax_init("vggf", 0)
    base = JaxEngine(model_name="vggf", model=model,
                     params=variables["params"], batch_stats=None,
                     image_size=SIZE, num_classes=CLASSES, max_batch=4)
    smodel, svars = _flax_init("vggf_student", 1)
    return {"fp32": base,
            "bf16": jtiers.build_bf16_engine(base),
            "int8": jtiers.build_int8_engine(
                base, tiers_cfg=jcfg.ServingTiersConfig(enabled=True)),
            "student": jtiers.build_student_engine(
                base, student_model=smodel, student_params=svars["params"]),
            "trees": (variables["params"], svars["params"])}


def _port_model(name, tree):
    model = build_model(ModelConfig(name=name, num_classes=CLASSES,
                                    compute_dtype="float32"),
                        image_size=SIZE)
    return load_params(model, tree)


def _base_engine(tree):
    return PredictEngine(model_name="vggf", model=_port_model("vggf", tree),
                         image_size=SIZE, num_classes=CLASSES, max_batch=4,
                         device="cpu")


@pytest.fixture(scope="module")
def ladder(jax_ladder):
    """The port's ladder over the same weights; int8 from the port's own
    calibration (the default)."""
    tree, stree = jax_ladder["trees"]
    base = _base_engine(tree)
    student = tiers_mod.build_student_engine(
        base, student_model=build_model(
            ModelConfig(name="vggf_student", num_classes=CLASSES,
                        compute_dtype="float32"), image_size=SIZE),
        student_params=stree)
    return {"fp32": base,
            "bf16": tiers_mod.build_bf16_engine(base),
            "int8": tiers_mod.build_int8_engine(
                base, tiers_cfg=ServingTiersConfig(enabled=True)),
            "student": student}


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


def _post(port, model, image, query="", expect_error=False):
    url = f"http://127.0.0.1:{port}/v1/predict/{model}{query}"
    req = urllib.request.Request(url, data=image.tobytes(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        if not expect_error:
            raise
        return e.code, json.loads(e.read())


def _tier_cfg(**kw):
    return ServingConfig(enabled=True, max_batch=4, buckets=(1, 2, 4),
                         controller=False, warmup=False,
                         tiers=ServingTiersConfig(enabled=True), **kw)


def _tier_server(ladder):
    server = PredictServer(_tier_cfg())
    for eng in ladder.values():
        server.add_engine(eng)
    return server


# ----------------------------------------------------------------- builders
def test_tier_engines_agree_with_fp32_within_tolerance(ladder):
    imgs = _images(3)
    ref, _ = ladder["fp32"].run(imgs)
    for tier in ("bf16", "int8"):
        probs, _ = ladder[tier].run(imgs)
        assert probs.shape == ref.shape
        assert np.max(np.abs(probs - ref)) < 0.05, tier
        assert ladder[tier].tier == tier
    sprobs, _ = ladder["student"].run(imgs)
    assert sprobs.shape == ref.shape
    assert ladder["student"].served_by == "vggf_student"


def test_bf16_tier_holds_bf16_params_and_casts_once(ladder):
    """A second model instance: bf16 parameters, so a forward casts no
    weight; the base's parameters are untouched fp32."""
    bf16 = ladder["bf16"]._model
    assert bf16 is not ladder["fp32"]._model
    assert bf16.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in bf16.parameters())
    assert all(p.dtype == torch.float32
               for p in ladder["fp32"]._model.parameters())
    # the finish normalizes in fp32, then casts: equal to casting the
    # fp32 finish's output
    from distributed_vgg_f_tpu_torch.data.device_ingest import \
        make_device_finish
    base = ladder["fp32"]
    img = torch.from_numpy(_images(2))
    got = make_device_finish(base._mean, base._std,
                             image_dtype="bfloat16")(img)
    want = make_device_finish(base._mean, base._std)(img).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_int8_compacted_equals_dense_reference_on_calibration_range(ladder):
    from distributed_vgg_f_tpu_torch.data.device_ingest import \
        make_device_finish
    base, eng = ladder["fp32"], ladder["int8"]
    calib = eng.calibration
    # some channels elided, or the test holds nothing
    assert sum(calib.widths.values()) > sum(
        len(k) for k in calib.keep.values())
    imgs = tiers_mod.calibration_images(SIZE, batches=1, batch_size=4,
                                        seed=99)
    compacted, _ = eng.run(imgs)
    trunk = tiers_mod._make_trunk(base._model,
                                  make_device_finish(base._mean, base._std))
    heads = tiers_mod.dense_int8_reference(
        tiers_mod._head_tree(base._model), calib)
    with torch.inference_mode():
        logits = heads(trunk(torch.from_numpy(imgs)))
    dense = torch.softmax(logits.float(), dim=-1).numpy()
    assert np.allclose(compacted, dense, atol=1e-4)
    receipt = json.loads(json.dumps(calib.receipt()))
    assert set(receipt["scales"]) == {"fc6", "fc7", "fc8"}
    assert all(receipt["kept"][k] <= receipt["widths"][k]
               for k in receipt["kept"])


def test_int8_refuses_non_vggf_heads():
    from distributed_vgg_f_tpu.serving import tiers as jtiers
    bad = {"conv1": {"kernel": np.zeros((1, 1))}}
    with pytest.raises(ValueError) as want:
        jtiers._split_params(bad)
    with pytest.raises(ValueError, match="head stack") as got:
        tiers_mod._split_params(bad)
    assert str(got.value) == str(want.value)


def test_serving_only_descriptor_and_the_ladder_vocabulary():
    from distributed_vgg_f_tpu_torch.models.ingest import INGEST_DESCRIPTORS
    assert INGEST_DESCRIPTORS["vggf_student"].serving_only
    assert tuple(tiers_mod.TIERS) == tuple(SERVING_TIERS) \
        == tuple(jcfg.SERVING_TIERS)


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("seed,batches,batch_size", [(0, 4, 8), (99, 1, 4),
                                                     (3, 2, 5)])
def test_calibration_images_byte_equal_to_jax(seed, batches, batch_size):
    from distributed_vgg_f_tpu.serving import tiers as jtiers
    got = tiers_mod.calibration_images(SIZE, batches=batches,
                                       batch_size=batch_size, seed=seed)
    want = jtiers.calibration_images(SIZE, batches=batches,
                                     batch_size=batch_size, seed=seed)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()


def test_quantize_dense_equals_jax():
    from distributed_vgg_f_tpu.serving import tiers as jtiers
    w = np.random.default_rng(4).standard_normal((64, 48)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes scale 1
    got, want = tiers_mod.quantize_dense(w), jtiers.quantize_dense(w)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_tier_probabilities_match_jax(jax_ladder):
    """fp32 and int8 within 1e-5, bf16 within 1e-2, of JAX's same tier;
    the port's int8 built from JAX's calibration."""
    tree, _ = jax_ladder["trees"]
    base = _base_engine(tree)
    ours = {"fp32": base, "bf16": tiers_mod.build_bf16_engine(base),
            "int8": tiers_mod.build_int8_engine(
                base, jax_ladder["int8"].calibration)}
    imgs = _images(4, seed=7)
    for tier, tol in (("fp32", 1e-5), ("int8", 1e-5), ("bf16", 1e-2)):
        got, gb = ours[tier].run(imgs)
        want, wb = jax_ladder[tier].run(imgs)
        assert gb == wb == 4
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol,
                                   err_msg=tier)


def test_independent_calibration_matches_jax(jax_ladder, ladder):
    """Scales within 1e-5 relative; kept sets equal, once every channel's
    maximum is shown to lie at least 1e-3 relative from a/2 (closer, the
    two trunks' ulps could flip a channel)."""
    from distributed_vgg_f_tpu.serving import tiers as jtiers
    want = jax_ladder["int8"].calibration
    got = ladder["int8"].calibration
    assert (got.batches, got.batch_size, got.seed) \
        == (want.batches, want.batch_size, want.seed)
    assert got.widths == want.widths
    # the per-channel maxima, recomputed on JAX's side, set the margin
    images = jtiers.calibration_images(SIZE, batches=4, batch_size=8, seed=0)
    base = _base_engine(jax_ladder["trees"][0])
    from distributed_vgg_f_tpu_torch.data.device_ingest import \
        make_device_finish
    import torch.nn.functional as F
    with torch.inference_mode():
        t = base._model.trunk(make_device_finish(base._mean, base._std)(
            torch.from_numpy(images)))
        h6 = F.relu(base._model._dense(base._model.fc6, t))
        h7 = F.relu(base._model._dense(base._model.fc7, h6))
    for layer, x in zip(("fc6", "fc7", "fc8"), (t, h6, h7)):
        m = x.abs().amax(dim=0).numpy()
        half = want.scales[layer] / 2
        margin = np.min(np.abs(m - half)) / half
        assert margin >= 1e-3, (layer, margin)
        np.testing.assert_allclose(got.scales[layer], want.scales[layer],
                                   rtol=1e-5)
        np.testing.assert_array_equal(got.keep[layer], want.keep[layer])


def test_student_tier_from_a_jax_written_npz(jax_ladder, tmp_path):
    from distributed_vgg_f_tpu.train.distill import save_params as jsave
    from distributed_vgg_f_tpu_torch.train.distill import load_params
    path = str(tmp_path / "student.npz")
    jsave(path, jax_ladder["trees"][1])
    base = _base_engine(jax_ladder["trees"][0])
    student = tiers_mod.build_student_engine(
        base, student_model=build_model(
            ModelConfig(name="vggf_student", num_classes=CLASSES,
                        compute_dtype="float32"), image_size=SIZE),
        student_params=load_params(path))
    assert (student.tier, student.served_by) == ("student", "vggf_student")
    imgs = _images(2, seed=8)
    got, _ = student.run(imgs)
    want, _ = jax_ladder["student"].run(imgs)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


# ------------------------------------------------------------------- router
def test_per_tier_server_bitwise_equals_offline(ladder):
    server = _tier_server(ladder)
    port = server.start()
    imgs = _images(len(SERVING_TIERS), seed=3)
    try:
        for i, tier in enumerate(SERVING_TIERS):
            status, body = _post(port, "vggf", imgs[i],
                                 query=f"?tier={tier}&k={CLASSES}")
            assert status == 200 and body["tier"] == tier
            offline, bucket = ladder[tier].run(imgs[i:i + 1])
            assert body["bucket"] == bucket
            served = {r["class"]: r["prob"] for r in body["top_k"]}
            for cls, prob in enumerate(offline[0]):
                assert served[cls] == float(prob), (tier, cls)
    finally:
        server.close()


def test_unknown_tier_is_typed_400_naming_the_ladder(ladder):
    server = _tier_server(ladder)
    port = server.start()
    try:
        status, body = _post(port, "vggf", _images(1)[0],
                             query="?tier=fp64", expect_error=True)
        assert status == 400
        assert body["error"] == "bad_request"
        assert body["tier"] == "fp64"
        assert body["tiers"] == list(SERVING_TIERS)
    finally:
        server.close()


def test_batcher_isolation_per_model_tier(ladder):
    server = _tier_server(ladder)
    port = server.start()
    imgs = _images(4, seed=5)
    try:
        for _ in range(2):
            _post(port, "vggf", imgs[0], query="?tier=int8")
        _post(port, "vggf", imgs[1], query="?tier=fp32")
        batchers = server._batchers
        assert set(batchers) == {("vggf", t) for t in SERVING_TIERS}
        assert len({id(b) for b in batchers.values()}) == len(SERVING_TIERS)
        by_tier = {t: batchers[("vggf", t)].describe()
                   for t in SERVING_TIERS}
        assert by_tier["int8"]["completed_total"] == 2
        assert by_tier["fp32"]["completed_total"] == 1
        assert by_tier["bf16"]["completed_total"] == 0
        assert by_tier["student"]["completed_total"] == 0
        assert by_tier["int8"]["tier"] == "int8"
        reg = telemetry.get_registry()
        assert reg.counter_value("serving/tier_requests_int8") == 2
        assert reg.counter_value("serving/tier_requests_fp32") == 1
        assert reg.counter_value("serving/tier_requests_student") == 0
        server.refresh_gauges()
        assert reg.gauge("serving/tier_latency_p50_ms_int8") > 0
        assert reg.gauge("serving/tier_latency_p50_ms_bf16") == 0.0
    finally:
        server.close()


def test_models_table_and_ladder_receipt_report_the_ladder(ladder):
    server = _tier_server(ladder)
    port = server.start()
    try:
        _post(port, "vggf", _images(1)[0], query="?tier=int8")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/models", timeout=30) as r:
            table = json.loads(r.read())["models"]
        row = table["vggf"]
        assert row["ingest"]["wire"] == "u8" and row["tier"] == "fp32"
        assert sorted(row["tiers"]) == sorted(SERVING_TIERS)
        for tier in SERVING_TIERS:
            assert row["tiers"][tier]["tier"] == tier
        assert row["tiers"]["student"]["served_by"] == "vggf_student"
        assert row["tiers"]["int8"]["served_by"] == "vggf"
        payload = server.servingz_payload()
        assert payload["tier_default"] == "fp32"
        receipt = payload["ladder"]["vggf"]
        assert receipt == server.ladder_receipt()["vggf"]
        assert sorted(receipt) == sorted(SERVING_TIERS)
        int8_row = receipt["int8"]
        assert int8_row["warmup_s"] and all(
            s > 0 for s in int8_row["warmup_s"].values())
        # the int8 tier holds the trunk and its int8 heads: its estimate
        # counts the trunk's parameters plus extra_param_bytes
        eng = ladder["int8"]
        trunk_bytes = sum(p.numel() * 4 for n, p in
                          ladder["fp32"]._model.named_parameters()
                          if not n.startswith(("fc6.", "fc7.", "fc8.")))
        calib = eng.calibration
        k6, k7, k8 = (len(calib.keep[k]) for k in ("fc6", "fc7", "fc8"))
        int8_bytes = (k6 * k7 + k7 * 4 + k7 * 4) \
            + (k7 * k8 + k8 * 4 + k8 * 4) \
            + (k8 * CLASSES + CLASSES * 4 + CLASSES * 4)
        io = 4 * (SIZE * SIZE * 3 * 5 + CLASSES * 4)
        assert int8_row["hbm_estimate_bytes"] \
            == trunk_bytes + int8_bytes + io
        assert int8_row["hbm_estimate_bytes"] \
            < receipt["fp32"]["hbm_estimate_bytes"]
        assert receipt["bf16"]["hbm_estimate_bytes"] \
            < receipt["fp32"]["hbm_estimate_bytes"]
        assert payload["models"]["vggf"]["tiers"]["int8"]["admission"][
            "completed_total"] == 1
    finally:
        server.close()


def test_default_tier_routes_tier_default(ladder):
    server = PredictServer(_tier_cfg(tier_default="student"))
    server.add_engine(ladder["fp32"])
    server.add_engine(ladder["student"])
    port = server.start()
    try:
        status, body = _post(port, "vggf", _images(1)[0])
        assert status == 200 and body["tier"] == "student"
        status, body = _post(port, "vggf", _images(1)[0],
                             query="?tier=fp32")
        assert status == 200 and body["tier"] == "fp32"
        status, body = _post(port, "vggf", _images(1)[0],
                             query="?tier=int8", expect_error=True)
        assert status == 400 and body["tiers"] == ["fp32", "student"]
    finally:
        server.close()
    # a default the model lacks degrades to fp32
    server = PredictServer(_tier_cfg(tier_default="int8"))
    server.add_engine(ladder["fp32"])
    port = server.start()
    try:
        status, body = _post(port, "vggf", _images(1)[0])
        assert status == 200 and body["tier"] == "fp32"
    finally:
        server.close()


def test_kill_switch_tiers_disabled_is_the_fp32_surface(ladder):
    cfg = ServingConfig(enabled=True, max_batch=4, buckets=(1, 2, 4),
                        controller=False, warmup=False)
    assert cfg.tiers.enabled is False
    server = PredictServer(cfg)
    base = ladder["fp32"]
    server.add_engine(base)
    with pytest.raises(ValueError, match="serving.tiers.enabled"):
        server.add_engine(ladder["bf16"])
    assert set(server._engines) == {("vggf", "fp32")}
    port = server.start()
    img = _images(1)[0]
    try:
        status, body = _post(port, "vggf", img,
                             query=f"?tier=int8&k={CLASSES}")
        assert status == 200
        assert set(body) == {"model", "top_k", "bucket", "latency_ms"}
        offline, _ = base.run(img[None])
        served = {r["class"]: r["prob"] for r in body["top_k"]}
        assert all(served[c] == float(p)
                   for c, p in enumerate(offline[0]))
        status, _ = _post(port, "vggf", img, query="?tier=bogus")
        assert status == 200
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/models", timeout=30) as r:
            row = json.loads(r.read())["models"]["vggf"]
        assert "tiers" not in row
        payload = server.servingz_payload()
        assert "ladder" not in payload and "tier_default" not in payload
        assert "tiers" not in payload["models"]["vggf"]
    finally:
        server.close()


@pytest.mark.parametrize("kw", [
    dict(tier_default="fp16"), dict(window_min_ms=0.0),
    dict(window_min_ms=20.0, window_max_ms=10.0),
    dict(max_latency_ms=200.0), dict(controller_interval_s=0.0),
    dict(controller_k_windows=0), dict(controller_cooldown_windows=-1),
    dict(controller_relax_after_windows=-1),
    dict(queue_pressure_fraction=0.0), dict(queue_pressure_fraction=1.5),
    dict(shed_retry_after_ms=-1)])
def test_serving_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jcfg.ServingConfig(**kw)
    with pytest.raises(ValueError) as got:
        ServingConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(calibration_batches=0), dict(calibration_batch_size=0),
    dict(calibration_batches=-2), dict(calibration_batch_size=-8),
    dict(calibration_batches=0, calibration_batch_size=0)])
def test_tiers_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jcfg.ServingTiersConfig(**kw)
    with pytest.raises(ValueError) as got:
        ServingTiersConfig(**kw)
    assert str(got.value) == str(want.value)


#: JAX's accuracy contract, refused in the port until its reader, the
#: accuracy receipt (ROADMAP A16), exists
_REFUSED_TIER_FIELDS = {"max_top1_delta_bf16", "max_top1_delta_int8",
                        "max_top1_delta_student"}


def test_serving_config_defaults_match_jax():
    import dataclasses

    from distributed_vgg_f_tpu_torch.config import parse_cli
    for ours, theirs, refused in (
            (ServingConfig(), jcfg.ServingConfig(), set()),
            (ServingTiersConfig(), jcfg.ServingTiersConfig(),
             _REFUSED_TIER_FIELDS)):
        fields = {f.name for f in dataclasses.fields(theirs)}
        assert refused <= fields
        assert {f.name for f in dataclasses.fields(ours)} == fields - refused
        for name in fields - {"tiers"} - refused:
            assert getattr(ours, name) == getattr(theirs, name), name
    for name in _REFUSED_TIER_FIELDS:
        with pytest.raises(KeyError, match="ROADMAP A16"):
            parse_cli(["--set", f"serving.tiers.{name}=0.5"])


# ------------------------------------------------------- the zoo's ResNet
def _resnet(seed=2):
    rng = np.random.default_rng(seed)
    model, variables = _flax_init("resnet50", seed, stage_sizes=(1, 1))
    params = variables["params"]
    # bn3 scales small but not zero, statistics away from (0, 1), so the
    # served statistics matter
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.05, 0.15, a.shape).astype(np.float32)
                      if "bn3" in str(p) and "scale" in str(p) else a),
        params)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if "var" in str(p)
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return model, params, stats


def test_resnet_base_gets_bf16_but_no_int8():
    from distributed_vgg_f_tpu.serving import tiers as jtiers
    _, params, stats = _resnet()
    model = build_model(ModelConfig(name="resnet50", num_classes=CLASSES,
                                    compute_dtype="float32",
                                    extra={"stage_sizes": (1, 1)}),
                        image_size=SIZE)
    base = PredictEngine(model_name="resnet50",
                         model=load_params(model, params, stats),
                         image_size=SIZE, num_classes=CLASSES, max_batch=2,
                         device="cpu")
    bf16 = tiers_mod.build_bf16_engine(base)
    stats_dtypes = {b.dtype for n, b in bf16._model.named_buffers()}
    assert stats_dtypes == {torch.float32}
    imgs = _images(2, seed=9)
    got, _ = bf16.run(imgs)
    want, _ = base.run(imgs)
    assert np.max(np.abs(got - want)) < 0.05
    with pytest.raises(ValueError) as jerr:
        jtiers._split_params(params)
    with pytest.raises(ValueError, match="head stack") as err:
        tiers_mod.build_int8_engine(base)
    assert str(err.value) == str(jerr.value)


def test_serve_from_params_serves_a_resnet_with_its_statistics():
    from distributed_vgg_f_tpu.serving.engine import \
        PredictEngine as JaxEngine
    flax_model, params, stats = _resnet()
    cfg = ExperimentConfig(
        model=ModelConfig(name="resnet50", num_classes=CLASSES,
                          compute_dtype="float32",
                          extra={"stage_sizes": (1, 1)}),
        data=DataConfig(image_size=SIZE),
        serving=ServingConfig(max_batch=2, buckets=(1, 2)))
    server = serve_from_params(cfg, params, batch_stats=stats, device="cpu")
    jax_engine = JaxEngine(model_name="resnet50", model=flax_model,
                           params=params, batch_stats=stats,
                           image_size=SIZE, num_classes=CLASSES,
                           buckets=(1,), max_batch=1)
    try:
        for img in _images(2, seed=12):
            want, _ = jax_engine.run(img[None])
            status, body = _post(server.port, "resnet50", img,
                                 query=f"?k={CLASSES}")
            assert status == 200
            got = np.zeros(CLASSES)
            for rec in body["top_k"]:
                got[rec["class"]] = rec["prob"]
            np.testing.assert_allclose(got, np.asarray(want[0]), rtol=0,
                                       atol=1e-5)
    finally:
        server.close()

"""The port's serving plane (distributed_vgg_f_tpu_torch/serving/) against
the JAX package's engine on the same weights, and its HTTP contract:
200 responses bitwise equal to the engine's own run through the same
bucket, typed 400/503, drain on close — at 32 px on the CPU
(``device="cpu"``).

Tolerance port vs JAX engine: probabilities within 1e-5 in fp32 (logits
agree to ~1e-6 at 32 px; the softmax of 10 classes keeps that scale)."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu_torch import telemetry
from distributed_vgg_f_tpu_torch.config import (DataConfig, ExperimentConfig,
                                                ModelConfig, ServingConfig,
                                                get_config,
                                                resolve_serving_buckets)
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.serving.batcher import (DynamicBatcher,
                                                         OverloadShed)
from distributed_vgg_f_tpu_torch.serving.engine import (PredictEngine,
                                                        build_engine)
from distributed_vgg_f_tpu_torch.serving.server import (PredictServer,
                                                        serve_from_params)
from distributed_vgg_f_tpu_torch.weights import load_params

SIZE, CLASSES = 32, 10


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def flax_tree():
    from distributed_vgg_f_tpu.config import ModelConfig as JaxModelConfig
    from distributed_vgg_f_tpu.models.registry import build_model as jbuild
    model = jbuild(JaxModelConfig(name="vggf", num_classes=CLASSES,
                                  compute_dtype="float32"))
    x0 = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x0, train=False)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_engine(tree, buckets=(1, 2, 4), max_batch=4):
    model = build_model(ModelConfig(num_classes=CLASSES,
                                    compute_dtype="float32"),
                        image_size=SIZE)
    load_params(model, tree)
    return PredictEngine(model_name="vggf", model=model, image_size=SIZE,
                         num_classes=CLASSES, buckets=buckets,
                         max_batch=max_batch, device="cpu")


def _jax_engine(flax_model, tree, buckets=(1, 2, 4), max_batch=4):
    from distributed_vgg_f_tpu.serving.engine import \
        PredictEngine as JaxEngine
    return JaxEngine(model_name="vggf", model=flax_model, params=tree,
                     batch_stats={}, image_size=SIZE, num_classes=CLASSES,
                     buckets=buckets, max_batch=max_batch)


def _images(n, size=SIZE, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3)).astype(np.uint8)


def _post(port, model, image, timeout=30, k=None):
    url = f"http://127.0.0.1:{port}/v1/predict/{model}"
    if k is not None:
        url += f"?k={k}"
    req = urllib.request.Request(url, data=image.tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _cfg(**kw):
    kw.setdefault("warmup", False)
    return ServingConfig(**kw)


class _SlowEngine:
    """Delegating wrapper whose every run takes `delay_s` longer."""

    def __init__(self, engine, delay_s):
        self._engine = engine
        self.delay_s = delay_s

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def run(self, images):
        time.sleep(self.delay_s)
        return self._engine.run(images)


# ------------------------------------------------------------------ config
def test_bucket_ladder_and_config_validation():
    assert resolve_serving_buckets((), 32) == (1, 2, 4, 8, 16, 32)
    assert resolve_serving_buckets((), 6) == (1, 2, 4, 6)
    with pytest.raises(ValueError, match="cover max_batch"):
        resolve_serving_buckets((1, 2), 4)
    with pytest.raises(ValueError, match="ascending"):
        ServingConfig(buckets=(4, 2), max_batch=4)
    with pytest.raises(ValueError, match="queue_limit"):
        ServingConfig(queue_limit=0)
    flagship = get_config("vggf_imagenet_dp")
    assert flagship.model.compute_dtype == "bfloat16"
    assert (flagship.data.image_size, flagship.model.num_classes) \
        == (224, 1000)
    assert resolve_serving_buckets(flagship.serving.buckets,
                                   flagship.serving.max_batch) \
        == (1, 2, 4, 8, 16, 32)


def test_config_matches_jax_defaults():
    from distributed_vgg_f_tpu import config as jcfg
    jax_serving = jcfg.ServingConfig()
    for name in ServingConfig.__dataclass_fields__:
        ours, theirs = getattr(ServingConfig(), name), \
            getattr(jax_serving, name)
        if dataclasses.is_dataclass(ours):  # the tiers section, field-wise
            # less JAX's accuracy contract, refused in the port (A16)
            ours, theirs = dataclasses.asdict(ours), {
                k: v for k, v in dataclasses.asdict(theirs).items()
                if not k.startswith("max_top1_delta_")}
        assert ours == theirs, name
    jax_data = jcfg.get_config("vggf_imagenet_dp").data
    ours = get_config("vggf_imagenet_dp").data
    assert tuple(ours.mean_rgb) == tuple(jax_data.mean_rgb)
    assert tuple(ours.stddev_rgb) == tuple(jax_data.stddev_rgb)
    assert ours.image_dtype == jax_data.image_dtype


# ------------------------------------------------------------------ engine
def test_engine_probs_match_jax_engine(flax_tree):
    flax_model, tree = flax_tree
    ours, theirs = _port_engine(tree), _jax_engine(flax_model, tree)
    assert ours.buckets == theirs.buckets == (1, 2, 4)
    for n in (1, 2, 3, 4):
        imgs = _images(n, seed=n)
        got, got_bucket = ours.run(imgs)
        want, want_bucket = theirs.run(imgs)
        assert got_bucket == want_bucket and got.shape == (n, CLASSES)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_engine_pads_with_zeros_and_slices(flax_tree):
    engine = _port_engine(flax_tree[1])
    imgs = _images(3, seed=9)
    probs, bucket = engine.run(imgs)
    assert bucket == 4 and probs.shape == (3, CLASSES)
    padded = np.concatenate([imgs, np.zeros((1, SIZE, SIZE, 3), np.uint8)])
    full, _ = engine.run(padded)
    np.testing.assert_array_equal(probs, full[:3])
    with pytest.raises(ValueError, match="exceeds the top bucket"):
        engine.run(_images(5))


def test_engine_warmup_and_describe(flax_tree):
    engine = _port_engine(flax_tree[1])
    assert engine.warmup() == 3
    row = engine.describe()
    assert row["warm_buckets"] == [1, 2, 4]
    assert all(s > 0 for s in row["warmup_s"].values())
    assert row["payload_bytes"] == SIZE * SIZE * 3
    assert row["hbm_estimate_bytes"] > 4 * sum(
        a.size for layer in flax_tree[1].values() for a in layer.values())
    assert row["ingest"]["model"] == "vggf"
    json.dumps(row)


def test_build_engine_seeded_init_and_npz(tmp_path, flax_tree):
    a = build_engine("vggf", SIZE, CLASSES, (1, 2), 2, device="cpu",
                     compute_dtype="float32", seed=5)
    b = build_engine("vggf", SIZE, CLASSES, (1, 2), 2, device="cpu",
                     compute_dtype="float32", seed=5)
    imgs = _images(2, seed=3)
    np.testing.assert_array_equal(a.run(imgs)[0], b.run(imgs)[0])
    tree = flax_tree[1]
    path = tmp_path / "w.npz"
    np.savez(path, **{f"{layer}/{leaf}": tree[layer][leaf]
                      for layer in tree for leaf in tree[layer]})
    from_npz = build_engine("vggf", SIZE, CLASSES, (1, 2), 2,
                            weights=str(path), device="cpu",
                            compute_dtype="float32")
    np.testing.assert_array_equal(from_npz.run(imgs)[0],
                                  _port_engine(tree).run(imgs)[0])


# ----------------------------------------------------------------- batcher
def test_drain_answers_inflight_then_refuses(flax_tree):
    engine = _SlowEngine(_port_engine(flax_tree[1]), delay_s=0.05)
    batcher = DynamicBatcher(engine, max_batch=2, window_ms=30,
                             queue_limit=16)
    pendings = [batcher.submit(img) for img in _images(5)]
    batcher.close()
    for p in pendings:
        assert p.event.is_set() and p.probs is not None and p.error is None
    with pytest.raises(OverloadShed) as err:
        batcher.submit(_images(1)[0])
    assert err.value.kind == "draining"


def test_burst_flushes_full_batch_and_reaps_expired(flax_tree):
    engine = _SlowEngine(_port_engine(flax_tree[1], buckets=(1,),
                                      max_batch=1), delay_s=0.3)
    batcher = DynamicBatcher(engine, max_batch=1, window_ms=1,
                             queue_limit=16, reap_after_s=0.15)
    try:
        pendings = [batcher.submit(img) for img in _images(4)]
        for p in pendings:
            assert p.event.wait(30)
        assert pendings[0].error is None and pendings[0].probs is not None
        reaped = [p for p in pendings if isinstance(p.error, TimeoutError)]
        assert reaped and all(p.probs is None for p in reaped)
        assert batcher.describe()["reaped_total"] == len(reaped)
    finally:
        batcher.close()


# ------------------------------------------------------------------ server
def test_server_200_bitwise_equals_engine_run(flax_tree):
    engine = _port_engine(flax_tree[1], buckets=(1,), max_batch=1)
    server = PredictServer(_cfg(max_batch=1, buckets=(1,)))
    server.add_engine(engine)
    port = server.start()
    try:
        for img in _images(3, seed=11):
            status, body = _post(port, "vggf", img, k=3)
            assert status == 200 and body["bucket"] == 1
            probs, _ = engine.run(img[None])
            order = np.argsort(probs[0])[::-1][:3]
            assert [r["class"] for r in body["top_k"]] == order.tolist()
            assert [r["prob"] for r in body["top_k"]] \
                == [float(probs[0][c]) for c in order]
        reg = telemetry.get_registry()
        assert reg.counter_value("serving/batches") == 3
        flushes = [sp for sp in telemetry.get_recorder().snapshot()
                   if sp[0] == "serving_flush_vggf"]
        assert len(flushes) == 3
        assert all(sp[1] == "dispatch" and sp[3] > 0 for sp in flushes)
        assert reg.counter_value("serving/admitted") == 3
        server.refresh_gauges()
        assert reg.gauge("serving/latency_p50_ms") > 0
    finally:
        server.close()


def test_bad_size_and_unknown_model_are_400(flax_tree):
    server = PredictServer(_cfg(max_batch=2, buckets=(1, 2)))
    server.add_engine(_port_engine(flax_tree[1], buckets=(1, 2),
                                   max_batch=2))
    port = server.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "vggf", np.zeros((8, 8, 3), np.uint8))
        assert err.value.code == 400
        assert json.loads(err.value.read())["error"] == "bad_request"
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "nope", _images(1)[0])
        assert err.value.code == 400
        assert json.loads(err.value.read())["models"] == ["vggf"]
        url = f"http://127.0.0.1:{port}/v1/models"
        with urllib.request.urlopen(url, timeout=30) as r:
            rows = json.loads(r.read())["models"]
        assert rows["vggf"]["buckets"] == [1, 2]
        assert rows["vggf"]["device"] == "cpu"
    finally:
        server.close()


def test_full_queue_sheds_typed_503(flax_tree):
    engine = _SlowEngine(_port_engine(flax_tree[1], buckets=(1, 2),
                                      max_batch=2), delay_s=0.15)
    server = PredictServer(_cfg(max_batch=2, buckets=(1, 2),
                                max_latency_ms=5.0, queue_limit=3,
                                shed_retry_after_ms=25))
    server.add_engine(engine)
    port = server.start()
    statuses, sheds = [], []
    lock = threading.Lock()

    def post():
        try:
            status, payload = _post(port, "vggf", _images(1)[0])
        except urllib.error.HTTPError as e:
            status, payload = e.code, json.loads(e.read())
            if status == 503:
                assert e.headers.get("Retry-After") == "1"
        with lock:
            statuses.append(status)
            if status == 503:
                sheds.append(payload)

    try:
        threads = [threading.Thread(target=post) for _ in range(14)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert statuses.count(200) >= 3 and len(sheds) >= 3
        assert statuses.count(200) + len(sheds) == 14
        for payload in sheds:
            assert payload["error"] == "overloaded"
            assert payload["kind"] == "shed"
            assert payload["queue_limit"] == 3
            assert payload["queue_depth"] <= 3
            assert payload["retry_after_ms"] == 25
        assert telemetry.get_registry().counter_value("serving/shed") \
            == len(sheds)
        assert server.batcher("vggf").describe()["queue_peak"] <= 3
    finally:
        server.close()


def test_close_drains_inflight_requests(flax_tree):
    engine = _SlowEngine(_port_engine(flax_tree[1], buckets=(1, 2),
                                      max_batch=2), delay_s=0.2)
    server = PredictServer(_cfg(max_batch=2, buckets=(1, 2),
                                max_latency_ms=5.0, queue_limit=16))
    server.add_engine(engine)
    port = server.start()
    statuses = []
    threads = [threading.Thread(
        target=lambda: statuses.append(_post(port, "vggf",
                                             _images(1)[0])[0]))
        for _ in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while telemetry.get_registry().counter_value("serving/admitted") < 4:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    server.close()
    for t in threads:
        t.join(timeout=30)
    assert statuses == [200] * 4
    assert server.port is None


def test_slice_u8_in_topk_out_reproduces_jax_top1(flax_tree):
    """The slice as a whole: u8 payloads over HTTP through
    serve_from_params, top-k out, the JAX engine's top-1 reproduced."""
    flax_model, tree = flax_tree
    cfg = ExperimentConfig(
        name="slice", model=ModelConfig(num_classes=CLASSES,
                                        compute_dtype="float32"),
        data=DataConfig(image_size=SIZE),
        serving=ServingConfig(max_batch=4, buckets=(1, 2, 4)))
    server = serve_from_params(cfg, tree, device="cpu")
    imgs = _images(6, seed=21)
    reference = _jax_engine(flax_model, tree, buckets=(1,), max_batch=1)
    try:
        assert server.engine("vggf").describe()["warm_buckets"] == [1, 2, 4]
        for img in imgs:
            want, _ = reference.run(img[None])
            status, body = _post(server.port, "vggf", img, k=CLASSES)
            assert status == 200
            assert body["top_k"][0]["class"] == int(np.argmax(want[0]))
            got = np.zeros(CLASSES)
            for rec in body["top_k"]:
                got[rec["class"]] = rec["prob"]
            np.testing.assert_allclose(got, want[0], rtol=0, atol=1e-5)
    finally:
        server.close()


# ------------------------------------------------------------- device rule
def test_engine_on_cpu_stays_on_cpu(flax_tree):
    engine = _port_engine(flax_tree[1])
    assert engine.device == torch.device("cpu")
    assert all(p.device.type == "cpu"
               for p in engine._model.parameters())

"""The port (distributed_vgg_f_tpu_torch) stands alone: importing every
module of it (the stall attribution, the ingest autotuner, the
snapshot cache and the zoo's VGG-16, ResNet and BatchNorm included)
pulls in no jax, no flax and nothing of the JAX
package (distributed_vgg_f_tpu), no source file imports them, the scripts that
run on the card import none of them either, and the entry points refuse
to run without CUDA unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "distributed_vgg_f_tpu_torch"
PORT_DIR = os.path.join(REPO, PORT)


def forbidden(module: str) -> bool:
    """jax/flax/the JAX package, by exact name or dotted prefix — never a
    bare prefix test: the port's own name starts with the JAX package's."""
    for root in ("jax", "jaxlib", "flax", "distributed_vgg_f_tpu"):
        if module == root or module.startswith(root + "."):
            return True
    return False


def _port_modules():
    mods = []
    for dirpath, dirnames, files in os.walk(PORT_DIR):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            mods.append(".".join(parts))
    return sorted(mods)


def test_forbidden_predicate_compares_exact_names():
    assert forbidden("jax") and forbidden("jax.numpy")
    assert forbidden("flax.linen") and forbidden("distributed_vgg_f_tpu")
    assert forbidden("distributed_vgg_f_tpu.ops.lrn")
    assert not forbidden(PORT) and not forbidden(PORT + ".ops.lrn")
    assert not forbidden("jaxtyping_like") and not forbidden("flaxen")


def test_importing_every_port_module_pulls_in_no_jax():
    mods = _port_modules()
    assert f"{PORT}.serving.server" in mods and f"{PORT}.ops.lrn_cuda" in mods
    assert {f"{PORT}.train.trainer", f"{PORT}.train.step",
            f"{PORT}.data.augment", f"{PORT}.resilience.guard",
            f"{PORT}.utils.meter", f"{PORT}.models.vit",
            f"{PORT}.ops.flash_attention", f"{PORT}.ops.flash_cuda",
            f"{PORT}.parallel.distributed", f"{PORT}.parallel.collectives",
            f"{PORT}.parallel.ring_attention", f"{PORT}.parallel.ring_flash",
            f"{PORT}.parallel.ulysses", f"{PORT}.data.native_build",
            f"{PORT}.data.native_tfrecord", f"{PORT}.data.native_jpeg",
            f"{PORT}.data.imagenet", f"{PORT}.data.iterator_state",
            f"{PORT}.data.prefetch", f"{PORT}.resilience.errors",
            f"{PORT}.telemetry.schema", f"{PORT}.cli",
            f"{PORT}.parallel.preempt", f"{PORT}.utils.logging",
            f"{PORT}.train.predict", f"{PORT}.telemetry.stall",
            f"{PORT}.data.autotune",
            f"{PORT}.data.snapshot_cache", f"{PORT}.models.vgg16",
            f"{PORT}.models.resnet", f"{PORT}.ops.batch_norm"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    assert [m for m in loaded if forbidden(m)] == []


def test_no_source_file_imports_jax_or_the_jax_package():
    offenders = []
    for mod in _port_modules():
        path = os.path.join(REPO, *mod.split("."))
        path = os.path.join(path, "__init__.py") if os.path.isdir(path) \
            else path + ".py"
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [(mod, n) for n in names if forbidden(n)]
    assert offenders == []


def test_the_snapshot_cache_and_the_decoder_surface_run_without_jax(
        tmp_path):
    """A store written, read back and keyed, the shuffle mirror and the
    decoder's receipts, in a process that imports nothing else."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        f"from {PORT}.data import native_jpeg, snapshot_cache as sc\n"
        f"store = sc.SnapshotStore({str(tmp_path)!r}, 'g', 1 << 20, 1)\n"
        "crop = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)\n"
        "assert store.write(0, crop, (1, 2, -1, 0)) and store.complete\n"
        "assert (store.read(0, (1, 2, -1, 0)) == crop).all()\n"
        "assert sorted(sc.shuffle_indices(5, 0, 1)) == list(range(5))\n"
        "sc.params_key(n_items=1, files=[], image_size=4,\n"
        "              image_dtype='uint8', mean=(0, 0, 0),\n"
        "              std=(1, 1, 1), area_range=(0.08, 1.0), seed=0)\n"
        "native_jpeg.decode_stats()\n"
        "native_jpeg.restart_kind()\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert f"{PORT}.data.snapshot_cache" in loaded
    assert [m for m in loaded if forbidden(m)] == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_engine_refuses_without_cuda(no_cuda):
    from distributed_vgg_f_tpu_torch.serving.engine import build_engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine("vggf", 32, 10, (1,), 1)


def test_predict_engine_refuses_without_cuda(no_cuda):
    from distributed_vgg_f_tpu_torch.config import ModelConfig
    from distributed_vgg_f_tpu_torch.models.registry import build_model
    from distributed_vgg_f_tpu_torch.serving.engine import PredictEngine
    model = build_model(ModelConfig(num_classes=10), image_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictEngine(model_name="vggf", model=model, image_size=32,
                      num_classes=10, buckets=(1,), max_batch=1)


def test_serve_from_params_refuses_without_cuda(no_cuda):
    from distributed_vgg_f_tpu_torch.config import (DataConfig,
                                                    ExperimentConfig,
                                                    ModelConfig,
                                                    ServingConfig)
    from distributed_vgg_f_tpu_torch.serving.server import serve_from_params
    from distributed_vgg_f_tpu_torch.weights import init_params
    model_cfg = ModelConfig(num_classes=10)
    cfg = ExperimentConfig(model=model_cfg, data=DataConfig(image_size=32),
                           serving=ServingConfig(max_batch=1))
    params = init_params(model_cfg, 0, image_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_from_params(cfg, params)


def test_trainer_and_train_step_refuse_without_cuda(no_cuda):
    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.train.step import build_train_step
    from distributed_vgg_f_tpu_torch.train.trainer import Trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_config("vggf_teacher"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(lambda step: 0.1, 0.0)
    assert Trainer(get_config("vggf_teacher"), device="cpu").device.type \
        == "cpu"


def test_host_stage_refuses_the_card_without_cuda(no_cuda):
    """The host read-ahead stage pins its buffers only for a card; asked
    for one without CUDA it raises instead of pinning nothing."""
    from distributed_vgg_f_tpu_torch.data.prefetch import \
        HostPrefetchIterator
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HostPrefetchIterator(iter([]), device="cuda")
    hp = HostPrefetchIterator(iter([]), device="cpu")
    assert not hp.lends_buffers
    hp.close()


def test_cli_refuses_without_cuda(no_cuda):
    """The console runs on the card; only library callers pass
    device="cpu"."""
    from distributed_vgg_f_tpu_torch import cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", "vggf_teacher", "--set", "train.steps=1"])


def test_initialize_distributed_refuses_nccl_without_cuda(no_cuda):
    """A group on the card needs CUDA; without it the call raises before
    it starts anything. A single process given nothing is a no-op."""
    from distributed_vgg_f_tpu_torch.parallel.distributed import \
        initialize_distributed
    assert initialize_distributed() is False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed("localhost:1", 2, 0)
    assert not torch.distributed.is_initialized()


def test_explicit_cpu_runs(no_cuda):
    from distributed_vgg_f_tpu_torch.serving.engine import build_engine
    engine = build_engine("vggf", 32, 10, (1,), 1, device="cpu",
                          compute_dtype="float32")
    probs, bucket = engine.run(np.zeros((1, 32, 32, 3), np.uint8))
    assert bucket == 1 and np.isfinite(probs).all()


@pytest.mark.parametrize("model", ["vgg16", "resnet50"])
def test_zoo_engines_refuse_without_cuda_and_run_on_the_cpu_when_asked(
        no_cuda, model):
    from distributed_vgg_f_tpu_torch.serving.engine import build_engine
    extra = {"stage_sizes": (1,)} if model == "resnet50" else {
        "block_sizes": (1, 1), "block_features": (4, 8)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(model, 32, 10, (1,), 1, extra=extra)
    engine = build_engine(model, 32, 10, (1,), 1, device="cpu",
                          compute_dtype="float32", extra=extra)
    probs, bucket = engine.run(np.zeros((1, 32, 32, 3), np.uint8))
    assert bucket == 1 and np.isfinite(probs).all()


def test_the_zoo_worker_imports_no_jax():
    """tests/_torch_zoo_worker.py runs the four-card case on the card's
    machine."""
    path = os.path.join(REPO, "tests", "_torch_zoo_worker.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert [n for n in names if forbidden(n)] == []


def test_unknown_device_is_refused():
    from distributed_vgg_f_tpu_torch.device import resolve_device
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_flagship_probe_imports_no_jax_and_refuses_without_cuda():
    """tools/torch_flagship_probe.py runs on the card's machine too."""
    path = os.path.join(REPO, "tools", "torch_flagship_probe.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert [n for n in names if forbidden(n)] == []
    out = subprocess.run([sys.executable, "-m", "tools.torch_flagship_probe",
                          "--part", "hostwait"], cwd=REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and out.stdout == "", out.stderr


@pytest.mark.parametrize("tool", ["torch_zoo_probe", "torch_zero2_repeat"])
def test_card_tools_import_no_jax_and_refuse_without_cuda(tool):
    """The card's tools run on its machine, where JAX is not installed:
    they import nothing of it, and without a CUDA device they exit 1
    before printing anything."""
    path = os.path.join(REPO, "tools", tool + ".py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert [n for n in names if forbidden(n)] == []
    out = subprocess.run([sys.executable, "-m", "tools." + tool], cwd=REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and out.stdout == "", out.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py", "train_profile.py"])
def test_card_scripts_import_no_jax_and_refuse_without_cuda(script):
    """The scripts run on the card's machine, where JAX is not installed:
    they import nothing of it, and without a CUDA device they exit 2
    before printing any result."""
    path = os.path.join(REPO, script)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert [n for n in names if forbidden(n)] == []
    out = subprocess.run([sys.executable, path], cwd=REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == "", out.stderr

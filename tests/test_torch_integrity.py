"""The port's checkpoint manifests (distributed_vgg_f_tpu_torch/resilience/
integrity.py) against the JAX package's resilience/integrity.py on the
same files: equal manifest JSON, each package verifies the other's
manifest, and a truncated file, a flipped byte and a missing file each
verify False in both."""

import json
import os
import shutil

import pytest

from distributed_vgg_f_tpu.resilience import integrity as jint
from distributed_vgg_f_tpu_torch.resilience import integrity as pint

STEP = 7


@pytest.fixture(autouse=True)
def _remove_what_the_test_wrote(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def root(tmp_path):
    base = tmp_path / str(STEP)
    (base / "state" / "params" / "conv1").mkdir(parents=True)
    (base / "state" / "params" / "conv1" / "kernel.npy").write_bytes(
        bytes(range(256)) * 9)
    (base / "state" / "step.npy").write_bytes(b"\x93NUMPY step")
    (base / "extra.json").write_text('{"examples_seen": 28}')
    return str(tmp_path)


def _manifest(root):
    with open(pint.manifest_path(root, STEP)) as f:
        return json.load(f)


def test_manifests_are_equal_json_and_cross_verify(root):
    jint.write_step_manifest(root, STEP)
    want = _manifest(root)
    assert pint.verify_step_manifest(root, STEP) == (True, "ok")
    pint.write_step_manifest(root, STEP)
    assert _manifest(root) == want
    assert set(want["files"]) == {"state/params/conv1/kernel.npy",
                                  "state/step.npy", "extra.json"}
    assert jint.verify_step_manifest(root, STEP) == (True, "ok")
    assert pint.step_size_bytes(root, STEP) == jint.step_size_bytes(
        root, STEP)
    assert pint.list_manifest_steps(root) == [STEP]
    pint.remove_step_manifest(root, STEP)
    assert pint.verify_step_manifest(root, STEP) == (None, "no manifest")
    assert jint.verify_step_manifest(root, STEP) == (None, "no manifest")


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _flip(path):
    with open(path, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0x01]))


@pytest.mark.parametrize("damage,detail", [
    (_truncate, "size mismatch"), (_flip, "checksum mismatch"),
    (os.remove, "missing file")])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_damage_verifies_false_in_both(root, damage, detail, writer):
    (pint if writer == "port" else jint).write_step_manifest(root, STEP)
    damage(os.path.join(pint.step_dir(root, STEP), "state", "params",
                        "conv1", "kernel.npy"))
    for mod in (pint, jint):
        verdict, why = mod.verify_step_manifest(root, STEP)
        assert verdict is False and why.startswith(detail), why


def test_the_writers_manifest_equals_jax_s_of_its_files(tmp_path):
    """The manager hashes each file as it writes it; its manifest is the
    one JAX's write_step_manifest makes by reading the files back, and
    JAX's verify_step_manifest accepts it."""
    import numpy as np

    from distributed_vgg_f_tpu_torch.checkpoint.manager import \
        CheckpointManager
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root)
    assert mgr.save({"step": np.asarray(STEP, np.int32),
                     "params/conv1/kernel": np.linspace(
                         -1, 1, 3 * 5 * 7, dtype=np.float32).reshape(3, 5, 7),
                     "opt/count": np.asarray(3, np.int32)},
                    extra={"examples_seen": 28}, force=True)
    mgr.close()
    written = _manifest(root)
    assert jint.verify_step_manifest(root, STEP) == (True, "ok")
    jint.write_step_manifest(root, STEP)
    assert _manifest(root) == written
    assert set(written["files"]) == {
        "state/step.npy", "state/params/conv1/kernel.npy",
        "state/opt/count.npy", "extra.json"}

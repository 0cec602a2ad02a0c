"""The port's LRN (distributed_vgg_f_tpu_torch/ops/lrn.py) against the JAX
package's oracle and its Pallas kernel (run in the Pallas interpreter on
the CPU), plus the dispatch and build contracts of the Hopper kernel
wrapper (ops/lrn_cuda.py).

Tolerances: fp32 rtol 2e-5 / atol 1e-6 — the oracle divides by
d**beta while the port multiplies by d**-beta through rsqrt/sqrt (the
JAX package measures its own forms within 2e-5 of each other); bf16 in
and out rtol 1e-2 — both sides compute in fp32 and round once to bf16, so
they differ by at most one bf16 ulp (2**-7 relative at worst)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_vgg_f_tpu.ops.lrn_pallas as lrn_pallas
from distributed_vgg_f_tpu.ops.lrn import local_response_norm as jax_oracle
from distributed_vgg_f_tpu.ops.lrn_pallas import local_response_norm_pallas
from distributed_vgg_f_tpu_torch.kernels import build
from distributed_vgg_f_tpu_torch.ops import lrn_cuda
from distributed_vgg_f_tpu_torch.ops.lrn import local_response_norm, lrn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [(c, alpha_scaled, beta)
         for c in (64, 256, 5)
         for alpha_scaled in (False, True)
         for beta in (0.75, 0.5, 0.6)]


@pytest.fixture(autouse=True)
def _interpret_mode():
    prev = lrn_pallas.INTERPRET
    lrn_pallas.INTERPRET = jax.default_backend() != "tpu"
    yield
    lrn_pallas.INTERPRET = prev


def _input(c, seed=0, shape=(2, 5, 7)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (c,)) * 3.0).astype(np.float32)


@pytest.mark.parametrize("c,alpha_scaled,beta", CASES)
def test_plain_lrn_matches_jax_oracle_fp32(c, alpha_scaled, beta):
    x = _input(c)
    want = np.asarray(jax_oracle(jnp.asarray(x), 2, 2.0, 1e-4, beta,
                                 alpha_scaled=alpha_scaled))
    got = local_response_norm(torch.from_numpy(x), 2, 2.0, 1e-4, beta,
                              alpha_scaled=alpha_scaled).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("c,alpha_scaled,beta", CASES)
def test_plain_lrn_matches_pallas_interpret_fp32(c, alpha_scaled, beta):
    x = _input(c, seed=1, shape=(3, 3, 5))
    want = np.asarray(local_response_norm_pallas(
        jnp.asarray(x), 2, 2.0, 1e-4, beta, alpha_scaled=alpha_scaled))
    got = local_response_norm(torch.from_numpy(x), 2, 2.0, 1e-4, beta,
                              alpha_scaled=alpha_scaled).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("c", [64, 256, 5])
def test_plain_lrn_matches_jax_oracle_bf16(c):
    x = _input(c, seed=2)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_oracle(xj).astype(jnp.float32))
    xt = torch.from_numpy(x).bfloat16()
    got = local_response_norm(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-6)


def test_plain_lrn_wide_radius_matches_oracle():
    x = _input(7, seed=3)
    want = np.asarray(jax_oracle(jnp.asarray(x), depth_radius=4))
    got = local_response_norm(torch.from_numpy(x), depth_radius=4).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_dispatch_on_cpu_runs_plain_and_never_counts():
    lrn_cuda.LAUNCHES = 0
    x = torch.from_numpy(_input(64, seed=4))
    assert torch.equal(lrn(x), local_response_norm(x))
    assert lrn_cuda.LAUNCHES == 0


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        lrn_cuda.local_response_norm_cuda(torch.zeros(1, 2, 2, 8))
    assert lrn_cuda.LAUNCHES == 0


def test_kernel_modules_import_without_nvcc():
    """Importing the wrapper and the build module needs no nvcc (the CPU
    tests import every module); only a build does."""
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=REPO)
    code = ("import distributed_vgg_f_tpu_torch.ops.lrn_cuda as m\n"
            "import distributed_vgg_f_tpu_torch.kernels.build as b\n"
            "print(m.LAUNCHES, b.sources())\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "['flash_block_dkv',",
                                  "'flash_block_dq',", "'flash_block_fwd',",
                                  "'flash_dkv',", "'flash_dq',",
                                  "'flash_fwd',", "'lrn_bwd',", "'lrn_fwd']"]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all(["lrn_fwd"])


def test_library_path_keyed_by_source_hash():
    path = build.library_path("lrn_fwd")
    assert path.startswith(build.BUILD_DIR)
    assert os.path.basename(path).startswith("lrn_fwd-")
    assert path == build.library_path("lrn_fwd")

"""The port's LRN (distributed_vgg_f_tpu_torch/ops/lrn.py) against the JAX
package's oracle and its Pallas kernel (run in the Pallas interpreter on
the CPU), the ReLU fused into it (`relu_lrn`) against JAX's `nn.relu`
then the Pallas kernel, plus the dispatch, variant and build contracts of
the Hopper kernel wrapper (ops/lrn_cuda.py).

Tolerances: fp32 rtol 2e-5 / atol 1e-6 — the oracle divides by
d**beta while the port multiplies by d**-beta through rsqrt/sqrt (the
JAX package measures its own forms within 2e-5 of each other); bf16 in
and out rtol 1e-2 — both sides compute in fp32 and round once to bf16, so
they differ by at most one bf16 ulp (2**-7 relative at worst).

The fp32 oracle comes from `_oracle`: JAX's function compiled as one
executable under a name of this file's own, so the persistent compile
cache the suite shares (tests/conftest.py) keys it apart from every other
file's op-by-op primitives, on a copy of the input, returned as an owned
array, and held to the same formula in float64 numpy before the port is
compared with it: a reference that moves fails as the oracle's, not as the
port's. The port's side is correctly rounded division, sqrt and rsqrt on
the calling thread."""

import functools
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
from distributed_vgg_f_tpu_torch.ops.lrn import (local_response_norm, lrn,
                                                 relu_local_response_norm,
                                                 relu_lrn)

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


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _port_test_lrn_oracle(x, depth_radius, bias, alpha, beta, alpha_scaled):
    return jax_oracle(x, depth_radius, bias, alpha, beta,
                      alpha_scaled=alpha_scaled)


def _float64_lrn(x, depth_radius, bias, alpha, beta, alpha_scaled):
    """The oracle's formula in float64 numpy."""
    n = 2 * depth_radius + 1
    a = alpha / n if alpha_scaled else alpha
    xd = x.astype(np.float64)
    pad = np.pad(xd * xd, [(0, 0)] * (x.ndim - 1)
                 + [(depth_radius, depth_radius)])
    sums = sum(pad[..., k:k + x.shape[-1]] for k in range(n))
    return xd / (bias + a * sums) ** beta


def _oracle(x, depth_radius=2, bias=2.0, alpha=1e-4, beta=0.75,
            alpha_scaled=False):
    """JAX's fp32 oracle on a copy of `x`, as an owned array, held to its
    formula in float64 at the fp32 tolerance."""
    args = (depth_radius, bias, alpha, beta, alpha_scaled)
    want = np.array(_port_test_lrn_oracle(jnp.array(x), *args))
    np.testing.assert_allclose(want, _float64_lrn(x, *args), rtol=2e-5,
                               atol=1e-6, err_msg="the JAX oracle moved")
    return want


@pytest.mark.parametrize("c,alpha_scaled,beta", CASES)
def test_plain_lrn_matches_jax_oracle_fp32(c, alpha_scaled, beta):
    x = _input(c)
    want = _oracle(x, beta=beta, alpha_scaled=alpha_scaled)
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
    want = _oracle(x, depth_radius=4)
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


# ------------------------------------------------- ReLU fused into the LRN
def _z(c, seed, shape=(2, 5, 7)):
    """Pre-activations with negatives and exact zeros (every fifth)."""
    z = _input(c, seed=seed, shape=shape)
    z.reshape(-1)[::5] = 0.0
    return z


@pytest.mark.parametrize("c", [5, 64, 256])
def test_relu_lrn_matches_jax_relu_then_pallas_fp32(c):
    z = _z(c, seed=10)
    want = np.asarray(local_response_norm_pallas(jax.nn.relu(jnp.asarray(z))))
    got = relu_lrn(torch.from_numpy(z))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)
    assert (got.numpy()[z <= 0] == 0).all()


@pytest.mark.parametrize("c", [5, 64, 256])
def test_relu_lrn_matches_jax_relu_then_pallas_bf16(c):
    z = _z(c, seed=11)
    zj = jnp.asarray(z).astype(jnp.bfloat16)
    want = np.asarray(local_response_norm_pallas(jax.nn.relu(zj))
                      .astype(jnp.float32))
    got = relu_lrn(torch.from_numpy(z).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-6)


def test_relu_lrn_plain_is_lrn_of_relu_exactly():
    z = torch.from_numpy(_z(64, seed=12))
    assert torch.equal(relu_local_response_norm(z),
                       local_response_norm(torch.relu(z)))
    assert torch.equal(relu_lrn(z), relu_local_response_norm(z))


def test_relu_lrn_on_cpu_never_counts_kernel_launches():
    lrn_cuda.LAUNCHES = lrn_cuda.VEC_LAUNCHES = 0
    relu_lrn(torch.from_numpy(_z(256, seed=13)))
    assert lrn_cuda.LAUNCHES == 0 and lrn_cuda.VEC_LAUNCHES == 0


# ---------------------------------------------- the kernel variant rule
@pytest.mark.parametrize("shape,dtype,radius,want", [
    # VGG-F's two sites, bf16 (serve, train) and fp32 (reference checks)
    ((1024, 54, 54, 64), torch.bfloat16, 2, "vector"),
    ((1024, 27, 27, 256), torch.bfloat16, 2, "vector"),
    ((32, 54, 54, 64), torch.float32, 2, "vector"),
    ((32, 27, 27, 256), torch.float32, 2, "vector"),
    # every lane-group width (C/8 lanes, a power of two <= 32), radius 0-4
    ((2, 3, 8), torch.bfloat16, 4, "vector"),
    ((2, 3, 16), torch.bfloat16, 0, "vector"),
    ((2, 3, 32), torch.float32, 1, "vector"),
    ((2, 3, 128), torch.bfloat16, 3, "vector"),
    ((2, 3, 8), torch.float32, 4, "vector"),
    # odd shapes: fewer channels than a lane holds, a row that is no whole
    # number of lanes, more than 32 lanes, a lane count that is no power
    # of two, too wide a window, a dtype the kernels do not take
    ((3, 7, 9, 5), torch.bfloat16, 2, "general"),
    ((2, 3, 4), torch.float32, 2, "general"),
    ((2, 5, 7, 100), torch.float32, 2, "general"),
    ((2, 3, 512), torch.bfloat16, 2, "general"),
    ((2, 3, 24), torch.bfloat16, 2, "general"),
    ((2, 3, 64), torch.bfloat16, 5, "general"),
    ((2, 3, 64), torch.float16, 2, "general"),
])
def test_variant_rule(shape, dtype, radius, want):
    assert lrn_cuda.variant(shape, dtype, radius) == want

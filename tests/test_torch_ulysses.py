"""The port's Ulysses attention (distributed_vgg_f_tpu_torch/parallel/
ulysses.py) against the JAX package's `ulysses_attention` on the CPU.

The port runs in 2 and 4 gloo processes (tests/_torch_sp_worker.py; one
process group per size, shared by the file's cases), JAX on a 2- and
4-device CPU mesh, with the flash kernels of both in their CPU forms (the
port's plain versions, JAX's Pallas kernels interpreted). Output and the
gradients of sum(out**2) are held to the JAX tests' own tolerances (fp32
2e-5 forward, 5e-5 gradients; bf16 3e-2), with both local kernels, causal
and not, and H = 6 heads padded to 8 on 4 ranks. Inputs come from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sp_worker import run_group
from distributed_vgg_f_tpu.ops import flash_attention as jflash
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.parallel.ulysses import ulysses_attention
from distributed_vgg_f_tpu_torch.ops.flash_attention import \
    flash_self_attention
from distributed_vgg_f_tpu_torch.parallel.ring_attention import \
    full_attention_reference
from distributed_vgg_f_tpu_torch.parallel.ulysses import \
    ulysses_self_attention


@pytest.fixture
def interpret():
    old = jflash.INTERPRET
    jflash.INTERPRET = True    # CPU: run the Pallas kernels interpreted
    try:
        yield
    finally:
        jflash.INTERPRET = old


# name -> (local kernel, dtype, causal, global (B, T, H, D))
CASES = {
    "einsum_f32": ("einsum", "float32", False, (2, 64, 8, 16)),
    "einsum_f32_causal": ("einsum", "float32", True, (2, 64, 8, 16)),
    "einsum_bf16": ("einsum", "bfloat16", False, (2, 64, 8, 16)),
    "flash_f32": ("flash", "float32", False, (2, 128, 8, 16)),
    "flash_f32_causal": ("flash", "float32", True, (2, 128, 8, 16)),
    # ViT-S/16's head count: padded to 8 on 4 ranks
    "h6_einsum_causal": ("einsum", "float32", True, (2, 32, 6, 16)),
    "h6_flash_bf16_causal": ("flash", "bfloat16", True, (2, 64, 6, 16)),
}


def _inputs(name, shape, n):
    rng = np.random.default_rng([n, sum(map(ord, name))])
    return [rng.standard_normal(shape).astype(np.float32) for _ in "qkv"]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's results per group size, each size run once in its own
    gloo group."""
    cache = {}

    def get(n):
        if n not in cache:
            cases, arrays = [], {}
            for name, (kernel, dtype, causal, shape) in CASES.items():
                cases.append({"name": name, "kind": f"ulysses_{kernel}",
                              "dtype": dtype, "causal": causal})
                for key, a in zip("qkv", _inputs(name, shape, n)):
                    arrays[f"{name}/{key}"] = a
            cache[n] = run_group(n, cases, arrays,
                                 str(tmp_path_factory.mktemp(f"uly{n}")))
        return cache[n]
    return get


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ulysses_matches_jax_mesh(interpret, devices8, port_runs, n, name):
    kernel, dtype, causal, shape = CASES[name]
    mesh = build_mesh(MeshSpec(("data",), (n,)), devices=jax.devices()[:n])

    def loss(q, k, v):
        out = ulysses_attention(q, k, v, mesh, causal=causal, kernel=kernel)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    args = [jnp.asarray(a, getattr(jnp, dtype))
            for a in _inputs(name, shape, n)]
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(*args)
    got = port_runs(n)
    fwd_tol, grad_tol = ((2e-5, 5e-5) if dtype == "float32"
                         else (3e-2, 3e-2))
    for key, w in zip(("out", "dq", "dk", "dv"), (out, *grads)):
        tol = fwd_tol if key == "out" else grad_tol
        np.testing.assert_allclose(got[f"{name}/{key}"],
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=f"{name} {key} n={n}")


@pytest.mark.parametrize("kernel", ["einsum", "flash"])
def test_single_process_ulysses_is_local_attention(kernel):
    """Without a process group Ulysses has one rank: the all-to-alls are
    the identity and the output is the local kernel's."""
    q, k, v = (torch.from_numpy(a)
               for a in _inputs("single", (2, 48, 6, 16), 1))
    for causal in (False, True):
        want = (flash_self_attention(q, k, v, causal=causal)
                if kernel == "flash"
                else full_attention_reference(q, k, v, causal=causal))
        got = ulysses_self_attention(q, k, v, causal=causal, kernel=kernel)
        assert torch.equal(got, want)


def test_ulysses_refuses_unknown_kernel_and_bad_shards():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="kernel"):
        ulysses_self_attention(q, q, q, kernel="pallas")
    with pytest.raises(ValueError, match="shape"):
        ulysses_self_attention(q, q, q[:, :4])

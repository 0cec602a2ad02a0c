"""The port's LRN backward (distributed_vgg_f_tpu_torch/ops/lrn.py: the
plain closed form `local_response_norm_bwd` and `lrn` through
`LRNFunction`, and the fused `relu_lrn` through `ReLULRNFunction`)
against the JAX package: the VJP of its Pallas kernel run in the Pallas
interpreter (behind `jax.nn.relu` for the fused op), and `jax.grad` of its
oracle.

Tolerances: fp32 rtol 1e-5 / atol 1e-7 (both sides compute in fp32; the
Pallas kernel sums windows as a band matmul, the oracle divides by
d**beta, the port multiplies by rsqrt/sqrt forms). bf16 in and out: within
one bf16 ulp of the reference value (both round one fp32 result once).
fp64 gradcheck of both Functions on C = 5, 64, 256 at its default
tolerances. The fused backward against autograd through F.relu and `lrn`:
the same values exactly (both round the same fp32 LRN gradient once and
mask it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_vgg_f_tpu.ops.lrn_pallas as lrn_pallas
from distributed_vgg_f_tpu.ops.lrn import local_response_norm as jax_oracle
from distributed_vgg_f_tpu.ops.lrn_pallas import local_response_norm_pallas
from distributed_vgg_f_tpu_torch.ops import lrn_cuda
from distributed_vgg_f_tpu_torch.ops.lrn import (LRNFunction,
                                                 ReLULRNFunction,
                                                 local_response_norm,
                                                 local_response_norm_bwd, lrn,
                                                 relu_local_response_norm_bwd,
                                                 relu_lrn)

CASES = [(c, beta) for c in (64, 256, 5) for beta in (0.75, 0.5, 0.6)]


@pytest.fixture(autouse=True)
def _interpret_mode():
    prev = lrn_pallas.INTERPRET
    lrn_pallas.INTERPRET = jax.default_backend() != "tpu"
    yield
    lrn_pallas.INTERPRET = prev


def _xg(c, seed=0, shape=(2, 3, 5)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape + (c,)) * 3.0).astype(np.float32)
    g = rng.standard_normal(shape + (c,)).astype(np.float32)
    return x, g


def _jax_vjp(fn, x, g):
    _, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _function_grad(x, g, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    lrn(xt, **kw).backward(torch.from_numpy(g))
    return xt.grad.numpy()


@pytest.mark.parametrize("c,beta", CASES)
def test_plain_bwd_matches_pallas_interpret_vjp(c, beta):
    x, g = _xg(c)
    want = _jax_vjp(lambda v: local_response_norm_pallas(
        v, 2, 2.0, 1e-4, beta), x, g)
    got = local_response_norm_bwd(torch.from_numpy(x), torch.from_numpy(g),
                                  2, 2.0, 1e-4, beta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("c,beta", CASES)
def test_function_grad_matches_pallas_interpret_vjp(c, beta):
    x, g = _xg(c, seed=1)
    want = _jax_vjp(lambda v: local_response_norm_pallas(
        v, 2, 2.0, 1e-4, beta), x, g)
    got = _function_grad(x, g, beta=beta)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("c", [64, 256, 5])
@pytest.mark.parametrize("alpha_scaled", [False, True])
def test_function_grad_matches_jax_grad_of_oracle(c, alpha_scaled):
    x, g = _xg(c, seed=2)
    want = _jax_vjp(lambda v: jax_oracle(v, 2, 2.0, 1e-4, 0.75,
                                         alpha_scaled=alpha_scaled), x, g)
    got = _function_grad(x, g, alpha_scaled=alpha_scaled)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_wide_radius_grad_matches_oracle():
    x, g = _xg(7, seed=3)
    want = _jax_vjp(lambda v: jax_oracle(v, depth_radius=4), x, g)
    got = _function_grad(x, g, depth_radius=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("c", [64, 256, 5])
def test_bf16_grad_within_one_ulp_of_pallas_interpret(c):
    x, g = _xg(c, seed=4)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(local_response_norm_pallas, xb)
    want = np.asarray(vjp(gb)[0].astype(jnp.float32))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    lrn(xt).backward(torch.from_numpy(g).bfloat16())
    assert xt.grad.dtype == torch.bfloat16
    got = xt.grad.float().numpy()
    # one bf16 ulp of the reference: 2**(exponent - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("c", [5, 64, 256])
def test_gradcheck_fp64(c):
    x = torch.from_numpy(_xg(c, seed=5, shape=(1, 2, 2))[0]).double()
    x.requires_grad_()
    assert torch.autograd.gradcheck(lambda v: lrn(v), (x,))


def test_function_saves_only_x():
    x = torch.from_numpy(_xg(64, seed=6)[0]).requires_grad_()
    y = lrn(x)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is x
    assert isinstance(y.grad_fn, LRNFunction._backward_cls)


def test_forward_through_function_equals_plain_and_runs_in_inference():
    x = torch.from_numpy(_xg(256, seed=7)[0])
    with torch.inference_mode():
        y = lrn(x)
    assert not y.requires_grad
    assert torch.equal(y, local_response_norm(x))


def test_cpu_backward_never_counts_kernel_launches():
    lrn_cuda.LAUNCHES = lrn_cuda.BWD_LAUNCHES = 0
    x, g = _xg(64, seed=8)
    _function_grad(x, g)
    assert lrn_cuda.LAUNCHES == 0 and lrn_cuda.BWD_LAUNCHES == 0


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lrn_cuda.local_response_norm_bwd_cuda(x, x)
    assert lrn_cuda.BWD_LAUNCHES == 0


def test_second_derivative_raises():
    """Differentiable once, as the reference's custom VJP: a second
    derivative would miss the kernel's terms, so it raises."""
    x = torch.from_numpy(_xg(64, seed=9)[0]).requires_grad_()
    (gx,) = torch.autograd.grad(lrn(x).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="grad"):
        gx.sum().backward()


# ------------------------------------------------- ReLU fused into the LRN
def _zg(c, seed, shape=(2, 3, 5)):
    """Pre-activations with negatives and exact zeros (every fifth), and
    a cotangent."""
    z, g = _xg(c, seed=seed, shape=shape)
    z.reshape(-1)[::5] = 0.0
    return z, g


def _relu_lrn_grad(z, g, dtype=torch.float32):
    zt = torch.from_numpy(z).to(dtype).requires_grad_()
    relu_lrn(zt).backward(torch.from_numpy(g).to(dtype))
    return zt.grad


@pytest.mark.parametrize("c", [5, 64, 256])
def test_relu_lrn_grad_matches_jax_vjp_of_relu_then_pallas(c):
    z, g = _zg(c, seed=20)
    want = _jax_vjp(lambda v: local_response_norm_pallas(jax.nn.relu(v)),
                    z, g)
    got = _relu_lrn_grad(z, g).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the ReLU's mask: no gradient where z <= 0, exact zeros included
    assert (got[z <= 0] == 0).all() and (want[z <= 0] == 0).all()


@pytest.mark.parametrize("c", [5, 64, 256])
def test_relu_lrn_bf16_grad_within_one_ulp_of_jax(c):
    z, g = _zg(c, seed=21)
    zb = jnp.asarray(z).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda v: local_response_norm_pallas(jax.nn.relu(v)),
                     zb)
    want = np.asarray(vjp(jnp.asarray(g).astype(jnp.bfloat16))[0]
                      .astype(jnp.float32))
    grad = _relu_lrn_grad(z, g, torch.bfloat16)
    assert grad.dtype == torch.bfloat16
    got = grad.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_lrn_grad_is_the_unfused_grad_exactly(dtype):
    """The fused backward is the LRN backward at max(z, 0), rounded, then
    masked: the same values autograd gives through F.relu and `lrn`."""
    z, g = _zg(64, seed=22)
    zt = torch.from_numpy(z).to(dtype).requires_grad_()
    lrn(torch.relu(zt)).backward(torch.from_numpy(g).to(dtype))
    got = relu_local_response_norm_bwd(torch.from_numpy(z).to(dtype),
                                       torch.from_numpy(g).to(dtype))
    assert torch.equal(got, zt.grad)
    assert torch.equal(_relu_lrn_grad(z, g, dtype), zt.grad)


@pytest.mark.parametrize("c", [5, 64, 256])
def test_relu_lrn_gradcheck_fp64(c):
    # gradcheck's finite differences need every z away from the kink at 0
    z = _xg(c, seed=23, shape=(1, 2, 2))[0].astype(np.float64)
    z = np.where(np.abs(z) < 1e-3, 1.0, z)
    zt = torch.from_numpy(z).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: relu_lrn(v), (zt,))


def test_relu_lrn_function_saves_only_z():
    z = torch.from_numpy(_zg(64, seed=24)[0]).requires_grad_()
    y = relu_lrn(z)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is z
    assert isinstance(y.grad_fn, ReLULRNFunction._backward_cls)


def test_relu_lrn_cpu_backward_never_counts_kernel_launches():
    lrn_cuda.BWD_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
    _relu_lrn_grad(*_zg(256, seed=25))
    assert lrn_cuda.BWD_LAUNCHES == 0 and lrn_cuda.VEC_BWD_LAUNCHES == 0

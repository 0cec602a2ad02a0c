"""The port's LRN backward (distributed_vgg_f_tpu_torch/ops/lrn.py: the
plain closed form `local_response_norm_bwd` and `lrn` through
`LRNFunction`) against the JAX package: the VJP of its Pallas kernel run
in the Pallas interpreter, and `jax.grad` of its oracle.

Tolerances: fp32 rtol 1e-5 / atol 1e-7 (both sides compute in fp32; the
Pallas kernel sums windows as a band matmul, the oracle divides by
d**beta, the port multiplies by rsqrt/sqrt forms). bf16 in and out: within
one bf16 ulp of the reference value (both round one fp32 result once).
fp64 gradcheck of the Function on C = 5, 64, 256 at its default
tolerances."""

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
                                                 local_response_norm,
                                                 local_response_norm_bwd, lrn)

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

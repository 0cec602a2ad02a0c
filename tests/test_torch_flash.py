"""The port's flash attention (distributed_vgg_f_tpu_torch/ops/
flash_attention.py) against the JAX package's `flash_self_attention`,
whose Pallas kernels run here in interpret mode (`INTERPRET` patched and
restored, as tests/test_model_zoo.py does). On the CPU the port runs the
plain forward, dQ and dK/dV behind its autograd Function — the versions
each Hopper kernel is held against on the card (tests/test_torch_cuda.py).

Inputs come from numpy seeds. Tolerances: fp32 rtol/atol 2e-5 for the
output and the three gradients, and within 1e-5 of the largest value
(the JAX kernels sum over 128-key blocks with an online rescale, the
plain versions over the whole row at once; the measured gap is ~1e-6);
bf16 outputs within 2e-2 of the largest output at ViT's head dim, and the
output and gradients within 3e-2 of the largest at the narrow and wide
head dims (p rounds to bf16 against another running maximum in the two).
Head dims run from 8 to 256, as the JAX tests run them (test_ring_flash,
test_ulysses and test_flash_attention's test_wide_head_dim at
(1, 128, 1, 256) causal). Padded keys must get exactly zero dK and dV in
both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu.ops import flash_attention as jflash
from distributed_vgg_f_tpu_torch.ops import flash_cuda
from distributed_vgg_f_tpu_torch.ops.flash_attention import (
    attention_delta, attention_dkv, attention_dq, attention_fwd,
    flash_self_attention)

B, H, D = 2, 2, 32


@pytest.fixture
def interpret():
    old = jflash.INTERPRET
    jflash.INTERPRET = True    # CPU: run the Pallas kernels interpreted
    try:
        yield
    finally:
        jflash.INTERPRET = old


def _inputs(t, seed, d=D, b=B, h=H):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]     # q, k, v and the output cotangent


def _jax(q, k, v, w, causal, kv_len, dtype=jnp.float32):
    def loss(q, k, v):
        o = jflash.flash_self_attention(q, k, v, causal=causal,
                                        kv_len=kv_len)
        return jnp.sum(o.astype(jnp.float32) * w), o

    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(*args)
    return [np.asarray(x, np.float32) for x in (o, *grads)]


def _port(q, k, v, w, causal, kv_len, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = flash_self_attention(*ts, causal=causal, kv_len=kv_len)
    (o.float() * torch.from_numpy(w)).sum().backward()
    return [x.detach().float().numpy() for x in (o, *(t.grad for t in ts))]


def _case_id(case):
    """(T, causal, kv_len) as pytest names it; head dim and (B, H) added
    where they are not the module's."""
    t, causal, kv_len, d, b, h = case
    extra = "" if d == D else f"-d{d}"
    return f"{t}-{causal}-{kv_len}{extra}" + (
        "" if (b, h) == (B, H) else f"-b{b}h{h}")


# (T, causal, kv_len, D, B, H)
FP32_CASES = [
    (64, False, None, D, B, H), (64, True, None, D, B, H),
    (64, False, 40, D, B, H), (197, False, None, D, B, H),
    (197, True, None, D, B, H), (197, False, 150, D, B, H),
    (197, True, 150, D, B, H), (77, False, None, D, B, H),
    (77, True, 50, D, B, H),
    (64, True, None, 8, B, H), (77, False, 50, 8, B, H),
    (64, False, None, 16, B, H), (77, True, 50, 16, B, H),
    (64, False, 40, 256, B, H), (128, True, None, 256, 1, 1)]


def _max_close(got, want, tol, what):
    """max |got - want| <= tol * max |want|."""
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("t,causal,kv_len,d,b,h", FP32_CASES,
                         ids=[_case_id(c) for c in FP32_CASES])
def test_forward_and_grads_match_jax_fp32(interpret, t, causal, kv_len, d,
                                          b, h):
    q, k, v, w = _inputs(t, seed=t + 7 * causal + (kv_len or 0) + d,
                         d=d, b=b, h=h)
    want = _jax(q, k, v, w, causal, kv_len)
    got = _port(q, k, v, w, causal, kv_len)
    for name, g, ref in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, ref, rtol=2e-5, atol=2e-5,
                                   err_msg=name)
        _max_close(g, ref, 1e-5, name)
    if kv_len is not None:
        for name, g, ref in zip(("dk", "dv"), got[2:], want[2:]):
            assert (g[:, kv_len:] == 0).all(), name
            assert (ref[:, kv_len:] == 0).all(), name


def test_bf16_forward_matches_jax(interpret):
    q, k, v, w = _inputs(197, seed=3)
    want = _jax(q, k, v, w, False, None, jnp.bfloat16)
    got = _port(q, k, v, w, False, None, torch.bfloat16)
    scale = np.abs(want[0]).max()
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2,
                               atol=2e-2 * scale)


@pytest.mark.parametrize("t,causal,kv_len,d,b,h", [
    (64, True, None, 8, B, H), (77, False, 50, 16, B, H),
    (128, True, None, 256, 1, 1)], ids=["64-causal-d8", "77-kv50-d16",
                                         "128-causal-d256-b1h1"])
def test_bf16_head_dims_match_jax(interpret, t, causal, kv_len, d, b, h):
    """The output and the three gradients in bf16 at the narrow and wide
    head dims, within 3e-2 of the largest value."""
    q, k, v, w = _inputs(t, seed=5 + d, d=d, b=b, h=h)
    want = _jax(q, k, v, w, causal, kv_len, jnp.bfloat16)
    got = _port(q, k, v, w, causal, kv_len, torch.bfloat16)
    for name, g, ref in zip(("o", "dq", "dk", "dv"), got, want):
        _max_close(g, ref, 3e-2, name)
    if kv_len is not None:
        for g in got[2:]:
            assert (g[:, kv_len:] == 0).all()


def test_plain_pieces_are_what_the_function_runs():
    """The autograd Function's CPU path is exactly the three plain
    versions and the fp32 delta, and launches no kernel."""
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(70, seed=1))
    counts = (flash_cuda.FWD_LAUNCHES, flash_cuda.DQ_LAUNCHES,
              flash_cuda.DKV_LAUNCHES)
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_self_attention(*ts, causal=True, kv_len=60)
    o.backward(w)
    o_ref, lse = attention_fwd(q, k, v, causal=True, kv_len=60)
    delta = attention_delta(w, o_ref)
    dq = attention_dq(q, k, v, w, lse, delta, causal=True, kv_len=60)
    dk, dv = attention_dkv(q, k, v, w, lse, delta, causal=True, kv_len=60)
    assert torch.equal(o, o_ref)
    for got, want in zip((t.grad for t in ts), (dq, dk, dv)):
        assert torch.equal(got, want)
    assert lse.shape == (B, H, 70) and lse.dtype == torch.float32
    assert (flash_cuda.FWD_LAUNCHES, flash_cuda.DQ_LAUNCHES,
            flash_cuda.DKV_LAUNCHES) == counts


def test_plain_forward_matches_softmax_attention():
    """An independent reference: softmax(q k^T / sqrt(D)) v with the
    masks, and lse = logsumexp of the scaled, masked scores."""
    q, k, v, _ = (torch.from_numpy(a).double() for a in _inputs(33, seed=2))
    o, lse = attention_fwd(q, k, v, causal=True, kv_len=20)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / D ** 0.5
    pos = torch.arange(33)
    live = (pos[None, :] < 20) & (pos[:, None] >= pos[None, :])
    s = s.masked_fill(~live, float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(o, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-12,
                               atol=1e-12)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_cuda.flash_fwd_cuda(q, q, q)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_cuda.flash_dq_cuda(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_cuda.flash_dkv_cuda(q, q, q, q, lse, lse)


@pytest.mark.parametrize("kw,match", [
    ({"kv_len": 0}, "outside"), ({"kv_len": 9}, "outside")])
def test_bad_arguments_are_refused(kw, match):
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match=match):
        flash_self_attention(q, q, q, **kw)
    with pytest.raises(ValueError, match="shape"):
        flash_self_attention(q, q, q[:, :4])


@pytest.mark.parametrize("causal,causal_skip", [
    (False, "auto"), (False, "mxu"), (True, "auto"), (True, "mxu"),
    (True, "dma")])
def test_causal_skip_values_run_the_same_function(causal, causal_skip):
    """JAX's `causal_skip` values are taken, and all three run the same
    kernels (their plain versions here): the same output, bit for bit
    ("dma" only with causal=True, as in JAX)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(70, seed=4))
    want = flash_self_attention(q, k, v, causal=causal)
    got = flash_self_attention(q, k, v, causal=causal,
                               causal_skip=causal_skip)
    assert torch.equal(got, want)


def test_causal_skip_is_checked_as_in_jax(interpret):
    q = torch.zeros(1, 8, 1, 32)
    for fn, arr in ((flash_self_attention, q),
                    (jflash.flash_self_attention, jnp.zeros((1, 8, 1, 32)))):
        with pytest.raises(ValueError, match="not one of"):
            fn(arr, arr, arr, causal=True, causal_skip="jagged")
        with pytest.raises(ValueError, match="only applies to causal"):
            fn(arr, arr, arr, causal_skip="dma")

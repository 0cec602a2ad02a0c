"""The port on the card: the LRN and flash attention kernels against their
plain versions at the main paths' shapes, and the VGG-F forward and the
VGG-F and ViT train steps through the kernels against the same on the
CPU. Every test here needs a CUDA device and skips
without one; the file imports only the port, so it runs where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which the card's
machine does not need.)

Tolerances: kernel vs plain fp32 rtol 1e-5 (both sum five squares in
fp32; the kernel may fuse multiply-adds); bf16 rtol 8e-3, one bf16 ulp
(both round the same fp32 value, which may differ in its last bits).
The backward kernel vs the plain backward: the same, with atol 1e-5 in
fp32 (dx is a difference of two terms). Both LRN kernels in both variants
(vector and general), unfused and with the ReLU fused, at those
tolerances; the fused kernels bit-equal to the unfused ones on F.relu(z)
(ReLU is exact in any dtype), and two launches bit-equal. Model on the card vs the CPU in
fp32 with TF32 off: rtol/atol 1e-4, for logits, for one train step's
parameter gradients (narrow model, 32 px) and for the updated
parameters.

Flash kernels vs their plain versions: max error within 1e-5 of the
largest reference value in fp32 (the kernels sum in 64- or 128-key tiles
with an online rescale, the plain versions whole rows at once), 1e-2 in
bf16 (one bf16 ulp of an element is at most 3.9e-3 of the largest), lse
within 1e-5 in both; the same for the causal kernels at T = 2048 and for
the three ring block kernels (their fp32 state and accumulators
included), at head dims 8 to 256 and at B*H = 65600 (past the 65535 of a
grid's y axis); the block dQ and dK/dV also at T = 2 to 2048 with
Tq != Tk and diagonals shifted by 0, 37 and -37, where the rows a block
does not reach keep their values (in bf16 their bits, -0.0 included, for
a block wholly in the future and for padded keys). dQ, dK and dV of two
launches on the same inputs are bit-equal (no kernel sums with atomics),
in the flash backward and in the block steps.
The sequence-parallel entry points on one card (no process group: a ring
of one) against `flash_self_attention`: fp32 2e-5 (output) and 5e-5
(gradients), bf16 3e-2, the JAX ring tests' tolerances. A narrow ViT's fp32 train step through the flash kernels:
every gradient and update within 1e-4 relative L2 of the CPU step."""

import numpy as np
import pytest
import torch

from distributed_vgg_f_tpu_torch.config import ModelConfig
from distributed_vgg_f_tpu_torch.models.registry import build_model
from distributed_vgg_f_tpu_torch.ops import lrn_cuda
from distributed_vgg_f_tpu_torch.ops.lrn import (local_response_norm,
                                                 local_response_norm_bwd, lrn)
from distributed_vgg_f_tpu_torch.weights import init_params, load_params


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the LRN kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 54, 54, 64), (32, 27, 27, 256),
                                   (1, 54, 54, 64), (3, 7, 9, 5)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 8e-3)])
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype, rtol):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(shape, generator=gen, device=cuda_device)
         * 3.0).to(dtype)
    before = lrn_cuda.LAUNCHES
    got = lrn(x)
    torch.cuda.synchronize()
    assert lrn_cuda.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), local_response_norm(x).float(),
                               rtol=rtol, atol=1e-6)


@pytest.mark.cuda
def test_kernel_refuses_non_contiguous_and_fp16(cuda_device):
    x = torch.randn(2, 4, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        lrn(x.permute(0, 3, 1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lrn(x.half())


@pytest.mark.cuda
def test_card_forward_launches_lrn_twice_and_matches_cpu(cuda_device):
    cfg = ModelConfig(num_classes=10, compute_dtype="float32")
    tree = init_params(cfg, 0, image_size=32)
    x = np.random.default_rng(6).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    cpu = load_params(build_model(cfg, image_size=32), tree).eval()
    with torch.no_grad():
        want = cpu(torch.from_numpy(x)).numpy()
    card = load_params(build_model(cfg, image_size=32), tree).eval()
    card = card.to(cuda_device)
    # fp32 convs in full fp32, as on the CPU (cuDNN defaults to TF32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    lrn_cuda.LAUNCHES = lrn_cuda.VEC_LAUNCHES = 0
    try:
        with torch.no_grad():
            got = card(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert lrn_cuda.LAUNCHES == 2 and lrn_cuda.VEC_LAUNCHES == 2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 54, 54, 64), (32, 27, 27, 256),
                                   (1, 54, 54, 64), (3, 7, 9, 5),
                                   (2, 5, 7, 100)])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 8e-3, 1e-6)])
def test_bwd_kernel_matches_plain_on_card(cuda_device, shape, dtype, rtol,
                                          atol):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = (torch.randn(shape, generator=gen, device=cuda_device)
         * 3.0).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    before = lrn_cuda.BWD_LAUNCHES
    got = lrn_cuda.local_response_norm_bwd_cuda(x, g)
    torch.cuda.synchronize()
    assert lrn_cuda.BWD_LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(),
                               local_response_norm_bwd(x, g).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_bwd_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.randn(2, 4, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lrn_cuda.local_response_norm_bwd_cuda(x.cpu(), x.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lrn_cuda.local_response_norm_bwd_cuda(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        lrn_cuda.local_response_norm_bwd_cuda(x.permute(0, 3, 1, 2),
                                              x.permute(0, 3, 1, 2))
    with pytest.raises(ValueError, match="must match x"):
        lrn_cuda.local_response_norm_bwd_cuda(x, x[:1].contiguous())
    with pytest.raises(ValueError, match="must match x"):
        lrn_cuda.local_response_norm_bwd_cuda(x, x.bfloat16())


#: The vector variant at every lane-group width the checks use and every
#: radius it is built for; the general variant at odd shapes (C = 5 and
#: 100: no whole 16-byte vectors; 24: 3 lanes, no power of two; radius 5:
#: wider than the vector variant is built for).
_VEC_CASES = [((2, 5, 7, c), r) for c in (8, 16, 64, 128, 256)
              for r in range(5)]
_GENERAL_CASES = [((3, 7, 9, 5), 2), ((2, 5, 7, 100), 2),
                  ((2, 5, 7, 24), 2), ((2, 5, 7, 64), 5)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _zg_card(device, shape, dtype, seed):
    """Pre-activations with negatives and exact zeros (every fifth), and a
    cotangent."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(shape, generator=gen, device=device) * 3.0
    z.view(-1)[::5] = 0.0
    g = torch.randn(shape, generator=gen, device=device)
    return z.to(dtype), g.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius", _VEC_CASES + _GENERAL_CASES)
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 8e-3, 1e-6)])
def test_lrn_variants_fused_and_not_match_plain_on_card(cuda_device, shape,
                                                        radius, dtype, rtol,
                                                        atol):
    """Both kernels, unfused and with the ReLU fused, against their plain
    versions; the fused kernels give the unfused kernels' bits on
    F.relu(z) (then the ReLU's own backward mask), and a second launch
    gives the same bits. Each launch counts once, and in the vector
    counters only when the shape takes the vector variant."""
    import torch.nn.functional as F

    from distributed_vgg_f_tpu_torch.ops.lrn import (
        relu_local_response_norm, relu_local_response_norm_bwd)
    want_variant = ("vector" if (shape, radius) in _VEC_CASES
                    else "general")
    assert lrn_cuda.variant(shape, dtype, radius) == want_variant
    z, g = _zg_card(cuda_device, shape, dtype, seed=radius)
    r = F.relu(z)
    counts = (lrn_cuda.LAUNCHES, lrn_cuda.VEC_LAUNCHES,
              lrn_cuda.BWD_LAUNCHES, lrn_cuda.VEC_BWD_LAUNCHES)
    y = lrn_cuda.local_response_norm_cuda(z, radius)
    yf = lrn_cuda.local_response_norm_cuda(z, radius, relu=True)
    yr = lrn_cuda.local_response_norm_cuda(r, radius)
    yf2 = lrn_cuda.local_response_norm_cuda(z, radius, relu=True)
    dx = lrn_cuda.local_response_norm_bwd_cuda(z, g, radius)
    dz = lrn_cuda.local_response_norm_bwd_cuda(z, g, radius, relu=True)
    dr = torch.ops.aten.threshold_backward(
        lrn_cuda.local_response_norm_bwd_cuda(r, g, radius), r, 0.0)
    dz2 = lrn_cuda.local_response_norm_bwd_cuda(z, g, radius, relu=True)
    torch.cuda.synchronize()
    vec = int(want_variant == "vector")
    assert (lrn_cuda.LAUNCHES, lrn_cuda.VEC_LAUNCHES, lrn_cuda.BWD_LAUNCHES,
            lrn_cuda.VEC_BWD_LAUNCHES) == (counts[0] + 4, counts[1] + 4 * vec,
                                           counts[2] + 4, counts[3] + 4 * vec)
    for got in (y, yf, dx, dz):
        assert got.dtype == dtype and got.shape == z.shape
    torch.testing.assert_close(y.float(),
                               local_response_norm(z, radius).float(),
                               rtol=rtol, atol=1e-6)
    torch.testing.assert_close(yf.float(),
                               relu_local_response_norm(z, radius).float(),
                               rtol=rtol, atol=1e-6)
    torch.testing.assert_close(dx.float(),
                               local_response_norm_bwd(z, g, radius).float(),
                               rtol=rtol, atol=atol)
    torch.testing.assert_close(
        dz.float(), relu_local_response_norm_bwd(z, g, radius).float(),
        rtol=rtol, atol=atol)
    assert torch.equal(_bits(yf), _bits(yr))
    assert torch.equal(_bits(dz), _bits(dr))
    assert torch.equal(_bits(yf), _bits(yf2))
    assert torch.equal(_bits(dz), _bits(dz2))


@pytest.mark.cuda
def test_vector_variant_takes_a_view_off_16_bytes_on_card(cuda_device):
    """A contiguous view that starts off a 16-byte boundary is copied once
    and takes the vector variant; the result is the aligned tensor's."""
    z, g = _zg_card(cuda_device, (2 * 3 * 64 + 1,), torch.bfloat16, seed=9)
    zv, gv = z[1:].view(2, 3, 64), g[1:].view(2, 3, 64)
    assert zv.data_ptr() % 16 != 0
    before = lrn_cuda.VEC_LAUNCHES, lrn_cuda.VEC_BWD_LAUNCHES
    y = lrn_cuda.local_response_norm_cuda(zv, relu=True)
    dz = lrn_cuda.local_response_norm_bwd_cuda(zv, gv, relu=True)
    assert (lrn_cuda.VEC_LAUNCHES, lrn_cuda.VEC_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(_bits(y), _bits(lrn_cuda.local_response_norm_cuda(
        zv.clone(), relu=True)))
    assert torch.equal(_bits(dz), _bits(lrn_cuda.local_response_norm_bwd_cuda(
        zv.clone(), gv.clone(), relu=True)))


@pytest.mark.cuda
def test_card_train_step_gives_conv1_the_cpu_gradient(cuda_device):
    """One train step on the card and on the CPU from the same weights and
    batch: every parameter, conv1 included, gets the CPU's gradient, and
    both LRN sites launch the backward kernel."""
    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
    from distributed_vgg_f_tpu_torch.train.state import TrainState
    from distributed_vgg_f_tpu_torch.train.step import build_train_step
    cfg = get_config("vggf_teacher")
    model_cfg = ModelConfig(num_classes=10, compute_dtype="float32",
                            dropout_rate=0.0)
    tree = init_params(model_cfg, 0, image_size=32)
    rng = np.random.default_rng(7)
    batch = {"image": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, (4,))}
    out = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            model = load_params(build_model(model_cfg, image_size=32),
                                tree).to(dev)
            opt, schedule = build_optimizer(cfg, model.parameters())
            state = TrainState.create(model, opt)
            step = build_train_step(schedule, 5e-4, device=dev)
            lrn_cuda.BWD_LAUNCHES = lrn_cuda.VEC_BWD_LAUNCHES = 0
            state.opt_count = 100  # past the warmup's LR-0 first update
            state, _ = step(state, batch, 0)
            torch.cuda.synchronize()
            out[dev] = ({k: p.grad.cpu() for k, p in
                         model.named_parameters()},
                        {k: p.detach().cpu() for k, p in
                         model.named_parameters()},
                        (lrn_cuda.BWD_LAUNCHES, lrn_cuda.VEC_BWD_LAUNCHES))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert out["cpu"][2] == (0, 0) and out["cuda"][2] == (2, 2)
    grads, params = out["cuda"][0], out["cuda"][1]
    assert grads["conv1.weight"].abs().max() > 0
    for k in grads:
        torch.testing.assert_close(grads[k], out["cpu"][0][k], rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(params[k], out["cpu"][1][k], rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------------ flash kernels
def _flash_case(device, b, t, h, d, dtype, layout, seed=0):
    """q, k, v and dO in `layout`: "qkv" (q, k, v slices of one
    (B, T, 3, H, D) tensor, as the model passes them), "dense",
    "misaligned" (each tensor one element into its storage, so no row
    starts on 16 bytes) or "permuted" (q, k and v (B, H, T, D) tensors
    seen as (B, T, H, D), whose H stride exceeds their T stride: a tensor
    map cannot read those in place, so the bf16 forward's wrapper copies
    them); and the plain forward and delta."""
    from distributed_vgg_f_tpu_torch.ops.flash_attention import \
        attention_delta, attention_fwd
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        n = int(np.prod(shape))
        if layout == "misaligned":
            buf = torch.randn(n + 1, generator=gen, device=device)
            return buf.to(dtype)[1:].view(*shape)
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    if layout == "qkv":
        q, k, v = draw(b, t, 3, h, d).unbind(2)
    elif layout == "permuted":
        q, k, v = (draw(b, h, t, d).transpose(1, 2) for _ in range(3))
    else:
        q, k, v = (draw(b, t, h, d) for _ in range(3))
    return q, k, v, draw(b, t, h, d), attention_fwd, attention_delta


def _close(got, want, tol):
    """max |got - want| <= tol * max |want| (per-output scale: bf16 results
    may differ by one ulp of the element, fp32 by summation order)."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,causal,kv_len,layout", [
    (4, 197, 6, 64, False, None, "qkv"),    # ViT's shape, from the QKV output
    (2, 197, 6, 64, True, None, "qkv"),
    (3, 77, 2, 32, False, 50, "dense"),     # ragged tiles and padding keys
    (2, 130, 3, 64, True, 100, "dense"),
    (2, 100, 2, 64, True, 90, "misaligned"),
    (1, 128, 1, 256, True, None, "dense"),  # JAX's test_wide_head_dim
    (2, 197, 2, 128, True, 150, "qkv"),
    (65600, 8, 1, 64, False, None, "qkv"),  # B*H past 65535
    (2, 100, 2, 64, False, None, "permuted"),
    (2, 100, 2, 12, True, 80, "dense")])    # rows not on 16 bytes
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_flash_kernels_match_plain_on_card(cuda_device, b, t, h, d, causal,
                                           kv_len, layout, dtype, tol):
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        attention_dkv, attention_dq)
    q, k, v, do, fwd, delta_of = _flash_case(cuda_device, b, t, h, d, dtype,
                                             layout)
    kw = {"causal": causal, "kv_len": kv_len}
    before = (flash_cuda.FWD_LAUNCHES, flash_cuda.DQ_LAUNCHES,
              flash_cuda.DKV_LAUNCHES)
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, **kw)
    o_ref, lse_ref = fwd(q, k, v, **kw)
    delta = delta_of(do, o_ref)
    dq = flash_cuda.flash_dq_cuda(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = flash_cuda.flash_dkv_cuda(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_cuda.FWD_LAUNCHES, flash_cuda.DQ_LAUNCHES,
            flash_cuda.DKV_LAUNCHES) == tuple(n + 1 for n in before)
    dk_ref, dv_ref = attention_dkv(q, k, v, do, lse_ref, delta, **kw)
    _close(o, o_ref, tol)
    _close(lse, lse_ref, 1e-5)
    _close(dq, attention_dq(q, k, v, do, lse_ref, delta, **kw), tol)
    _close(dk, dk_ref, tol)
    _close(dv, dv_ref, tol)
    if kv_len is not None:
        assert (dk[:, kv_len:] == 0).all() and (dv[:, kv_len:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("t", [1, 65, 197, 2048])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_flash_forward_takes_every_head_dim_on_card(cuda_device, d, t,
                                                    causal, dtype, tol):
    """The forward at the head dims the JAX package's tests use (8, 16,
    256) and the padded widths, around the tile and ring-stage edges,
    with keys past kv_len masked, from slices of one QKV tensor."""
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    q, k, v, _, fwd, _ = _flash_case(cuda_device, 2, t, 2, d, dtype, "qkv",
                                     seed=d + t)
    kw = {"causal": causal, "kv_len": max(1, t - 7)}
    before = flash_cuda.FWD_LAUNCHES
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_cuda.FWD_LAUNCHES == before + 1
    o_ref, lse_ref = fwd(q, k, v, **kw)
    _close(o, o_ref, tol)
    _close(lse, lse_ref, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 100, 128, 256])
@pytest.mark.parametrize("t", [2, 65, 197, 2048])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_flash_backward_takes_every_head_dim_on_card(cuda_device, d, t,
                                                     causal, dtype, tol):
    """dQ and dK/dV at the head dims the JAX package's tests use (8, 16,
    256), the padded widths and one whose rows a tensor map cannot read
    in place (100), around the tile and ring-stage edges, with keys past
    kv_len masked (none at T = 2, where one live key would make the exact
    dQ and dK zero), from slices of one QKV tensor."""
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        attention_dkv, attention_dq)
    q, k, v, do, fwd, delta_of = _flash_case(cuda_device, 2, t, 2, d, dtype,
                                             "qkv", seed=d + t)
    kw = {"causal": causal, "kv_len": max(2, t - 7)}
    o_ref, lse_ref = fwd(q, k, v, **kw)
    delta = delta_of(do, o_ref)
    before = (flash_cuda.DQ_LAUNCHES, flash_cuda.DKV_LAUNCHES)
    dq = flash_cuda.flash_dq_cuda(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = flash_cuda.flash_dkv_cuda(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_cuda.DQ_LAUNCHES, flash_cuda.DKV_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    dk_ref, dv_ref = attention_dkv(q, k, v, do, lse_ref, delta, **kw)
    _close(dq, attention_dq(q, k, v, do, lse_ref, delta, **kw), tol)
    _close(dk, dk_ref, tol)
    _close(dv, dv_ref, tol)
    assert (dk[:, kw["kv_len"]:] == 0).all()
    assert (dv[:, kw["kv_len"]:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,causal", [
    (64, 197, 6, 64, False),   # ViT's layer at a smaller batch
    (2, 2048, 2, 64, True),
    (2, 197, 2, 256, True)])   # dK/dV's column-split warpgroups
def test_flash_backward_is_deterministic_on_card(cuda_device, b, t, h, d,
                                                 causal):
    """dQ, dK and dV of two launches on the same bf16 inputs are the same
    bits: each output row is written once by the block that owns it, with
    no atomics."""
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    q, k, v, do, _, delta_of = _flash_case(cuda_device, b, t, h, d,
                                           torch.bfloat16, "qkv", seed=7)
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, causal=causal)
    args = (q, k, v, do, lse, delta_of(do, o))
    first = (flash_cuda.flash_dq_cuda(*args, causal=causal),
             *flash_cuda.flash_dkv_cuda(*args, causal=causal))
    second = (flash_cuda.flash_dq_cuda(*args, causal=causal),
              *flash_cuda.flash_dkv_cuda(*args, causal=causal))
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take(cuda_device):
    """Every head dim from 1 to 256 and any B*H are taken (the tests
    above); still refused: other dtypes, head dims past 256, a strided
    head axis, kv_len outside [1, T] and a dO of the wrong type."""
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    q = torch.randn(1, 8, 2, 64, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_cuda.flash_fwd_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim 257 outside"):
        x = torch.randn(1, 8, 2, 257, device=cuda_device)
        flash_cuda.flash_fwd_cuda(x, x, x)
    with pytest.raises(ValueError, match="head dim 300 outside"):
        x = torch.randn(4, 8, 300, device=cuda_device)
        flash_cuda.flash_block_fwd_cuda(x, x, x, x.clone(), x[..., :1],
                                        x[..., :1], q_off=0, k_off=0,
                                        causal=False)
    with pytest.raises(ValueError, match="contiguous head axis"):
        x = q.transpose(1, 3).contiguous().transpose(1, 3)
        flash_cuda.flash_fwd_cuda(x, x, x)
    with pytest.raises(ValueError, match="kv_len"):
        flash_cuda.flash_fwd_cuda(q, q, q, kv_len=9)
    lse = torch.zeros(1, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="dO must be"):
        flash_cuda.flash_dq_cuda(q, q, q, q.bfloat16(), lse, lse)


@pytest.mark.cuda
def test_card_vit_train_step_matches_cpu(cuda_device):
    """One fp32 train step of a ViT through the flash layout (hidden 128,
    2 heads of 64, depth 2, 224 px: 197 tokens) on the card and on the
    CPU from the same weights and batch: every gradient and update within
    1e-4 relative L2, and each flash kernel launched once a block."""
    from distributed_vgg_f_tpu_torch.config import get_config
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    from distributed_vgg_f_tpu_torch.train.schedule import build_optimizer
    from distributed_vgg_f_tpu_torch.train.state import TrainState
    from distributed_vgg_f_tpu_torch.train.step import build_train_step
    cfg = get_config("vit_s16_imagenet")
    model_cfg = ModelConfig(name="vit_s16", num_classes=10,
                            compute_dtype="float32", dropout_rate=0.0,
                            extra=dict(hidden_dim=128, depth=2, num_heads=2,
                                       mlp_dim=256,
                                       attention_layout="flash"))
    tree = init_params(model_cfg, 0, image_size=224)
    rng = np.random.default_rng(8)
    batch = {"image": rng.standard_normal((2, 224, 224, 3)).astype(
        np.float32), "label": rng.integers(0, 10, (2,))}
    out = {}
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            model = load_params(build_model(model_cfg, image_size=224),
                                tree).to(dev)
            p0 = {k: p.detach().cpu().clone()
                  for k, p in model.named_parameters()}
            opt, schedule = build_optimizer(cfg, model.parameters())
            state = TrainState.create(model, opt)
            state.opt_count = 10000  # past the warmup's LR-0 first update
            step = build_train_step(schedule, cfg.optim.weight_decay,
                                    device=dev)
            flash_cuda.FWD_LAUNCHES = flash_cuda.DQ_LAUNCHES = 0
            flash_cuda.DKV_LAUNCHES = 0
            state, _ = step(state, batch, 0)
            torch.cuda.synchronize()
            out[dev] = ({k: p.grad.cpu() for k, p in
                         model.named_parameters()},
                        {k: p.detach().cpu() - p0[k] for k, p in
                         model.named_parameters()},
                        (flash_cuda.FWD_LAUNCHES, flash_cuda.DQ_LAUNCHES,
                         flash_cuda.DKV_LAUNCHES))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    assert out["cpu"][2] == (0, 0, 0) and out["cuda"][2] == (2, 2, 2)
    for i in (0, 1):
        for k, want in out["cpu"][i].items():
            got = out["cuda"][i][k]
            err = float((got - want).double().norm()
                        / max(float(want.double().norm()), 1e-30))
            assert err <= 1e-4, (k, err)


# ------------------------------------------------------ ring block kernels
@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,q_off,k_off,causal,kv_len", [
    (24, 2048, 2048, 64, 2048, 0, False, None),   # a past block of the ring
    (24, 2048, 2048, 64, 2048, 2048, True, None),  # the diagonal block
    (6, 197, 197, 64, 197, 147, True, 180),        # partly masked, ragged
    (6, 197, 197, 64, 394, 0, False, 180),
    (4, 130, 70, 32, 0, 40, True, 60),             # Tq != Tk
    (4, 130, 130, 32, 0, 130, True, None),         # wholly in the future
    (4, 197, 197, 128, 197, 197, True, 150),       # wide heads
    (2, 130, 130, 256, 130, 0, False, None),
    (6, 90, 90, 8, 90, 40, True, None),            # narrow heads
    (6, 90, 90, 16, 90, 40, True, 70),
    (3, 197, 150, 100, 160, 200, True, 140),       # rows copied for TMA
    (65600, 16, 16, 64, 8, 0, True, 12)])          # B*H past 65535
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_block_kernels_match_plain_on_card(cuda_device, bh, tq, tk, d,
                                           q_off, k_off, causal, kv_len,
                                           dtype, tol):
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        block_grads_plain, block_update_plain)
    gen = torch.Generator(device=cuda_device).manual_seed(bh + tq)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    q, do = draw(bh, tq, d).to(dtype), draw(bh, tq, d).to(dtype)
    k, v = draw(bh, tk, d).to(dtype), draw(bh, tk, d).to(dtype)
    acc, m = draw(bh, tq, d), draw(bh, tq, 1)
    l = draw(bh, tq, 1).abs() + 0.5
    acc[:, :5], m[:, :5], l[:, :5] = 0.0, -float("inf"), 0.0  # seen nothing
    lse, delta = draw(bh, tq, 1) + 3.0, draw(bh, tq, 1)
    dq, dk, dv = draw(bh, tq, d), draw(bh, tk, d), draw(bh, tk, d)
    kw = {"q_off": q_off, "k_off": k_off, "causal": causal,
          "kv_len": tk if kv_len is None else kv_len}
    dk[:, kw["kv_len"]:] = 0.0
    dv[:, kw["kv_len"]:] = 0.0
    want = (*block_update_plain(q, k, v, acc, m, l, **kw),
            *block_grads_plain(q, k, v, do, lse, delta, dq, dk, dv, **kw))
    got = [x.clone() for x in (acc, m, l, dq, dk, dv)]
    before = (flash_cuda.BLOCK_FWD_LAUNCHES, flash_cuda.BLOCK_DQ_LAUNCHES,
              flash_cuda.BLOCK_DKV_LAUNCHES)
    flash_cuda.flash_block_fwd_cuda(q, k, v, *got[:3], **kw)
    flash_cuda.flash_block_dq_cuda(q, k, v, do, lse, delta, got[3], **kw)
    flash_cuda.flash_block_dkv_cuda(q, k, v, do, lse, delta, *got[4:], **kw)
    torch.cuda.synchronize()
    assert (flash_cuda.BLOCK_FWD_LAUNCHES, flash_cuda.BLOCK_DQ_LAUNCHES,
            flash_cuda.BLOCK_DKV_LAUNCHES) == tuple(n + 1 for n in before)
    for name, g, w in zip(("acc", "m", "l", "dq", "dk", "dv"), got, want):
        if name == "m":   # -inf where no key was ever live, in both
            assert torch.equal(torch.isneginf(g), torch.isneginf(w))
            g, w = g.clamp_min(-1e30), w.clamp_min(-1e30)
            assert float((g - w).abs().max()) <= 1e-5, name
            continue
        # the fp32 state carries no rounding of its own: the bf16 bound
        # is for the products of bf16 inputs
        _close(g, w, tol)
    assert (got[4][:, kw["kv_len"]:] == 0).all()
    assert (got[5][:, kw["kv_len"]:] == 0).all()


def _block_case(device, bh, tq, tk, d, dtype, seed):
    """Inputs of one ring block step: q, k, v, dO in `dtype`, lse and
    delta, the fold's state (acc, m, l; its first 5 rows have seen no key
    yet: acc 0, m -inf, l 0) and the backward's accumulators, all random
    fp32 with some -0.0 entries (a kernel that adds +0.0 to a row it
    should leave alone flips their sign bit)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    x = {"q": draw(bh, tq, d).to(dtype), "k": draw(bh, tk, d).to(dtype),
         "v": draw(bh, tk, d).to(dtype), "do": draw(bh, tq, d).to(dtype),
         "lse": draw(bh, tq, 1) + 3.0, "delta": draw(bh, tq, 1),
         "acc": draw(bh, tq, d), "m": draw(bh, tq, 1),
         "l": draw(bh, tq, 1).abs() + 0.5,
         "dq": draw(bh, tq, d), "dk": draw(bh, tk, d), "dv": draw(bh, tk, d)}
    for key in ("acc", "dq", "dk", "dv"):
        x[key][:, ::3, ::5] = -0.0
    x["acc"][:, :5], x["m"][:, :5], x["l"][:, :5] = 0.0, -float("inf"), 0.0
    return x


def _block_fold_run(x, kw, virgin=False):
    """acc, m and l after one launch of the block fold, from the state of
    x (or a state that has seen nothing: acc 0, m -inf, l 0)."""
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    state = [x[k].clone() for k in ("acc", "m", "l")]
    if virgin:
        state[0].zero_()
        state[1].fill_(-float("inf"))
        state[2].zero_()
    flash_cuda.flash_block_fwd_cuda(x["q"], x["k"], x["v"], *state, **kw)
    torch.cuda.synchronize()
    return state


def _block_grads_run(x, kw, zero=False):
    """dq, dk and dv after one launch of each block backward kernel,
    from the accumulators of x (or zeros)."""
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    acc = [torch.zeros_like(x[k]) if zero else x[k].clone()
           for k in ("dq", "dk", "dv")]
    args = [x[k] for k in ("q", "k", "v", "do", "lse", "delta")]
    flash_cuda.flash_block_dq_cuda(*args, acc[0], **kw)
    flash_cuda.flash_block_dkv_cuda(*args, *acc[1:], **kw)
    torch.cuda.synchronize()
    return acc


def _fold_close(got, want, tol):
    """The fold's (acc, m, l) against block_update_plain's: acc and l
    within tol of their largest value (exactly equal where nothing was
    live), m within 1e-5 with the same -inf rows."""
    for name, g, w in zip(("acc", "m", "l"), got, want):
        if name == "m":   # -inf where no key was ever live, in both
            assert torch.equal(torch.isneginf(g), torch.isneginf(w))
            g, w = g.clamp_min(-1e30), w.clamp_min(-1e30)
            assert float((g - w).abs().max()) <= 1e-5, name
        elif float(w.abs().max()) > 0:
            _close(g, w, tol)
        else:
            assert torch.equal(g, w), name


#: the block steps' stress: (Tq, Tk, kv_len) around the 64- and 128-row
#: tiles and the rings' stages, each at a zero, a ragged and a negative
#: diagonal shift (q_off - k_off = 0, 37, -37) and causal
_BLOCK_STRESS = ((2, 2, 2), (63, 65, 50), (65, 63, 63), (129, 100, 100),
                 (197, 197, 180), (2048, 2048, 1500))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 100, 128, 256])
@pytest.mark.parametrize("tq,tk,kv_len", _BLOCK_STRESS)
@pytest.mark.parametrize("shift", [0, 37, -37])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_block_kernels_take_every_head_dim_and_shift_on_card(
        cuda_device, d, tq, tk, kv_len, shift, dtype, tol):
    """The block fold, dQ and dK/dV at every head dim the flash kernels
    are checked at (100: rows a tensor map cannot read in place, copied by
    the wrapper), at lengths around the tiles with Tq != Tk and kv_len,
    and at diagonals shifted by 0, by no multiple of a tile and
    negatively, causal: from a state that has seen nothing (zero
    accumulators) within tol of the largest value of block_update_plain
    and block_grads_plain; from a random state, the fold within the same
    tol, and the rows that see no key (fold, dq) or that no query sees
    (dk, dv) keep their bits (bf16) or values (fp32)."""
    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        block_grads_plain, block_update_plain)
    q_off = 512 + max(shift, 0)
    k_off = q_off - shift
    kw = {"q_off": q_off, "k_off": k_off, "causal": True, "kv_len": kv_len}
    x = _block_case(cuda_device, 2, tq, tk, d, dtype, seed=d + tq)
    qkv = [x[k] for k in ("q", "k", "v")]
    virgin = _block_fold_run(x, kw, virgin=True)
    state0 = (torch.zeros_like(x["acc"]),
              torch.full_like(x["m"], -float("inf")),
              torch.zeros_like(x["l"]))
    _fold_close(virgin, block_update_plain(*qkv, *state0, **kw), tol)
    state = [x[k] for k in ("acc", "m", "l")]
    fold = _block_fold_run(x, kw)
    _fold_close(fold, block_update_plain(*qkv, *state, **kw), tol)
    args = [x[k] for k in ("q", "k", "v", "do", "lse", "delta")]
    zeros = [torch.zeros_like(x[k]) for k in ("dq", "dk", "dv")]
    want = block_grads_plain(*args, *zeros, **kw)
    for name, g, w in zip(("dq", "dk", "dv"),
                          _block_grads_run(x, kw, zero=True), want):
        if float(w.abs().max()) > 0:
            _close(g, w, tol)
        else:   # the whole block lies in every row's future
            assert torch.equal(g, w), name
    # fold and dq rows that see no key; dk, dv rows that no query sees:
    # the bf16 kernels keep their bits; the fp32 ones keep their values
    # (they add +0.0 there, which turns a -0.0 into +0.0)
    def same(a, b):
        if dtype == torch.bfloat16:
            return torch.equal(_bits(a), _bits(b))
        return torch.equal(a, b)

    dead_q = torch.arange(tq, device=cuda_device) + shift < 0
    rows_k = torch.arange(tk, device=cuda_device)
    dead_k = (rows_k >= kv_len) | (rows_k - shift >= tq)
    for g, s in zip(fold, state):
        assert same(g[:, dead_q], s[:, dead_q])
    got = _block_grads_run(x, kw)
    assert same(got[0][:, dead_q], x["dq"][:, dead_q])
    for g, key in zip(got[1:], ("dk", "dv")):
        assert same(g[:, dead_k], x[key][:, dead_k])


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,q_off,k_off,causal", [
    (24, 2048, 2048, 64, 4096, 0, False),      # a past block of the ring
    (24, 2048, 2048, 64, 4096, 4096, True),    # the diagonal
    (6, 197, 197, 128, 197, 147, True),        # ragged, partly masked
    (4, 130, 70, 256, 0, 40, True)])           # Tq != Tk, column split
def test_block_kernels_are_deterministic_on_card(cuda_device, bh, tq, tk, d,
                                                 q_off, k_off, causal):
    """The fold's acc, m and l and the backward's dq, dk and dv of two
    launches from the same bf16 inputs and state are the same bits: each
    element is written once by the thread that owns it, with no
    atomics."""
    kw = {"q_off": q_off, "k_off": k_off, "causal": causal, "kv_len": tk}
    x = _block_case(cuda_device, bh, tq, tk, d, torch.bfloat16, seed=bh + d)
    for run in (_block_fold_run, _block_grads_run):
        for a, b in zip(run(x, kw), run(x, kw)):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 128, 256])
@pytest.mark.parametrize("site", ["future", "padded_keys"])
def test_block_kernels_leave_what_they_do_not_reach_bit_equal_on_card(
        cuda_device, d, site):
    """The bf16 block fold, dQ and dK/dV never write what they do not
    reach: a block wholly in the local rows' future leaves acc, m, l, dq,
    dk and dv the same bits, -0.0 included; keys past kv_len (here most
    of the block) keep their dk and dv bits while the live keys' rows
    change, and the fold, which sees the live keys, changes every row."""
    tq, tk = 197, 197
    kw = ({"q_off": 0, "k_off": 197, "causal": True, "kv_len": tk}
          if site == "future" else
          {"q_off": 394, "k_off": 0, "causal": False, "kv_len": 40})
    x = _block_case(cuda_device, 6, tq, tk, d, torch.bfloat16, seed=d)
    fold = _block_fold_run(x, kw)
    got = _block_grads_run(x, kw)
    if site == "future":
        for g, key in zip(fold + got, ("acc", "m", "l", "dq", "dk", "dv")):
            assert torch.equal(_bits(g), _bits(x[key])), key
    else:
        for g, key in zip(fold, ("acc", "m", "l")):
            assert not torch.equal(g, x[key]), key
        for g, key in zip(got[1:], ("dk", "dv")):
            assert torch.equal(_bits(g[:, 40:]), _bits(x[key][:, 40:])), key
            assert not torch.equal(g[:, :40], x[key][:, :40]), key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_causal_flash_kernels_match_plain_at_long_t(cuda_device, dtype, tol):
    """The counterpart of the JAX package's jagged causal kernels: the
    flash kernels' causal loop bound at T = 2048, where "auto" picks the
    jagged grids on the TPU."""
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    from distributed_vgg_f_tpu_torch.ops.flash_attention import (
        attention_dkv, attention_dq)
    q, k, v, do, fwd, delta_of = _flash_case(cuda_device, 4, 2048, 6, 64,
                                             dtype, "dense", seed=5)
    kw = {"causal": True, "kv_len": None}
    o, lse = flash_cuda.flash_fwd_cuda(q, k, v, **kw)
    o_ref, lse_ref = fwd(q, k, v, **kw)
    delta = delta_of(do, o_ref)
    dq = flash_cuda.flash_dq_cuda(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = flash_cuda.flash_dkv_cuda(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    _close(o, o_ref, tol)
    _close(lse, lse_ref, 1e-5)
    _close(dq, attention_dq(q, k, v, do, lse_ref, delta, **kw), tol)
    dk_ref, dv_ref = attention_dkv(q, k, v, do, lse_ref, delta, **kw)
    _close(dk, dk_ref, tol)
    _close(dv, dv_ref, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_entry_points_on_one_card(cuda_device, dtype,
                                                    causal):
    """Without a process group each entry point is a ring (or an
    all-to-all) of one: ring x flash, the einsum ring and Ulysses (flash)
    equal flash_self_attention, forward and backward, and ring x flash
    launches one block fold, dQ and dK/dV step each."""
    from distributed_vgg_f_tpu_torch.ops import flash_cuda
    from distributed_vgg_f_tpu_torch.ops.flash_attention import \
        flash_self_attention
    from distributed_vgg_f_tpu_torch.parallel.ring_attention import \
        ring_self_attention
    from distributed_vgg_f_tpu_torch.parallel.ring_flash import \
        ring_flash_attention
    from distributed_vgg_f_tpu_torch.parallel.ulysses import \
        ulysses_self_attention
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, w = (torch.randn(2, 512, 6, 64, generator=gen,
                              device=cuda_device).to(dtype)
                  for _ in range(4))

    def run(fn):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*xs, causal=causal)
        out.backward(w)
        return [out.detach(), *(x.grad for x in xs)]

    want = run(flash_self_attention)
    fwd_tol, grad_tol = (2e-5, 5e-5) if dtype == torch.float32 else (3e-2,
                                                                     3e-2)
    before = flash_cuda.BLOCK_FWD_LAUNCHES, flash_cuda.BLOCK_DKV_LAUNCHES
    for fn in (ring_flash_attention, ring_self_attention,
               lambda *a, **kw: ulysses_self_attention(*a, kernel="flash",
                                                       **kw)):
        got = run(fn)
        for i, (g, r) in enumerate(zip(got, want)):
            torch.testing.assert_close(
                g.float(), r.float(), rtol=fwd_tol if i == 0 else grad_tol,
                atol=fwd_tol if i == 0 else grad_tol)
    assert (flash_cuda.BLOCK_FWD_LAUNCHES,
            flash_cuda.BLOCK_DKV_LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_sequence_parallel_across_four_cards(cuda_device, tmp_path):
    """The three entry points over a real 4-rank NCCL group, one card a
    rank (the ring's batch_isend_irecv hops and Ulysses' all-to-alls
    between cards), started by tests/_torch_sp_worker.py, against
    flash_self_attention over the whole sequence on one card: output and
    gradients of sum(out**2). Needs 4 cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices, one a rank of the NCCL group")
    from _torch_sp_worker import run_group

    from distributed_vgg_f_tpu_torch.ops.flash_attention import \
        flash_self_attention
    shape = (2, 2048, 6, 64)   # T_loc = 512 a rank; H = 6 pads to 8
    cases = [{"name": f"{kind}_{dtype}_{int(causal)}", "kind": kind,
              "dtype": dtype, "causal": causal}
             for kind in ("ring_flash", "ring", "ulysses_flash")
             for dtype in ("bfloat16", "float32")
             for causal in (False, True)]
    rng = np.random.default_rng(10)
    arrays = {f"{c['name']}/{key}": rng.standard_normal(shape).astype(
        np.float32) for c in cases for key in "qkv"}
    got = run_group(4, cases, arrays, str(tmp_path), timeout=600,
                    device="cuda")
    for c in cases:
        dtype = getattr(torch, c["dtype"])
        xs = [torch.from_numpy(arrays[f"{c['name']}/{key}"]).to(
            cuda_device, dtype).requires_grad_() for key in "qkv"]
        out = flash_self_attention(*xs, causal=c["causal"])
        (out.float() ** 2).sum().backward()
        want = [out.detach(), *(x.grad for x in xs)]
        fwd_tol, grad_tol = ((2e-5, 5e-5) if dtype == torch.float32
                             else (3e-2, 3e-2))
        for i, (key, w) in enumerate(zip(("out", "dq", "dk", "dv"), want)):
            tol = fwd_tol if i == 0 else grad_tol
            torch.testing.assert_close(
                torch.from_numpy(got[f"{c['name']}/{key}"]),
                w.float().cpu(), rtol=tol, atol=tol,
                msg=lambda m: f"{c['name']} {key}: {m}")

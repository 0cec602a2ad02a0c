"""The port on the card: the LRN kernel against its plain version at the
main path's shapes, and the VGG-F forward through the kernel against the
same forward on the CPU. Every test here needs a CUDA device and skips
without one; the file imports only the port, so it runs where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which the card's
machine does not need.)

Tolerances: kernel vs plain fp32 rtol 1e-5 (both sum five squares in
fp32; the kernel may fuse multiply-adds); bf16 rtol 8e-3, one bf16 ulp
(both round the same fp32 value, which may differ in its last bits).
The backward kernel vs the plain backward: the same, with atol 1e-5 in
fp32 (dx is a difference of two terms). Model on the card vs the CPU in
fp32 with TF32 off: rtol/atol 1e-4, for logits, for one train step's
parameter gradients (narrow model, 32 px) and for the updated
parameters."""

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
    lrn_cuda.LAUNCHES = 0
    try:
        with torch.no_grad():
            got = card(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert lrn_cuda.LAUNCHES == 2
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
            lrn_cuda.BWD_LAUNCHES = 0
            state.opt_count = 100  # past the warmup's LR-0 first update
            state, _ = step(state, batch, 0)
            torch.cuda.synchronize()
            out[dev] = ({k: p.grad.cpu() for k, p in
                         model.named_parameters()},
                        {k: p.detach().cpu() for k, p in
                         model.named_parameters()}, lrn_cuda.BWD_LAUNCHES)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert out["cpu"][2] == 0 and out["cuda"][2] == 2
    grads, params = out["cuda"][0], out["cuda"][1]
    assert grads["conv1.weight"].abs().max() > 0
    for k in grads:
        torch.testing.assert_close(grads[k], out["cpu"][0][k], rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(params[k], out["cpu"][1][k], rtol=1e-4,
                                   atol=1e-4)

"""The port's ring block functions, einsum ring and ring x flash
(distributed_vgg_f_tpu_torch/ops/flash_attention.py `flash_block_update`,
`flash_block_grads`; parallel/ring_attention.py; parallel/ring_flash.py)
against the JAX package's on the CPU.

The block functions run their plain versions here and are held against
JAX's `flash_block_update` / `flash_block_grads`, whose Pallas kernels run
in interpret mode, on the same inputs: fp32 within 1e-5 of the largest
reference value (the kernels sum in blocks with an online rescale, the
plain versions whole blocks at once), bf16 within 3e-2.

The rings run in 2 and 4 gloo processes (tests/_torch_sp_worker.py; one
process group per size, shared by the file's cases) and are held against
JAX's `ring_attention` and `ring_flash_attention` on a 2- and 4-device
CPU mesh: the output and the gradients of sum(out**2) within the JAX
tests' own tolerances (fp32 2e-5 forward, 5e-5 gradients; bf16 3e-2).
Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sp_worker import run_group
from distributed_vgg_f_tpu.ops import flash_attention as jflash
from distributed_vgg_f_tpu.parallel.mesh import MeshSpec, build_mesh
from distributed_vgg_f_tpu.parallel.ring_attention import ring_attention
from distributed_vgg_f_tpu.parallel.ring_flash import ring_flash_attention
from distributed_vgg_f_tpu_torch.ops import flash_cuda
from distributed_vgg_f_tpu_torch.ops.flash_attention import (
    flash_block_grads, flash_block_update)
from distributed_vgg_f_tpu_torch.parallel import ring_flash as pring_flash
from distributed_vgg_f_tpu_torch.parallel.ring_attention import (
    full_attention_reference, ring_self_attention)


@pytest.fixture
def interpret():
    old = jflash.INTERPRET
    jflash.INTERPRET = True    # CPU: run the Pallas kernels interpreted
    try:
        yield
    finally:
        jflash.INTERPRET = old


def _close(got, want, tol, what):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


# ------------------------------------------------------------ block steps
# (tq, tk, q_off, k_off, causal, kv_len, state, head dim); the state is
# "random", "virgin" (nothing seen yet: acc 0, m -inf, l 0) or "m_wins"
# (random, with every fourth row's m above every score of the block); the
# head dims are those of the JAX tests (8, 16) and the widest (256)
BLOCK_CASES = {
    "past_block": (64, 64, 64, 0, False, None, "random", 16),
    "past_block_kv_len": (64, 64, 64, 0, False, 40, "random", 16),
    "diagonal_causal": (128, 128, 128, 128, True, None, "virgin", 16),
    "partly_masked_causal": (64, 128, 64, 100, True, 100, "random", 16),
    "fully_past_causal": (64, 64, 256, 0, True, None, "random", 16),
    "past_block_d8": (64, 64, 64, 0, False, None, "random", 8),
    "diagonal_causal_d8": (64, 64, 64, 64, True, None, "virgin", 8),
    "past_block_kv_len_d256": (64, 64, 64, 0, False, 40, "random", 256),
    "diagonal_causal_d256": (128, 128, 0, 0, True, None, "virgin", 256),
    # diagonals shifted by no multiple of a tile (q_off - k_off = 37 and
    # -37), the second with Tq != Tk: the bf16 kernels' walks and masks
    "shifted_causal_kv_len_d64": (130, 130, 37, 0, True, 100, "random", 64),
    "negative_shift_causal_d128": (130, 70, 0, 37, True, 61, "random", 128),
    # a carried m that no score of the block reaches: those rows keep m's
    # bits (the bf16 fold compares in the scaled domain to keep them)
    "carried_m_wins_causal_d64": (130, 130, 37, 0, True, 100, "m_wins", 64),
}


def _block_inputs(tq, tk, virgin, seed, bh=3, d=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = {"q": f(bh, tq, d), "k": f(bh, tk, d), "v": f(bh, tk, d),
         "do": f(bh, tq, d), "acc": f(bh, tq, d), "m": f(bh, tq, 1),
         "l": rng.uniform(0.5, 2.0, (bh, tq, 1)).astype(np.float32),
         "lse": f(bh, tq, 1) + 3.0, "delta": f(bh, tq, 1),
         "dq": f(bh, tq, d), "dk": f(bh, tk, d), "dv": f(bh, tk, d)}
    if virgin:
        x["acc"][:] = 0.0
        x["m"][:] = -np.inf
        x["l"][:] = 0.0
    return x


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_update_and_grads_match_jax(interpret, case, dtype, tol):
    tq, tk, q_off, k_off, causal, kv_len, state, d = BLOCK_CASES[case]
    x = _block_inputs(tq, tk, state == "virgin", seed=len(case) + tq, d=d)
    if state == "m_wins":      # above every scaled score, masked or not
        top = np.abs(x["q"]).sum(-1).max() * np.abs(x["k"]).max() / d ** 0.5
        x["m"][:, ::4] = top + 1.0
    if kv_len is not None:     # padded keys start their accumulators at 0
        x["dk"][:, kv_len:] = 0.0
        x["dv"][:, kv_len:] = 0.0
    kw = {"q_off": q_off, "k_off": k_off, "causal": causal,
          "kv_len": kv_len}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = {k: jnp.asarray(v, jd if k in ("q", "k", "v", "do") else
                         jnp.float32) for k, v in x.items()}
    want_f = jflash.flash_block_update(jx["q"], jx["k"], jx["v"], jx["acc"],
                                       jx["m"], jx["l"], **kw)
    want_g = jflash.flash_block_grads(
        jx["q"], jx["k"], jx["v"], jx["do"], jx["lse"], jx["delta"],
        jx["dq"], jx["dk"], jx["dv"], **kw)
    tx = {k: torch.from_numpy(v).to(td if k in ("q", "k", "v", "do") else
                                    torch.float32) for k, v in x.items()}
    got_f = flash_block_update(tx["q"], tx["k"], tx["v"], tx["acc"],
                               tx["m"], tx["l"], **kw)
    got_g = flash_block_grads(tx["q"], tx["k"], tx["v"], tx["do"],
                              tx["lse"], tx["delta"], tx["dq"], tx["dk"],
                              tx["dv"], **kw)
    # the state is updated in place and returned
    assert got_f[0] is tx["acc"] and got_g[2] is tx["dv"]
    if state == "m_wins":
        assert torch.equal(got_f[1][:, ::4],
                           torch.from_numpy(x["m"][:, ::4]))
    for name, g, w in zip(("acc", "m", "l", "dq", "dk", "dv"),
                          (*got_f, *got_g), (*want_f, *want_g)):
        w = np.asarray(w)
        if name == "m":        # -inf where nothing was ever live
            np.testing.assert_array_equal(np.isinf(g.numpy()), np.isinf(w))
            g, w = np.nan_to_num(g.numpy(), neginf=0.0), \
                np.nan_to_num(w, neginf=0.0)
        _close(g, w, tol, f"{case} {name}")
    if kv_len is not None:
        assert (got_g[1][:, kv_len:] == 0).all()
        assert (got_g[2][:, kv_len:] == 0).all()


def test_fully_future_block_changes_nothing():
    """A block wholly in the queries' future folds as the identity, also
    into a state that has seen nothing (m = -inf, l = 0): no NaN."""
    x = _block_inputs(64, 64, virgin=True, seed=5)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    acc, m, l = (t[k].clone() for k in ("acc", "m", "l"))
    flash_block_update(t["q"], t["k"], t["v"], acc, m, l, q_off=0,
                       k_off=64, causal=True)
    assert torch.equal(acc, t["acc"]) and torch.equal(l, t["l"])
    assert torch.isneginf(m).all()
    dq, dk, dv = (t[k].clone() for k in ("dq", "dk", "dv"))
    flash_block_grads(t["q"], t["k"], t["v"], t["do"], t["lse"],
                      t["delta"], dq, dk, dv, q_off=0, k_off=64, causal=True)
    for a, b in ((dq, "dq"), (dk, "dk"), (dv, "dv")):
        assert torch.equal(a, t[b])


def test_block_functions_launch_no_kernel_on_the_cpu():
    counts = (flash_cuda.BLOCK_FWD_LAUNCHES, flash_cuda.BLOCK_DQ_LAUNCHES,
              flash_cuda.BLOCK_DKV_LAUNCHES)
    x = {k: torch.from_numpy(v) for k, v in
         _block_inputs(64, 64, False, seed=6).items()}
    flash_block_update(x["q"], x["k"], x["v"], x["acc"], x["m"], x["l"],
                       q_off=0, k_off=0, causal=True)
    flash_block_grads(x["q"], x["k"], x["v"], x["do"], x["lse"],
                      x["delta"], x["dq"], x["dk"], x["dv"], q_off=0,
                      k_off=0, causal=True)
    assert (flash_cuda.BLOCK_FWD_LAUNCHES, flash_cuda.BLOCK_DQ_LAUNCHES,
            flash_cuda.BLOCK_DKV_LAUNCHES) == counts


def test_block_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, 8, 32)
    s = torch.zeros(2, 8, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_cuda.flash_block_fwd_cuda(q, q, q, q, s, s, q_off=0, k_off=0,
                                        causal=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_cuda.flash_block_dq_cuda(q, q, q, q, s, s, q, q_off=0,
                                       k_off=0, causal=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_cuda.flash_block_dkv_cuda(q, q, q, q, s, s, q, q, q_off=0,
                                        k_off=0, causal=False)


@pytest.mark.parametrize("kw,match", [
    ({"kv_len": 0}, "outside"), ({"kv_len": 9}, "outside")])
def test_block_functions_refuse_bad_kv_len(kw, match):
    q = torch.zeros(2, 8, 16)
    s = torch.zeros(2, 8, 1)
    with pytest.raises(ValueError, match=match):
        flash_block_update(q, q, q, q, s, s, q_off=0, k_off=0, causal=False,
                           **kw)
    with pytest.raises(ValueError, match=match):
        flash_block_grads(q, q, q, q, s, s, q, q, q, q_off=0, k_off=0,
                          causal=False, **kw)


def test_block_functions_refuse_mismatched_blocks():
    q = torch.zeros(2, 8, 16)
    s = torch.zeros(2, 8, 1)
    with pytest.raises(ValueError, match="expected"):
        flash_block_update(q, q[:1], q[:1], q, s, s, q_off=0, k_off=0,
                           causal=False)
    with pytest.raises(ValueError, match="expected"):
        flash_block_update(q, q[..., :8], q[..., :8], q, s, s, q_off=0,
                           k_off=0, causal=False)


def _bf16_rows(*shape, offset=0):
    """A bf16 tensor of `shape` whose data start `offset` elements into
    its storage (offset 1: no row starts on 16 bytes)."""
    n = int(np.prod(shape))
    buf = torch.arange(n + offset, dtype=torch.float32).to(torch.bfloat16)
    return buf[offset:].view(*shape)


@pytest.mark.parametrize("layout,copied", [
    ("dense", (False, False, False, False)),      # D = 64 on 16 bytes
    ("narrow", (True, True, True, True)),         # D = 12: no row on 16
    ("ragged_tk", (False, False, False, False)),  # Tq != Tk, D = 64
    ("misaligned_k", (False, True, False, False)),
    ("misaligned_do", (False, False, False, True)),
    # the fold's call: q, k_blk and v_blk, no dO
    ("fold_dense", (False, False, False)),
    ("fold_narrow", (True, True, True)),
    ("fold_misaligned_k", (False, True, False))])
def test_block_tma_inputs_copy_only_what_a_tensor_map_cannot_read(layout,
                                                                  copied):
    """The bf16 block wrappers' layout rule: each of q, k_blk, v_blk and
    dO (the fold passes none) that a tensor map cannot read in place is
    copied alone; every tensor the kernels get holds the same values, is
    readable in place and has rows d rounded up to 8 elements apart (the
    row stride the kernels assume)."""
    fold = layout.startswith("fold_")
    layout = layout.removeprefix("fold_")
    bh, tq, d = 3, 5, 12 if layout == "narrow" else 64
    tk = 7 if layout == "ragged_tk" else tq
    off = {name: 1 if layout == f"misaligned_{name}" else 0
           for name in ("q", "k", "v", "do")}
    xs = (_bf16_rows(bh, tq, d, offset=off["q"]),
          _bf16_rows(bh, tk, d, offset=off["k"]),
          _bf16_rows(bh, tk, d, offset=off["v"]),
          _bf16_rows(bh, tq, d, offset=off["do"]))
    if fold:
        *got, do = flash_cuda._block_tma_inputs(*xs[:3])
        assert do is None
        xs = xs[:3]
    else:
        got = flash_cuda._block_tma_inputs(*xs)
    ld = -(-d // 8) * 8
    for x, y in zip(xs, got):
        assert torch.equal(x, y) and flash_cuda._tma_ready(y)
        assert y.stride() == (x.shape[1] * ld, ld, 1)
    assert [y is not x for x, y in zip(xs, got)] == list(copied)


# ------------------------------------------------------------------ rings
# name -> (kind, dtype, causal, global (B, T, H, D))
def _ring_cases(n):
    cases = {
        "ring_f32": ("ring", "float32", False, (2, 64, 2, 16)),
        "ring_f32_causal": ("ring", "float32", True, (2, 64, 2, 16)),
        "ring_bf16_causal": ("ring", "bfloat16", True, (2, 64, 2, 16)),
        "flash_f32": ("ring_flash", "float32", False, (2, 32, 2, 16)),
        "flash_f32_causal": ("ring_flash", "float32", True, (2, 32, 2, 16)),
        "flash_bf16_causal": ("ring_flash", "bfloat16", True,
                              (2, 64, 2, 16)),
        # the prime local length of tests/test_ring_flash.py: 197 a rank
        "flash_prime": ("ring_flash", "float32", False, (1, 197 * n, 1, 16)),
        "flash_prime_causal": ("ring_flash", "float32", True,
                               (1, 197 * n, 1, 16)),
    }
    return cases


CASE_NAMES = sorted(_ring_cases(2))


def _inputs(name, shape, n):
    rng = np.random.default_rng([n, len(name), sum(map(ord, name))])
    return [rng.standard_normal(shape).astype(np.float32) for _ in "qkv"]


@pytest.fixture(scope="module")
def port_rings(tmp_path_factory):
    """The port's results per ring size, each size run once in its own
    gloo group."""
    cache = {}

    def get(n):
        if n not in cache:
            cases, arrays = [], {}
            for name, (kind, dtype, causal, shape) in _ring_cases(n).items():
                cases.append({"name": name, "kind": kind, "dtype": dtype,
                              "causal": causal})
                for key, a in zip("qkv", _inputs(name, shape, n)):
                    arrays[f"{name}/{key}"] = a
            cache[n] = run_group(n, cases, arrays,
                                 str(tmp_path_factory.mktemp(f"ring{n}")))
        return cache[n]
    return get


def _jax_ring(kind, n, causal, dtype, q, k, v):
    mesh = build_mesh(MeshSpec(("data",), (n,)), devices=jax.devices()[:n])
    fn = ring_attention if kind == "ring" else ring_flash_attention

    def loss(q, k, v):
        out = fn(q, k, v, mesh, causal=causal)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    args = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(*args)
    return [np.asarray(x, np.float32) for x in (out, *grads)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_ring_matches_jax_mesh(interpret, devices8, port_rings, n, name):
    kind, dtype, causal, shape = _ring_cases(n)[name]
    got = port_rings(n)
    want = _jax_ring(kind, n, causal, dtype, *_inputs(name, shape, n))
    fwd_tol, grad_tol = ((2e-5, 5e-5) if dtype == "float32"
                         else (3e-2, 3e-2))
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        tol = fwd_tol if key == "out" else grad_tol
        np.testing.assert_allclose(got[f"{name}/{key}"], w, rtol=tol,
                                   atol=tol, err_msg=f"{name} {key} n={n}")


def test_single_process_ring_is_full_attention():
    """Without a process group the ring has one rank: both rings equal the
    plain attention, forward and backward."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs("single", (2, 40, 3, 16), 1))
    for causal in (False, True):
        want = full_attention_reference(q, k, v, causal=causal)
        gw = torch.autograd.grad((want ** 2).sum(), (q, k, v))
        for fn in (ring_self_attention, pring_flash.ring_flash_attention):
            got = fn(q, k, v, causal=causal)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
            gg = torch.autograd.grad((got ** 2).sum(), (q, k, v))
            for a, b in zip(gg, gw):
                torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-5)


def test_ring_flash_refuses_bad_shards():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="shape"):
        pring_flash.ring_flash_attention(q, q, q[:, :4])
    with pytest.raises(ValueError, match="dtype"):
        pring_flash.ring_flash_attention(q, q, q.double())


def test_initialize_distributed_checks_its_arguments():
    from distributed_vgg_f_tpu_torch.parallel.distributed import \
        initialize_distributed
    assert initialize_distributed(device="cpu") is False   # nothing given
    with pytest.raises(ValueError, match="num_processes and process_id"):
        initialize_distributed("localhost:1", device="cpu")
    with pytest.raises(ValueError, match="outside"):
        initialize_distributed("localhost:1", 2, 2, device="cpu")
    assert not torch.distributed.is_initialized()

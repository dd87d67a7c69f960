"""Kernel B2's plain versions (``vit_ssl_tpu_torch.ops.flash_blockwise``)
against the JAX package's ``blockwise_attention`` and
``blockwise_attention_lse``, on the CPU.

The same numpy inputs go through JAX's kernels in interpret mode with
explicit small blocks (as ``tests/test_flash_blockwise.py`` runs them) and
through the port's CPU path, which is the plain PyTorch version of each
kernel. fp32: forward and lse at 1e-5, gradients (with and without an lse
cotangent) at atol 1e-5 / rtol 1e-4, tighter than JAX's own test against
its jnp reference (2e-4 / 1e-3): both sides compute in fp32 and differ
only in the order of sums. bf16: the port's forward at JAX's key block
rounds p at the same points, so it is held to one bf16 ulp (2⁻⁸ relative,
atol/rtol 1e-2) and measured equal. Also P1 (the exp2 form) against
``scripts/exp2_probe.py::fwd_exp2``, the routing of long sequences to B2,
and what the kernel wrappers refuse.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.ops import MultiHeadAttention as JaxMHA
from vit_ssl_tpu.ops.flash_blockwise import blockwise_attention_lse as jax_lse
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import MultiHeadAttention
from vit_ssl_tpu_torch.ops import attention as attention_mod
from vit_ssl_tpu_torch.ops import flash_blockwise as fb

REPO = Path(__file__).resolve().parent.parent
FP32_FWD = dict(atol=1e-5, rtol=1e-5)
FP32_GRAD = dict(atol=1e-5, rtol=1e-4)
BF16 = dict(atol=1e-2, rtol=1e-2)


def _inputs(n, b=2, h=2, d=32, seed=0):
    """q, k, v, the output cotangent and the lse cotangent, as numpy."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3)]
    return (*qkv, rng.standard_normal((b, h, n, d)).astype(np.float32),
            rng.standard_normal((b, h, n)).astype(np.float32))


def _jax(q, k, v, go, gl, block, dtype=jnp.float32):
    """JAX's (o, lse) and the gradients of <o, go> + <lse, gl> (gl may be
    None: the output cotangent alone)."""
    scale = q.shape[-1] ** -0.5

    def f(q, k, v):
        return jax_lse(q, k, v, scale, block, block, True)

    (o, lse), vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    dlse = jnp.zeros_like(lse) if gl is None else jnp.asarray(gl)
    grads = vjp((jnp.asarray(go, dtype), dlse))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(o), f32(lse), [f32(g) for g in grads]


def _port(q, k, v, go, gl, dtype=torch.float32, fn=fb.blockwise_attention_lse):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o, lse = fn(*ts, q.shape[-1] ** -0.5)
    cots = [torch.from_numpy(go).to(dtype)]
    outs = [o]
    if gl is not None:
        outs.append(lse)
        cots.append(torch.from_numpy(gl))
    torch.autograd.backward(outs, cots)
    return o, lse, [t.grad for t in ts]


@pytest.mark.parametrize("n,block", [(160, 64), (96, 32), (70, 64), (1, 8)],
                         ids=["n160", "n96", "ragged70", "n1"])
@pytest.mark.parametrize("with_dlse", [True, False], ids=["dlse", "no-dlse"])
def test_fp32_matches_jax(n, block, with_dlse):
    """Forward o and lse, and dq/dk/dv with a random lse cotangent (folded
    into δ) or without one, at a block-multiple, a ragged and a one-token N."""
    q, k, v, go, gl = _inputs(n, seed=n)
    gl = gl if with_dlse else None
    want_o, want_lse, want_g = _jax(q, k, v, go, gl, block)
    o, lse, grads = _port(q, k, v, go, gl)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert lse.shape == (2, 2, n)
    np.testing.assert_allclose(o.detach().numpy(), want_o, **FP32_FWD)
    np.testing.assert_allclose(lse.detach().numpy(), want_lse, **FP32_FWD)
    for name, got, want in zip("qkv", grads, want_g):
        np.testing.assert_allclose(got.numpy(), want, **FP32_GRAD, err_msg=f"d{name}")


@pytest.mark.parametrize("block_k", [None, 32, 64, 7])
def test_fp32_forward_does_not_depend_on_the_key_blocks(block_k):
    """In fp32 the partition only reorders sums: every block_k gives JAX's
    output at 1e-5."""
    q, k, v, go, gl = _inputs(96, seed=3)
    want_o, want_lse, _ = _jax(q, k, v, go, gl, 32)
    o, lse = fb.blockwise_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), q.shape[-1] ** -0.5, block_k)
    np.testing.assert_allclose(o.numpy(), want_o, **FP32_FWD)
    np.testing.assert_allclose(lse.numpy(), want_lse, **FP32_FWD)


def test_bf16_matches_jax_at_its_blocks():
    """bf16 inputs: the plain forward at JAX's key block rounds the
    unnormalised p where JAX's kernel does, so o is equal to one bf16 ulp
    (measured bit-equal); lse is fp32. The gradients, at JAX's rounding
    points (p cast for dv, ds cast before dq and dk), agree to a bf16 ulp
    of their largest entry."""
    q, k, v, go, gl = _inputs(96, seed=4)
    want_o, want_lse, want_g = _jax(q, k, v, go, gl, 32, jnp.bfloat16)
    ts = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    scale = q.shape[-1] ** -0.5
    o, lse = fb.blockwise_attention_reference(*ts, scale, block_k=32)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), want_o, **BF16)
    np.testing.assert_allclose(lse.numpy(), want_lse, **FP32_FWD)
    _, _, grads = _port(q, k, v, go, gl, torch.bfloat16)
    for name, got, want in zip("qkv", grads, want_g):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=1e-2 * np.abs(want).max(), rtol=0,
                                   err_msg=f"d{name}")


def _exp2_probe():
    spec = importlib.util.spec_from_file_location(
        "exp2_probe", REPO / "scripts" / "exp2_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exp2_form_matches_the_probe(dtype):
    """P1's plain version against ``scripts/exp2_probe.py::fwd_exp2`` (in
    interpret mode) at its blocks: fp32 at 1e-5, bf16 at one bf16 ulp; and
    its lse, returned as natural log, against B2's at 1e-5."""
    q, k, v, *_ = _inputs(100, seed=5)
    scale = q.shape[-1] ** -0.5
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(_exp2_probe().fwd_exp2(
        *(jnp.asarray(x, jd) for x in (q, k, v)), scale, 32, 32), np.float32)
    ts = [torch.from_numpy(x).to(td) for x in (q, k, v)]
    o, lse = fb.blockwise_attention_exp2_reference(*ts, scale, block_k=32)
    np.testing.assert_allclose(o.float().numpy(), want,
                               **(FP32_FWD if dtype == "float32" else BF16))
    _, lse_exp = fb.blockwise_attention_reference(*ts, scale, block_k=32)
    np.testing.assert_allclose(lse.numpy(), lse_exp.numpy(), **FP32_FWD)
    o_cpu, lse_cpu = fb.blockwise_attention_fwd_exp2(*ts, scale)
    o_one, lse_one = fb.blockwise_attention_exp2_reference(*ts, scale)
    assert torch.equal(o_cpu, o_one) and torch.equal(lse_cpu, lse_one)


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors the kernel wrappers are the plain versions and launch
    nothing; blockwise_attention is blockwise_attention_lse's output, and
    the plain yardsticks give the same values and gradients."""
    q, k, v, go, gl = _inputs(50, seed=6)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    scale = q.shape[-1] ** -0.5
    before = dict(kernels.launches)
    o, lse = fb.blockwise_attention_fwd(*ts, scale)
    want_o, want_lse = fb.blockwise_attention_reference(*ts, scale)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    grads = fb.blockwise_attention_bwd(*ts, o, lse, torch.from_numpy(go), scale,
                                       torch.from_numpy(gl))
    want = fb.blockwise_attention_bwd_reference(*ts, o, lse, torch.from_numpy(go),
                                                scale, torch.from_numpy(gl))
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    dq, delta = fb.blockwise_attention_bwd_dq(*ts, o, lse, torch.from_numpy(go), scale,
                                              torch.from_numpy(gl))
    dk, dv = fb.blockwise_attention_bwd_dkv(*ts, torch.from_numpy(go), lse, delta, scale)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))
    torch.testing.assert_close(
        delta, (torch.from_numpy(go) * o).sum(-1) - torch.from_numpy(gl))
    assert torch.equal(fb.blockwise_attention(*ts, scale), o)
    assert torch.equal(fb.blockwise_attention_plain(*ts, scale), o)
    _, _, g1 = _port(q, k, v, go, None, fn=lambda *a: (fb.blockwise_attention(*a), None))
    _, _, g2 = _port(q, k, v, go, None,
                     fn=lambda *a: (fb.blockwise_attention_plain(*a), None))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert dict(kernels.launches) == before


def test_kernel_checks_refuse_what_the_kernels_cannot_take():
    """What ``_check`` refuses before a launch, each naming what is taken;
    P1 takes bf16 only; another device type is refused."""
    x = torch.zeros(2, 2, 37, 64)
    with pytest.raises(ValueError, match="head dim 48"):
        fb._check(*[torch.zeros(2, 2, 37, 48)] * 3)
    with pytest.raises(ValueError, match=r"expected \(B, H, N, D\)"):
        fb._check(*[torch.zeros(2, 37, 64)] * 3)
    with pytest.raises(ValueError, match="float32, bfloat16"):
        fb._check(*[torch.zeros(2, 2, 37, 64, dtype=torch.float16)] * 3)
    with pytest.raises(ValueError, match="contiguous"):
        fb._check(x, x.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError, match="differs from q"):
        fb._check(x, torch.zeros(2, 2, 36, 64), x)
    with pytest.raises(ValueError, match="< 1"):
        fb._check(*[torch.zeros(2, 2, 0, 64)] * 3)
    shifted = torch.zeros(2 * 2 * 37 * 64 + 1)[1:].view(2, 2, 37, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fb._check(x, x, shifted)
    assert fb._check(x, x, x) == (2, 2, 37, 64)
    assert fb._check(*[torch.zeros(1, 1, 4097, 128)] * 3) == (1, 1, 4097, 128)
    with pytest.raises(ValueError, match="lse"):
        fb._check_rows("lse", torch.zeros(2, 2, 36), (2, 2, 37), torch.float32,
                       x.device)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fb.blockwise_attention(*[torch.zeros(1, 1, 4, 32, device="meta")] * 3, 1.0)


def test_multi_head_attention_routes_long_sequences_to_b2(monkeypatch):
    """N = 1088 > 1024 without a mask: MultiHeadAttention sends every call
    through ``blockwise_attention`` on contiguous (B, H, N, D) heads and
    matches the JAX module on the same weights (its own B2 path, interpret
    mode), output and input gradient, as ``tests/test_flash_blockwise.py``
    holds JAX's dispatch to its XLA path."""
    calls = []
    real = attention_mod.blockwise_attention
    monkeypatch.setattr(attention_mod, "blockwise_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 1088, 32)).astype(np.float32)
    g = rng.standard_normal((1, 1088, 32)).astype(np.float32)
    jax_mha = JaxMHA(d_model=32, num_heads=2, use_flash=True)
    params = jax_mha.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want, vjp = jax.vjp(lambda xin: jax_mha.apply(params, xin), jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(g))
    mha = MultiHeadAttention(32, 2)
    p = params["params"]
    with torch.no_grad():
        for name in ("w_query", "w_key", "w_value", "final_linear"):
            getattr(mha, name).weight.copy_(
                torch.from_numpy(np.asarray(p[name]["kernel"]).T.copy()))
    xt = torch.from_numpy(x).requires_grad_()
    out = mha(xt)
    out.backward(torch.from_numpy(g))
    assert calls == [(1, 2, 1088, 16)]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=5e-5,
                               rtol=5e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), atol=5e-5,
                               rtol=5e-4)

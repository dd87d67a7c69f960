"""Kernel B1 forward in the PyTorch port (``vit_ssl_tpu_torch.ops.flash_attention``).

The plain PyTorch version (what the wrapper runs for a CPU tensor) is held
against the JAX package's ``attention_nhd`` run in interpret mode, on the
same numpy inputs; the wrapper's checks are exercised on the CPU. The CUDA
kernel itself is held against this plain version on the card, in
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.ops.flash_attention import attention_nhd as jax_attention_nhd
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import flash_attention as fa

# (batch, seq, heads, head_dim, block_size): the serving global, the packed
# DINO locals with their block-diagonal mask, and a narrow ragged case
CPU_CASES = [
    (2, 145, 6, 64, 0),
    (2, 148, 6, 64, 37),
    (3, 37, 2, 32, 0),
]

# bf16 outputs: one bf16 ulp is 2^-8 relative, and the two sides may round
# an fp32 value on either side of a tie
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, n, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h * d), dtype=np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d,bs", CPU_CASES)
def test_reference_matches_jax_interpret(b, n, h, d, bs, dtype):
    xs = _inputs(b, n, h, d, seed=n)
    scale = 1.0 / d ** 0.5
    want = jax_attention_nhd(*(jnp.asarray(x, dtype) for x in xs), h, scale,
                             True, bs)
    got = fa.attention_nhd_reference(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs), h, scale, bs
    )
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, n, h * d)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        **(FP32_TOL if dtype == "float32" else BF16_TOL),
    )


def test_wrapper_takes_plain_version_for_cpu_tensor():
    xq, xk, xv = (torch.from_numpy(x) for x in _inputs(2, 37, 2, 32))
    before = kernels.launches[fa.KERNEL]
    out = fa.attention_nhd(xq, xk, xv, 2, 0.125, 0)
    torch.testing.assert_close(
        out, fa.attention_nhd_reference(xq, xk, xv, 2, 0.125, 0), rtol=0, atol=0
    )
    assert kernels.launches[fa.KERNEL] == before  # no kernel ran


def test_wrapper_refuses_other_devices():
    x = torch.empty(2, 37, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.attention_nhd(x, x, x, 2, 0.125)


@pytest.mark.parametrize("shape,heads,dtype,bs,match", [
    ((2, 37, 96), 2, torch.float32, 0, "head dim 48"),
    ((2, 1025, 128), 2, torch.float32, 0, "sequence length 1025"),
    ((2, 37, 64), 2, torch.float16, 0, "not supported"),
    ((2, 37, 64), 3, torch.float32, 0, "does not split"),
    ((37, 64), 2, torch.float32, 0, "expected"),
    ((2, 37, 64), 2, torch.float32, -1, "block_size"),
])
def test_kernel_input_checks(shape, heads, dtype, bs, match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa._check(x, x, x, heads, bs)


def test_kernel_input_checks_layout():
    x = torch.zeros(2, 37, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check(x, x.transpose(0, 1).contiguous().transpose(0, 1), x, 2, 0)
    with pytest.raises(ValueError, match="differs"):
        fa._check(x, torch.zeros(2, 36, 64), x, 2, 0)
    shifted = torch.zeros(2 * 37 * 64 + 1)[1:].view(2, 37, 64)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check(x, x, shifted, 2, 0)
    assert fa._check(x, x, x, 2, 0) == 32


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    assert not (tmp_path / "_build").exists()


# B1's backward: (batch, seq, heads, head_dim, block_size)
BWD_CASES = [
    (2, 37, 2, 32, 0),
    (2, 148, 2, 32, 37),
    (1, 145, 6, 64, 0),
]
# bf16: p and ds round to bf16 on both sides, and the two frameworks' fp32
# exp and sums may put a value on either side of a rounding tie; one bf16
# ulp of a ds entry moves a gradient by 2^-8 of that term
BWD_BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _jax_grads(xs, do, h, scale, bs, dtype):
    import jax

    def f(q, k, v):
        return jax_attention_nhd(q, k, v, h, scale, True, bs)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in xs))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, dtype))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d,bs", BWD_CASES)
def test_bwd_reference_matches_jax_vjp(b, n, h, d, bs, dtype):
    xs = _inputs(b, n, h, d, seed=n + 1)
    do = np.random.default_rng(n + 2).standard_normal((b, n, h * d), dtype=np.float32)
    scale = 1.0 / d ** 0.5
    want = _jax_grads(xs, do, h, scale, bs, dtype)
    tdt = getattr(torch, dtype)
    got = fa.attention_nhd_bwd_reference(
        *(torch.from_numpy(x).to(tdt) for x in xs), torch.from_numpy(do), h,
        scale, bs)
    tol = FP32_TOL if dtype == "float32" else BWD_BF16_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == (b, n, h * d), name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **tol)


@pytest.mark.parametrize("b,n,h,d,bs", BWD_CASES)
def test_autograd_on_cpu_gives_jax_gradients(b, n, h, d, bs):
    """The Function on a CPU tensor: plain forward, plain backward, and the
    gradients equal JAX's kernel backward (fp32)."""
    xs = _inputs(b, n, h, d, seed=n + 1)
    do = np.random.default_rng(n + 2).standard_normal((b, n, h * d), dtype=np.float32)
    scale = 1.0 / d ** 0.5
    want = _jax_grads(xs, do, h, scale, bs, jnp.float32)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in xs)
    before = dict(kernels.launches)
    out = fa.attention_nhd(q, k, v, h, scale, bs)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))
    assert dict(kernels.launches) == before  # CPU: no kernel
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **FP32_TOL)


def test_autograd_uses_the_rounded_probabilities():
    """In bf16 the backward uses p rounded to bf16, as JAX's does; autograd
    through the plain forward would pass the rounding as the identity."""
    xs = [torch.from_numpy(x).bfloat16() for x in _inputs(2, 37, 2, 32, seed=5)]
    do = torch.randn(2, 37, 64, generator=torch.Generator().manual_seed(0))
    q, k, v = (x.clone().requires_grad_() for x in xs)
    got = torch.autograd.grad(fa.attention_nhd(q, k, v, 2, 0.125), (q, k, v), do)
    want = fa.attention_nhd_bwd_reference(*xs, do, 2, 0.125)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_stats_reference_rebuilds_the_probabilities():
    xq, xk, xv = (torch.from_numpy(x) for x in _inputs(2, 37, 2, 32, seed=6))
    stats = fa.attention_nhd_stats_reference(xq, xk, 2, 0.125, 5)
    assert stats.shape == (2, 2, 37, 2)
    s = fa._scores(xq, xk, 2, 0.125, 5)
    p = torch.exp(s - stats[..., :1]) * stats[..., 1:]
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 2, 37))
    torch.testing.assert_close(
        torch.matmul(p, fa._heads(xv, 2)),
        fa._heads(fa.attention_nhd_reference(xq, xk, xv, 2, 0.125, 5), 2))


def test_training_wrappers_take_plain_versions_on_cpu():
    xq, xk, xv = (torch.from_numpy(x) for x in _inputs(2, 37, 2, 32, seed=7))
    before = dict(kernels.launches)
    out, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, 2, 0.125)
    assert torch.equal(out, fa.attention_nhd_reference(xq, xk, xv, 2, 0.125))
    assert torch.equal(stats, fa.attention_nhd_stats_reference(xq, xk, 2, 0.125))
    grads = fa.attention_nhd_bwd(xq, xk, xv, out, stats, 2, 0.125)
    want = fa.attention_nhd_bwd_reference(xq, xk, xv, out, 2, 0.125)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert dict(kernels.launches) == before


def test_kernel_sources_cover_their_headers():
    """A header edit must rebuild every library that includes it."""
    for name in ("attention_nhd_fwd", "attention_nhd_bwd"):
        files = [f.name for f in kernels.source_files(name)]
        assert files == [f"{name}.cu", "attention_nhd_common.cuh"]


def test_stale_follows_headers(monkeypatch, tmp_path):
    import os

    (tmp_path / "csrc").mkdir()
    src, header = tmp_path / "csrc" / "k.cu", tmp_path / "csrc" / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    header.write_text("// shared\n")
    monkeypatch.setattr(kernels, "PACKAGE_DIR", tmp_path)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setitem(kernels.SOURCES, "k", "csrc/k.cu")
    (tmp_path / "_build").mkdir()
    lib = kernels.library_path("k")
    lib.write_bytes(b"")
    os.utime(src, (100, 100))
    os.utime(header, (100, 100))
    os.utime(lib, (200, 200))
    assert not kernels._stale("k")
    os.utime(header, (300, 300))  # only the header is newer than the library
    assert kernels._stale("k")

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
    s = fa._head_scores(fa._split(xq, 2), fa._split(xk, 2), 0.125, 5)
    p = torch.exp(s - stats[..., :1]) * stats[..., 1:]
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 2, 37))
    torch.testing.assert_close(
        torch.matmul(p, fa._split(xv, 2)),
        fa._split(fa.attention_nhd_reference(xq, xk, xv, 2, 0.125, 5), 2))


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
    """A header edit must rebuild every library that includes it: B1's two
    libraries and B3's share the CUDA-core bodies and the common header; B1's
    forward library and B3's share the bf16 Hopper forward
    (``attention_fwd_sm90.cuh``, over the primitives of
    ``sm90_common.cuh``); B1's backward library and B3's share the bf16
    Hopper backward (``attention_bwd_sm90.cuh``)."""
    want = {
        "attention_nhd_fwd": {"attention_nhd_fwd.cu", "attention_fwd.cuh",
                              "attention_fwd_sm90.cuh", "sm90_common.cuh"},
        "attention_nhd_bwd": {"attention_nhd_bwd.cu", "attention_bwd.cuh",
                              "attention_bwd_sm90.cuh", "sm90_common.cuh"},
        "fused_attention": {"fused_attention.cu", "attention_fwd.cuh",
                            "attention_bwd.cuh", "attention_fwd_sm90.cuh",
                            "attention_bwd_sm90.cuh", "sm90_common.cuh"},
    }
    for name, files in want.items():
        got = [f.name for f in kernels.source_files(name)]
        assert got[0] == f"{name}.cu" and len(got) == len(set(got))
        assert set(got) == files | {"attention_nhd_common.cuh"}


# (library, sm90 header, reached): B1's forward reaches the Hopper forward
# and its primitives, B1's backward the Hopper backward and the same
# primitives; neither reaches the other's Hopper body or B2's Hopper forward
B1_SM90_REACH = [
    ("attention_nhd_fwd", "attention_fwd_sm90", True),
    ("attention_nhd_fwd", "sm90_common", True),
    ("attention_nhd_fwd", "attention_bwd_sm90", False),
    ("attention_nhd_fwd", "flash_blockwise_fwd_sm90", False),
    ("attention_nhd_bwd", "attention_fwd_sm90", False),
    ("attention_nhd_bwd", "sm90_common", True),
    ("attention_nhd_bwd", "attention_bwd_sm90", True),
    ("attention_nhd_bwd", "flash_blockwise_fwd_sm90", False),
]


@pytest.mark.parametrize("name,header,reached", B1_SM90_REACH)
def test_b1_libraries_reach_only_their_sm90_headers(name, header, reached):
    """An edit to a Hopper header rebuilds exactly the B1 libraries that
    compile it: the forward's for the Hopper forward, the backward's for the
    Hopper backward, both for their shared primitives. A
    header a library does not include is not named by its sources either
    (nothing of it is instantiated there), except in the comments of
    ``sm90_common.cuh``, which list the bodies over it."""
    files = kernels.source_files(name)
    assert (f"{header}.cuh" in {f.name for f in files}) == reached
    if not reached:
        text = "".join(f.read_text() for f in files if f.name != "sm90_common.cuh")
        assert header not in text


@pytest.mark.parametrize("n,form", [(1, "one-pass"), (64, "one-pass"), (65, "one-pass"),
                                    (145, "one-pass"), (148, "one-pass"),
                                    (197, "one-pass"), (256, "one-pass"),
                                    (257, "two-pass"), (577, "two-pass"),
                                    (1024, "two-pass")])
def test_b1_forward_form_follows_the_sequence_length(n, form):
    """The host rule: one pass up to ONE_PASS_MAX_SEQ (DINO's 145 and 148),
    two passes above, up to MAX_SEQ; the form names its kernel."""
    assert fa.attention_nhd_form(n) == form
    assert fa.FORWARD_BODIES[form].endswith("_sm90_kernel")


@pytest.mark.parametrize("n", [0, fa.MAX_SEQ + 1])
def test_b1_forward_form_refuses_lengths_the_kernels_do_not_take(n):
    with pytest.raises(ValueError, match=f"sequence length {n}"):
        fa.attention_nhd_form(n)


def test_one_pass_limit_is_the_kernels():
    """ONE_PASS_MAX_SEQ is the header's kOnePassTiles key tiles of kKeys
    (the tile of ``sm90_common.cuh``, which the Hopper bodies share), and
    each form's kernel name is a kernel of that header."""
    import re

    header = (kernels.CSRC_DIR / "attention_fwd_sm90.cuh").read_text()
    common = (kernels.CSRC_DIR / "sm90_common.cuh").read_text()
    tiles = re.findall(r"constexpr int kOnePassTiles = (\d+);", header)
    keys = re.findall(r"constexpr int kKeys = (\d+);", common)
    assert len(tiles) == len(keys) == 1
    assert fa.ONE_PASS_MAX_SEQ == int(tiles[0]) * int(keys[0])
    for name in fa.FORWARD_BODIES.values():
        assert re.search(rf"\b{name}\(", header), name


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


# ---------------------------------------------------------------------------
# Kernel B3: fused_attention on (B, H, N, D), no mask. JAX's runs in
# interpret mode, as tests/test_flash_attention.py runs it.

# (batch, heads, seq, head_dim): ragged N (the TPU kernel pads 13 to 16 and
# 70 to 72), D 32 and 64
FUSED_CASES = [(2, 3, 13, 32), (1, 2, 70, 64)]


def _heads_inputs(b, h, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d), dtype=np.float32) for _ in range(3)]


def _jax_fused(xs, scale, dtype):
    from vit_ssl_tpu.ops.flash_attention import fused_attention as jax_fused

    return jax_fused(*(jnp.asarray(x, dtype) for x in xs), scale, True)


def _jax_fused_grads(xs, do, scale, dtype):
    import jax
    from vit_ssl_tpu.ops.flash_attention import fused_attention as jax_fused

    _, vjp = jax.vjp(lambda q, k, v: jax_fused(q, k, v, scale, True),
                     *(jnp.asarray(x, dtype) for x in xs))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, dtype))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,n,d", FUSED_CASES)
def test_fused_reference_matches_jax_interpret(b, h, n, d, dtype):
    """Forward at FP32_TOL (fp32) and BF16_TOL (bf16)."""
    xs = _heads_inputs(b, h, n, d, seed=n)
    scale = 1.0 / d ** 0.5
    want = _jax_fused(xs, scale, dtype)
    got = fa.fused_attention_reference(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs), scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, n, d)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        **(FP32_TOL if dtype == "float32" else BF16_TOL))


def _share_differing(got, want) -> float:
    return float(np.mean(np.asarray(got, np.float32) != np.asarray(want, np.float32)))


@pytest.mark.parametrize("n", [70, 577])
def test_fused_training_forward_rounds_after_normalising(n):
    """The contract B3's bf16 forward kernel is held to: pn = bf16(p / l),
    rounded after normalising. The plain training forward agrees with JAX's
    ``_attn_kernel`` (interpret mode) but for sums in another order (under 1 %
    of outputs, one bf16 ulp); so does P.V rebuilt from its statistics as the
    kernels rebuild it (pn = bf16(exp(s - m) * (1/l))); online rounding (p
    rounded relative to the running max before normalising, B2's form, at
    64-key tiles) differs from JAX in a large share of outputs."""
    from vit_ssl_tpu_torch.ops import flash_blockwise as fb

    xs = _heads_inputs(1, 2, n, 64, seed=n + 5)
    scale = 0.125
    want = np.asarray(_jax_fused(xs, scale, jnp.bfloat16), np.float32)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in xs)
    out, stats = fa.fused_attention_fwd_stats(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and stats.shape == (1, 2, n, 2)
    np.testing.assert_allclose(out.float().numpy(), want, **BF16_TOL)
    assert _share_differing(out.float(), want) < 0.01

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    pn = (torch.exp(s - stats[..., :1]) * stats[..., 1:]).bfloat16().float()
    rebuilt = torch.matmul(pn, v.float()).bfloat16()
    assert _share_differing(rebuilt.float(), want) < 0.01

    online, _ = fb.blockwise_attention_reference(q, k, v, scale, block_k=64)
    assert not torch.equal(online, out)
    assert _share_differing(online.float(), want) > 0.2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,n,d", FUSED_CASES)
def test_fused_bwd_reference_matches_jax_vjp(b, h, n, d, dtype):
    """dq, dk, dv against JAX's kernel backward through ``jax.vjp``:
    FP32_TOL in fp32, BWD_BF16_TOL in bf16."""
    xs = _heads_inputs(b, h, n, d, seed=n + 1)
    do = np.random.default_rng(n + 2).standard_normal((b, h, n, d), dtype=np.float32)
    scale = 1.0 / d ** 0.5
    want = _jax_fused_grads(xs, do, scale, dtype)
    tdt = getattr(torch, dtype)
    got = fa.fused_attention_bwd_reference(
        *(torch.from_numpy(x).to(tdt) for x in xs), torch.from_numpy(do), scale)
    tol = FP32_TOL if dtype == "float32" else BWD_BF16_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == (b, h, n, d), name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **tol)


def _jax_fused_bwd_impl(xs, do, scale, dtype):
    """JAX's B3 backward (``_fused_attention_bwd_impl``, interpret mode) fed
    the probabilities its training forward saves."""
    from vit_ssl_tpu.ops.flash_attention import (_fused_attention_bwd_impl,
                                                 _fused_attention_fwd_impl)

    q, k, v = (jnp.asarray(x, dtype) for x in xs)
    _, probs = _fused_attention_fwd_impl(q, k, v, scale, True, save_probs=True)
    grads = _fused_attention_bwd_impl(q, k, v, probs, jnp.asarray(do, dtype), scale, True)
    return [np.asarray(g, np.float32) for g in grads]


def _bwd_from_statistics(q, k, v, do, stats, scale):
    """The bf16 backward kernel's arithmetic (``csrc/attention_bwd_sm90.cuh``)
    in plain PyTorch: p rebuilt from the training forward's statistics as
    2^(s·scale·log2e − m·log2e)·(1/l) rounded to bf16; δ = Σⱼ p·dp of that
    p (the dq kernel's first sweep); ds = bf16(p·(dp − δ)·scale); fp32
    products, each gradient rounded to bf16."""
    log2e = 1.4426950408889634
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = (torch.exp2(s * (scale * log2e) - stats[..., :1] * log2e)
         * stats[..., 1:]).bfloat16().float()
    g = do.bfloat16().float()
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).bfloat16().float()
    return (torch.matmul(ds, k.float()).bfloat16(),
            torch.matmul(ds.transpose(-1, -2), q.float()).bfloat16(), dv.bfloat16())


@pytest.mark.parametrize("b,h,n,d", [(2, 3, 13, 32), (1, 2, 70, 64), (2, 1, 1, 64),
                                     (1, 2, 130, 128)])
def test_fused_bwd_from_statistics_matches_jax_interpret(b, h, n, d):
    """B3's bf16 backward rebuilds p from the statistics (m, 1/l) where
    JAX's kernel reads the probabilities its forward saved; the emulation
    of the kernel's arithmetic agrees with JAX's ``_attn_bwd_kernel``
    (interpret mode) within BWD_BF16_TOL, ragged N and one key included."""
    xs = _heads_inputs(b, h, n, d, seed=n + 21)
    do = np.random.default_rng(n + 22).standard_normal((b, h, n, d), dtype=np.float32)
    scale = 1.0 / d ** 0.5
    want = _jax_fused_bwd_impl(xs, do, scale, jnp.bfloat16)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in xs)
    stats = fa.fused_attention_stats_reference(q, k, scale)
    got = _bwd_from_statistics(q, k, v, torch.from_numpy(do), stats, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **BWD_BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bwd_with_one_key_gives_zero_dq_and_dk(dtype):
    """With one key p = 1 and δ = Σⱼ p·dp = dp exactly, so ds, dq and dk are
    exactly 0 in JAX's kernel and in the plain version: the reason the
    bf16 kernel sums δ from p and dp rather than taking do·o (o rounded to
    bf16 leaves dp − δ as rounding noise)."""
    xs = _heads_inputs(2, 3, 1, 64, seed=23)
    do = np.random.default_rng(24).standard_normal((2, 3, 1, 64), dtype=np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = _jax_fused_bwd_impl(xs, do, 0.125, jdt)
    tdt = getattr(torch, dtype)
    got = fa.fused_attention_bwd_reference(
        *(torch.from_numpy(x).to(tdt) for x in xs), torch.from_numpy(do), 0.125)
    for g, w in zip(got[:2], want[:2]):
        assert not g.any() and not w.any()
    assert got[2].abs().max() > 0
    np.testing.assert_array_equal(got[2].float().numpy(), want[2])


@pytest.mark.parametrize("b,h,n,d", FUSED_CASES)
def test_fused_autograd_on_cpu_gives_jax_gradients(b, h, n, d):
    """The Function on a CPU tensor: plain forward and backward, no kernel,
    and fp32 gradients equal to JAX's kernel backward at FP32_TOL."""
    xs = _heads_inputs(b, h, n, d, seed=n + 3)
    do = np.random.default_rng(n + 4).standard_normal((b, h, n, d), dtype=np.float32)
    scale = 1.0 / d ** 0.5
    want = _jax_fused_grads(xs, do, scale, jnp.float32)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in xs)
    before = dict(kernels.launches)
    out = fa.fused_attention(q, k, v, scale)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))
    assert dict(kernels.launches) == before  # CPU: no kernel
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(_jax_fused(xs, scale, jnp.float32)),
                               **FP32_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **FP32_TOL)


def test_fused_autograd_uses_the_rounded_probabilities():
    """bf16: the backward takes p rounded to bf16, as JAX's does."""
    xs = [torch.from_numpy(x).bfloat16() for x in _heads_inputs(2, 2, 37, 32, seed=5)]
    do = torch.randn(2, 2, 37, 32, generator=torch.Generator().manual_seed(0))
    q, k, v = (x.clone().requires_grad_() for x in xs)
    got = torch.autograd.grad(fa.fused_attention(q, k, v, 0.125), (q, k, v), do)
    want = fa.fused_attention_bwd_reference(*xs, do, 0.125)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_fused_is_b1_on_the_head_major_layout():
    """B3's plain versions are B1's without the mask, heads split: equal bit
    for bit, forward, statistics and backward."""
    xq, xk, xv, do = (torch.from_numpy(x) for x in _inputs(2, 29, 3, 32, seed=8)
                      + _inputs(2, 29, 3, 32, seed=9)[:1])
    split = [fa._split(x, 3).contiguous() for x in (xq, xk, xv, do)]
    assert torch.equal(fa._unheads(fa.fused_attention_reference(*split[:3], 0.2),
                                   torch.float32),
                       fa.attention_nhd_reference(xq, xk, xv, 3, 0.2))
    assert torch.equal(fa.fused_attention_stats_reference(*split[:2], 0.2),
                       fa.attention_nhd_stats_reference(xq, xk, 3, 0.2))
    for g, w in zip(fa.fused_attention_bwd_reference(*split, 0.2),
                    fa.attention_nhd_bwd_reference(xq, xk, xv, do, 3, 0.2)):
        assert torch.equal(fa._unheads(g, torch.float32), w)


def test_fused_training_wrappers_take_plain_versions_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _heads_inputs(2, 2, 37, 32, seed=7))
    before = dict(kernels.launches)
    assert torch.equal(fa.fused_attention_fwd(q, k, v, 0.125),
                       fa.fused_attention_reference(q, k, v, 0.125))
    out, stats = fa.fused_attention_fwd_stats(q, k, v, 0.125)
    assert torch.equal(out, fa.fused_attention_reference(q, k, v, 0.125))
    assert torch.equal(stats, fa.fused_attention_stats_reference(q, k, 0.125))
    grads = fa.fused_attention_bwd(q, k, v, out, stats, 0.125)
    want = fa.fused_attention_bwd_reference(q, k, v, out, 0.125)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert fa.fused_attention_plain(q, k, v, 0.125).shape == q.shape
    assert dict(kernels.launches) == before


def test_fused_wrapper_refuses_other_devices():
    x = torch.empty(2, 2, 37, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.fused_attention(x, x, x, 0.125)


@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 2, 37, 48), torch.float32, "head dim 48"),
    ((2, 2, 1025, 64), torch.float32, "sequence length 1025"),
    ((2, 2, 37, 64), torch.float16, "not supported"),
    ((2, 37, 64), torch.float32, "expected"),
    ((2, 0, 37, 64), torch.float32, "grid limits"),
])
def test_fused_kernel_input_checks(shape, dtype, match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa._check_heads(x, x, x)


@pytest.mark.parametrize("scale", [0.0, -0.125, float("nan")])
def test_fused_bf16_kernel_refuses_a_non_positive_scale(scale):
    """The bf16 forward kernel takes the row max before scaling; fp32 and
    a positive scale pass the check (B1 and B3 share it)."""
    x = torch.zeros(1, 1, 4, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale must be positive"):
        fa._check_scale(x, scale)
    fa._check_scale(x, 0.125)
    fa._check_scale(x.float(), scale)


@pytest.mark.parametrize("scale", [0.0, -0.125, float("nan")])
@pytest.mark.parametrize("entry", ["attention_nhd_fwd", "attention_nhd_fwd_stats"])
def test_b1_bf16_wrappers_refuse_a_non_positive_scale(monkeypatch, entry, scale):
    """B1's two forward wrappers refuse a bf16 call with scale <= 0 by name
    before any launch (its Hopper body folds the scale into the exponent);
    an fp32 call with the same scale reaches the launch. Run on the meta
    device with the device check and the launch stubbed, as the card would
    run them."""
    launched = []
    monkeypatch.setattr(fa, "_require_cuda", lambda *a: None)
    monkeypatch.setattr(fa, "_launch", lambda name, *a: launched.append(name))
    x = torch.empty(2, 37, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="scale must be positive"):
        getattr(fa, entry)(x, x, x, 2, scale)
    assert launched == []
    y = torch.empty(2, 37, 128, device="meta")
    getattr(fa, entry)(y, y, y, 2, scale)
    assert launched == [{"attention_nhd_fwd": fa.KERNEL,
                         "attention_nhd_fwd_stats": fa.KERNEL_TRAIN}[entry]]


def test_fused_kernel_input_checks_layout():
    x = torch.zeros(2, 2, 37, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check_heads(x, x.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError, match="differs"):
        fa._check_heads(x, torch.zeros(2, 2, 36, 64), x)
    shifted = torch.zeros(2 * 2 * 37 * 64 + 1)[1:].view(2, 2, 37, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_heads(x, x, shifted)
    assert fa._check_heads(x, x, x) == (2, 2, 37, 64)


# ---------------------------------------------------------------------------
# Routing: the port picks the kernel family the JAX package's predicates pick

def _jax_route(b, n, h, hd, itemsize):
    """The JAX MultiHeadAttention's choice (``ops/attention.py:147-185``)
    for an unpacked self-attention with ``use_flash``."""
    from vit_ssl_tpu.ops import flash_attention as jfa

    if jfa.attention_nhd_profitable(n, b, h, hd, itemsize):
        return "B1"
    if not jfa.flash_attention_available(n):
        return "B2"
    if jfa.fused_attention_profitable(n, b * h):
        return "B3"
    return "XLA"


ROUTE_GRID = [
    (b, n, h, hd, itemsize)
    for b in (1, 16, 64, 256)
    for n, h, hd in ((37, 6, 384), (145, 6, 384), (148, 6, 384), (197, 12, 768),
                     (401, 12, 768), (512, 6, 384), (512, 12, 768),
                     (577, 6, 384), (577, 12, 768), (577, 16, 1024),
                     (1024, 6, 384), (1025, 12, 768), (2049, 6, 384))
    for itemsize in (2, 4)
]


def test_routing_matches_jax_predicates():
    """Over the grid: B3 wherever JAX picks B3, B1 wherever JAX picks B1, B2
    wherever JAX picks B2; where JAX's TPU timing gate picks XLA the port
    keeps its kernel of the same rule (B1 where B1 fits, else B3). ViT-B/16
    at 384 px is B3 on both sides and at 512 px (N = 1025) B2 on both sides,
    and every DINO ViT-S/8 shape is B1 for the port."""
    from vit_ssl_tpu.ops import flash_attention as jfa

    seen = set()
    for b, n, h, hd, itemsize in ROUTE_GRID:
        jax_route = _jax_route(b, n, h, hd, itemsize)
        seen.add(jax_route)
        assert fa.attention_nhd_feasible(b, n, h, hd, itemsize) == \
            jfa.attention_nhd_feasible(b, n, h, hd, itemsize), (b, n, h, hd)
        got = fa.attention_route(b, n, h, hd, itemsize)
        if jax_route == "XLA":
            jax_route = "B1" if jfa.attention_nhd_feasible(b, n, h, hd, itemsize) else "B3"
        assert got == jax_route, (b, n, h, hd, itemsize)
    assert seen == {"B1", "B2", "B3", "XLA"}
    assert _jax_route(64, 577, 12, 768, 2) == "B3"
    assert fa.attention_route(64, 577, 12, 768, 2) == "B3"
    assert _jax_route(64, 1025, 12, 768, 2) == "B2"
    assert fa.attention_route(64, 1025, 12, 768, 2) == "B2"
    for b, n in ((128, 145), (256, 145), (512, 37)):
        assert fa.attention_route(b, n, 6, 384, 2) == "B1"
    assert fa.attention_route(128, 148, 6, 384, 2, block_size=37) == "B1"
    assert fa.attention_route(1, 2048, 6, 384, 2, block_size=37) == "B1"

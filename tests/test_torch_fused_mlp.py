"""Kernel B4 (fused MLP) in the PyTorch port (``vit_ssl_tpu_torch.ops.fused_mlp``).

The port's ``fused_mlp`` (which runs its plain PyTorch versions for a CPU
tensor) is held against the JAX package's ``fused_mlp`` in interpret mode,
as ``tests/test_feed_forward.py`` runs it, on the same numpy inputs: the
output, the saved pre-activation and the five gradients, at fp32 and bf16,
with and without a keep-mask, at a ragged token count, at a small width and
at ViT-B's 768 / 3072 and ViT-L's 1024 / 4096. The JAX function
takes its weights as (in, out); the port takes the ``nn.Linear`` (out, in)
layout, so the tests transpose. Also here: ``FeedForwardBlock(use_fused=
True)`` against JAX's on the same weights, the fused and unfused port
blocks drawing one mask, and the wrapper's checks. The CUDA kernels are
held against the plain versions on the card, in
``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.ops.feed_forward import FeedForwardBlock as JaxFFN
from vit_ssl_tpu.ops.fused_mlp import _fused_mlp_impl
from vit_ssl_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import FeedForwardBlock
from vit_ssl_tpu_torch.ops import fused_mlp as fm
from vit_ssl_tpu_torch.ops.dropout import keep_mask16
from vit_ssl_tpu_torch.utils.checkpoint import feed_forward_state_dict_from_flax

T, D_IN, D_FF = 70, 32, 128  # a ragged token count at small widths
KEEP = 0.9

# fp32: no looser than tests/test_feed_forward.py (fused kernel against the
# XLA path). The two sides sum in other orders, and JAX's erf is the
# Abramowitz-Stegun polynomial (|error| <= 1.5e-7) where the port's is
# torch.erf: both far inside these bars.
FWD_FP32 = dict(atol=2e-5, rtol=1e-4)
GRAD_FP32 = dict(atol=1e-4, rtol=1e-3)
# bf16: the same rounding points on both sides (pre, h, dpre and every
# result rounded to bf16), but an fp32 value near a rounding tie may land
# on either side: one bf16 ulp is 2^-8 relative, and a flipped h or dpre
# moves a sum by 2^-8 of that term.
FWD_BF16 = dict(atol=1e-2, rtol=1e-2)
GRAD_BF16 = dict(atol=2e-2, rtol=1e-2)


def _inputs(seed=0, t=T, d_in=D_IN, d_ff=D_FF):
    """x, JAX-layout weights (in, out), a keep-mask at rate 0.1 and an
    upstream gradient, all numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d_in), dtype=np.float32)
    w1 = rng.standard_normal((d_in, d_ff), dtype=np.float32) / np.sqrt(d_in)
    b1 = 0.1 * rng.standard_normal(d_ff, dtype=np.float32)
    w2 = rng.standard_normal((d_ff, d_in), dtype=np.float32) / np.sqrt(d_ff)
    b2 = 0.1 * rng.standard_normal(d_in, dtype=np.float32)
    mask = rng.random((t, d_ff)) >= 0.1
    do = rng.standard_normal((t, d_in), dtype=np.float32)
    return x, w1, b1, w2, b2, mask, do


def _torch_args(x, w1, b1, w2, b2, dtype):
    """The port's arguments: weights transposed to the nn.Linear layout."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in (x, w1.T, b1, w2.T, b2)]


def _jax_run(x, w1, b1, w2, b2, mask, do, dtype):
    """JAX's out, saved pre and (dx, dw1, db1, dw2, db2), its weight
    gradients transposed to the nn.Linear layout; all fp32 numpy."""
    args = [jnp.asarray(a, dtype) for a in (x, w1, b1, w2, b2)]
    m = None if mask is None else jnp.asarray(mask)
    keep = KEEP if mask is not None else 1.0
    out, vjp = jax.vjp(lambda *a: jax_fused_mlp(*a, m, keep, True), *args)
    _, pre = _fused_mlp_impl(*args, m, keep, True, save_pre=True)
    dx, dw1, db1, dw2, db2 = vjp(jnp.asarray(do, dtype))
    grads = [dx, dw1.T, db1, dw2.T, db2]
    return (np.asarray(out, np.float32), np.asarray(pre[:x.shape[0]], np.float32),
            [np.asarray(g, np.float32) for g in grads])


def _assert_matches_jax(dtype, with_mask, t=T, d_in=D_IN, d_ff=D_FF, seed=1):
    """The port's fused_mlp (its plain versions: a CPU tensor launches no
    kernel) against JAX's in interpret mode: out, pre and the gradients."""
    x, w1, b1, w2, b2, mask, do = _inputs(seed, t, d_in, d_ff)
    mask = mask if with_mask else None
    want_out, want_pre, want_grads = _jax_run(x, w1, b1, w2, b2, mask, do,
                                              getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    args = [a.requires_grad_() for a in _torch_args(x, w1, b1, w2, b2, tdt)]
    tmask = None if mask is None else torch.from_numpy(mask)
    keep = KEEP if with_mask else 1.0
    before = dict(kernels.launches)
    out = fm.fused_mlp(*args, tmask, keep)
    grads = torch.autograd.grad(out, args, torch.from_numpy(do))
    _, pre = fm.fused_mlp_fwd(*(a.detach() for a in args), tmask, keep, save_pre=True)
    assert dict(kernels.launches) == before  # CPU: the plain versions, no kernel
    fwd_tol, grad_tol = ((FWD_FP32, GRAD_FP32) if dtype == "float32"
                         else (FWD_BF16, GRAD_BF16))
    assert out.dtype == tdt and out.shape == (t, d_in)
    np.testing.assert_allclose(out.detach().float().numpy(), want_out, **fwd_tol)
    assert pre.dtype == tdt and pre.shape == (t, d_ff)
    np.testing.assert_allclose(pre.float().numpy(), want_pre, **fwd_tol)
    for name, g, w, a in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want_grads, args):
        assert g.dtype == tdt and g.shape == a.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **grad_tol)


@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_matches_jax(dtype, with_mask):
    _assert_matches_jax(dtype, with_mask)


@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_ff", [(768, 3072), (1024, 4096)], ids=["vit-b", "vit-l"])
def test_fused_mlp_matches_jax_at_the_new_widths(d_in, d_ff, dtype, with_mask):
    """ViT-B's and ViT-L's FFN widths, which the kernels now take, at a
    short ragged T; the same tolerances as at the small width (one bf16
    ulp is relative, and the longer fp32 sums stay far inside 1e-4)."""
    _assert_matches_jax(dtype, with_mask, t=19, d_in=d_in, d_ff=d_ff, seed=11)


def test_backward_uses_the_rounded_pre_and_h():
    """In bf16 the backward takes GELU′ of the saved pre rounded to bf16 and
    dw2 from h rounded to bf16, as JAX's kernel does: exactly the plain
    backward on the plain forward's pre."""
    x, w1, b1, w2, b2, mask, do = _inputs(seed=2)
    args = _torch_args(x, w1, b1, w2, b2, torch.bfloat16)
    tmask, tdo = torch.from_numpy(mask), torch.from_numpy(do)
    _, pre = fm.fused_mlp_reference(*args, tmask, KEEP, save_pre=True)
    want = fm.fused_mlp_bwd_reference(args[0], pre, tdo, args[1], args[3], tmask, KEEP)
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(fm.fused_mlp(*leaves, tmask, KEEP), leaves, tdo)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrappers_take_plain_versions_on_cpu():
    x, w1, b1, w2, b2, mask, do = _inputs(seed=3)
    args = _torch_args(x, w1, b1, w2, b2, torch.float32)
    tmask, tdo = torch.from_numpy(mask), torch.from_numpy(do)
    before = dict(kernels.launches)
    out, pre = fm.fused_mlp_fwd(*args, tmask, KEEP, save_pre=True)
    want, want_pre = fm.fused_mlp_reference(*args, tmask, KEEP, save_pre=True)
    assert torch.equal(out, want) and torch.equal(pre, want_pre)
    assert torch.equal(fm.fused_mlp_fwd(*args), fm.fused_mlp_reference(*args))
    grads = fm.fused_mlp_bwd(args[0], pre, tdo, args[1], args[3], tmask, KEEP)
    want = fm.fused_mlp_bwd_reference(args[0], pre, tdo, args[1], args[3], tmask, KEEP)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert dict(kernels.launches) == before


def test_wrapper_refuses_other_devices():
    x = torch.empty(4, 384, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fm.fused_mlp(x, x, x, x, x)


def _kernel_args(t=8, d=384, d_ff=1536, dtype=torch.float32):
    return [torch.zeros(t, d, dtype=dtype), torch.zeros(d_ff, d, dtype=dtype),
            torch.zeros(d, d_ff, dtype=dtype)]


@pytest.mark.parametrize("t,d,d_ff,dtype,match", [
    (8, 512, 2048, torch.float32, r"d_in \(384, 768, 1024\)"),  # not built: refused
    (8, 384, 1472, torch.float32, "multiple of 128"),
    (0, 384, 1536, torch.float32, "at least one token"),
    (8, 384, 1536, torch.float16, "not supported"),
])
def test_kernel_input_checks(t, d, d_ff, dtype, match):
    x, w1, w2 = _kernel_args(t, d, d_ff, dtype)
    with pytest.raises(ValueError, match=match):
        fm._check(x, w1, w2, None)


def test_kernel_input_checks_layout():
    x, w1, w2 = _kernel_args()
    fm._check(x, w1, w2, torch.ones(8, 1536, dtype=torch.bool),
              b1=torch.zeros(1536), b2=torch.zeros(384))
    with pytest.raises(ValueError, match="nn.Linear layout"):
        fm._check(x, w1, w1, None)  # w2 given as (d_ff, d)
    with pytest.raises(ValueError, match="keep-mask"):
        fm._check(x, w1, w2, torch.ones(8, 1536))  # float, not bool
    with pytest.raises(ValueError, match="contiguous"):
        fm._check(x, w1, w2.t().contiguous().t(), None)
    shifted = torch.zeros(8 * 384 + 1)[1:].view(8, 384)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fm._check(shifted, w1, w2, None)
    with pytest.raises(ValueError, match="pre"):
        fm._check(x, w1, w2, None, pre=torch.zeros(8, 384))


def test_kernel_sources_cover_their_headers():
    """A header edit must rebuild every library that includes it: B4's
    libraries and P2's include the bf16 wgmma/TMA bodies' header and,
    through it, the Hopper pieces and B1's header, and the fp32 bodies'
    header; the backward and P2's library the weight-gradient header over
    the latter."""
    common = ["fused_mlp_common.cuh", "attention_nhd_common.cuh"]
    hopper = ["mlp_gemm_sm90.cuh", "sm90_common.cuh"]
    for name, headers in (("fused_mlp_fwd", [*hopper, *common[::-1]]),
                          ("fused_mlp_bwd", ["weight_grad.cuh", *common, *hopper]),
                          ("masked_matmul", ["weight_grad.cuh", *common, *hopper])):
        files = [f.name for f in kernels.source_files(name)]
        assert files == [f"{name}.cu", *headers]


# ---------------------------------------------------------------------------
# the module: FeedForwardBlock(use_fused=True)


def _jax_ffn_pair(dropout, seed=4):
    x = np.random.default_rng(seed).standard_normal((2, 35, D_IN)).astype(np.float32)
    jax_ff = JaxFFN(d_model=D_IN, d_ff=D_FF, dropout=dropout, use_fused=True)
    params = jax_ff.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.1 * rng.standard_normal(np.shape(p)).astype(np.float32), params)
    ff = FeedForwardBlock(D_IN, D_FF, dropout=dropout, use_fused=True)
    ff.load_state_dict(feed_forward_state_dict_from_flax(params), strict=True)
    return jax_ff, params, ff, x


def test_feed_forward_fused_matches_jax_eval():
    jax_ff, params, ff, x = _jax_ffn_pair(dropout=0.1)
    want = jax_ff.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = ff(torch.from_numpy(x)).numpy()  # eval: no mask
    np.testing.assert_allclose(got, np.asarray(want), **FWD_FP32)


def test_feed_forward_fused_gradients_match_jax_at_dropout_zero():
    """Train mode at rate 0 (no mask): forward and parameter gradients."""
    jax_ff, params, ff, x = _jax_ffn_pair(dropout=0.0, seed=6)

    def loss(p):
        out = jax_ff.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return jnp.sum(out ** 2), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = ff(torch.from_numpy(x), False, torch.Generator().manual_seed(0))
    (out.float() ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD_FP32)
    want_grads = feed_forward_state_dict_from_flax(grads)
    for name, p in ff.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **GRAD_FP32)


def test_fused_and_unfused_blocks_draw_the_same_mask():
    """One generator state, the same bits: both blocks drop the same units
    and leave the generator at the same point."""
    torch.manual_seed(0)
    unfused = FeedForwardBlock(D_IN, D_FF, dropout=0.25)
    fused = FeedForwardBlock(D_IN, D_FF, dropout=0.25, use_fused=True)
    fused.load_state_dict(unfused.state_dict(), strict=True)
    x = torch.randn(3, 11, D_IN)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    want = unfused(x, False, g1)
    got = fused(x, False, g2)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    # the mask is keep_mask16's from that state, over (B·N, d_ff)
    mask = keep_mask16((33, D_FF), 0.25, torch.Generator().manual_seed(9))
    w = fused.linear_in, fused.linear_out
    plain = fm.fused_mlp_reference(x.reshape(33, D_IN), w[0].weight, w[0].bias,
                                   w[1].weight, w[1].bias, mask, 0.75)
    torch.testing.assert_close(got.reshape(33, D_IN), plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        fused(x, False)

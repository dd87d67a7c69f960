"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Kernel B1: the inference forward, the training forward (output and softmax
statistics) and the backward (dq, dk, dv), and a ``MultiHeadAttention``
gradient through the kernels against the plain path; the bf16 forward's
Hopper body in both its forms (one pass up to N = 256, two above) at every
head dim: its kernels by name in a profile, repeatable bits, each head kept
to its columns and each image to its rows, and the refusal of a scale <= 0. Kernel B3: the same
three entries on the head-major layout, their agreement with B1 on the
same data (bf16: B3's own Hopper forward and backward), each head kept to
its own rows and repeatable bits in both directions, the Hopper backward's
kernels by name in a profile, and a ``MultiHeadAttention`` gradient at
ViT-B/16's N = 577 through them. Kernel B2 (blockwise flash attention): its forward (o and lse) and
its two backward kernels (with and without an lse cotangent) from N = 1 to
4096, P1 (the exp2 forward) against its plain version and B2's forward,
both forwards' repeatable bits, each head kept to its own rows and the
Hopper body by name in a profile at every head dim, and a
``MultiHeadAttention`` gradient at ViT-B/16's N = 1025 through them.
Kernel B4 (fused MLP):
its forwards (no mask, keep-mask, keep-mask with pre saved) and its
backward (with and without the mask) at d_model 384, 768 and 1024, and a
``FeedForwardBlock(use_fused=True)`` gradient through the kernels against
the plain path. Kernel P2 (dropout-masked second FFN product): its forward
and backward at the probe's and ViT-B's shapes, and a gradient through it.

Every test here carries the ``cuda`` marker and skips without a CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up and imports it).
"""

import numpy as np
import pytest
import torch

from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.models import ViTBackbone
from vit_ssl_tpu_torch.ops import FeedForwardBlock
from vit_ssl_tpu_torch.ops import attention as attention_mod
from vit_ssl_tpu_torch.ops import flash_attention as fa
from vit_ssl_tpu_torch.ops import flash_blockwise as fb
from vit_ssl_tpu_torch.ops import fused_mlp as fm
from vit_ssl_tpu_torch.ops import masked_matmul as mm

pytestmark = pytest.mark.cuda

# bf16 outputs: one bf16 ulp is 2^-8 relative; fp32 sums in another order
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 plain versions
    return torch.device("cuda")


def _inputs(b, n, h, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, n, h * d), dtype=np.float32))
            .to(device, dtype) for _ in range(3)]


@pytest.mark.parametrize("b,n,h,d,dtype,bs", [
    (128, 145, 6, 64, "bfloat16", 0),
    (128, 145, 6, 64, "float32", 0),
    (128, 148, 6, 64, "bfloat16", 37),
    (16, 148, 6, 64, "float32", 37),
    (512, 37, 6, 64, "bfloat16", 0),
    (8, 1024, 6, 64, "bfloat16", 0),
    (4, 145, 12, 32, "bfloat16", 0),
    (4, 145, 12, 32, "float32", 0),
    (4, 145, 3, 128, "bfloat16", 5),
    (4, 145, 3, 128, "float32", 0),
    (2, 1, 6, 64, "bfloat16", 0),
    (2, 1, 6, 64, "float32", 0),
])
def test_attention_nhd_fwd_matches_plain(cuda_device, b, n, h, d, dtype, bs):
    dt = getattr(torch, dtype)
    xq, xk, xv = _inputs(b, n, h, d, dt, cuda_device, seed=b + n)
    scale = 1.0 / d ** 0.5
    before = kernels.launches[fa.KERNEL]
    out = fa.attention_nhd(xq, xk, xv, h, scale, bs)
    torch.cuda.synchronize()
    assert kernels.launches[fa.KERNEL] == before + 1
    ref = fa.attention_nhd_reference(xq, xk, xv, h, scale, bs)
    assert out.dtype == dt and out.shape == ref.shape
    assert torch.isfinite(out).all()
    torch.testing.assert_close(
        out.float(), ref.float(), **(FP32_TOL if dtype == "float32" else BF16_TOL))


def test_attention_nhd_refuses_what_the_kernel_cannot_take(cuda_device):
    x = torch.zeros(2, 37, 96, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.attention_nhd(x, x, x, 2, 0.125)
    x = torch.zeros(2, 37, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="not supported"):
        fa.attention_nhd(x, x, x, 2, 0.125)


def test_backbone_runs_attention_only_through_the_kernel(cuda_device, monkeypatch):
    """One launch per block and forward; the plain version is never called
    for a CUDA tensor."""
    def plain_called(*args, **kwargs):
        raise AssertionError("the plain attention ran on the card")

    monkeypatch.setattr(fa, "attention_nhd_reference", plain_called)
    model = ViTBackbone(3, (3, 32, 32), 128, 8, 2, 256, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0)).to(cuda_device).eval()
    x = torch.rand(5, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    kernels.launches.clear()
    with torch.inference_mode():
        out = model(x.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.launches[fa.KERNEL] == 3
    assert out.shape == (5, 128) and torch.isfinite(out.float()).all()


def test_multi_head_attention_kernel_path_matches_plain(cuda_device):
    mha = attention_mod.MultiHeadAttention(384, 6, dtype=torch.bfloat16)
    torch.manual_seed(0)
    mha = mha.to(cuda_device)
    x = torch.randn(8, 145, 384, device=cuda_device, dtype=torch.bfloat16)
    with torch.inference_mode():
        got = mha(x).float()
        want, probs = mha(x, return_attn=True)  # the plain math path
    assert probs.shape == (8, 6, 145, 145)
    torch.testing.assert_close(got, want.float(), atol=2e-2, rtol=2e-2)


# (batch, seq, heads, head_dim, dtype, block_size): chip_smoke.py's training
# shapes, fp32 and bf16 at the two DINO shapes
TRAIN_CASES = [
    (256, 145, 6, 64, "bfloat16", 0),
    (256, 145, 6, 64, "float32", 0),
    (128, 148, 6, 64, "bfloat16", 37),
    (128, 148, 6, 64, "float32", 37),
    (512, 37, 6, 64, "bfloat16", 0),
    (16, 145, 12, 32, "bfloat16", 0),
    (16, 148, 3, 128, "bfloat16", 37),
    (8, 1024, 6, 64, "bfloat16", 0),
    (4, 1, 6, 64, "bfloat16", 0),
]


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


# bf16: p and ds round to bf16 on both sides, and an fp32 value near a
# rounding tie may land on either side; fp32: sums in another order
GRAD_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


@pytest.mark.parametrize("b,n,h,d,dtype,bs", TRAIN_CASES)
def test_training_forward_equals_inference_and_plain_stats(cuda_device, b, n, h,
                                                           d, dtype, bs):
    dt = getattr(torch, dtype)
    xq, xk, xv = _inputs(b, n, h, d, dt, cuda_device, seed=b + n + 1)
    scale = 1.0 / d ** 0.5
    before = kernels.launches[fa.KERNEL_TRAIN]
    out, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, scale, bs)
    torch.cuda.synchronize()
    assert kernels.launches[fa.KERNEL_TRAIN] == before + 1
    assert torch.equal(out, fa.attention_nhd_fwd(xq, xk, xv, h, scale, bs))
    assert stats.shape == (b, h, -(-n // 64) * 64, 2)
    assert not stats[:, :, n:].any()  # rows past n stay zero
    ref = fa.attention_nhd_stats_reference(xq, xk, h, scale, bs)
    torch.testing.assert_close(stats[:, :, :n], ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,n,h,d,dtype,bs", TRAIN_CASES)
def test_backward_matches_plain(cuda_device, b, n, h, d, dtype, bs):
    dt = getattr(torch, dtype)
    xq, xk, xv = _inputs(b, n, h, d, dt, cuda_device, seed=b + n + 2)
    (do,) = _inputs(b, n, h, d, torch.float32, cuda_device, seed=7)[:1]
    scale = 1.0 / d ** 0.5
    _, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, scale, bs)
    before = kernels.launches[fa.KERNEL_BWD]
    got = fa.attention_nhd_bwd(xq, xk, xv, do, stats, h, scale, bs)
    torch.cuda.synchronize()
    assert kernels.launches[fa.KERNEL_BWD] == before + 1
    want = fa.attention_nhd_bwd_reference(xq, xk, xv, do, h, scale, bs)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= GRAD_REL_TOL[dtype], (name, _rel_err(g, w))


def test_backward_takes_a_strided_upstream_gradient(cuda_device):
    xq, xk, xv = _inputs(4, 37, 2, 64, torch.bfloat16, cuda_device, seed=3)
    do = torch.randn(37, 4, 128, device=cuda_device).transpose(0, 1)
    _, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, 2, 0.125)
    got = fa.attention_nhd_bwd(xq, xk, xv, do, stats, 2, 0.125)
    want = fa.attention_nhd_bwd(xq, xk, xv, do.contiguous(), stats, 2, 0.125)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype,bs", [("bfloat16", 0), ("bfloat16", 37),
                                      ("float32", 37)])
def test_multi_head_attention_gradient_through_kernels(cuda_device, monkeypatch,
                                                       dtype, bs):
    """The old fault: the kernel's output carried no autograd node, so no
    gradient reached w_query. Now it does, and it equals the plain path's."""
    dt = getattr(torch, dtype)
    torch.manual_seed(0)
    mha = attention_mod.MultiHeadAttention(384, 6, dtype=dt).to(cuda_device)
    x = torch.randn(8, 148, 384, device=cuda_device)

    def grads():
        mha.zero_grad()
        (mha(x, block_size=bs).float() ** 2).sum().backward()
        return {k: p.grad.clone() for k, p in mha.named_parameters()}

    kernels.launches.clear()
    got = grads()
    assert kernels.launches[fa.KERNEL_TRAIN] == 1
    assert kernels.launches[fa.KERNEL_BWD] == 1
    assert kernels.launches[fa.KERNEL] == 0
    monkeypatch.setattr(attention_mod, "attention_nhd", fa.attention_nhd_plain)
    want = grads()
    assert kernels.launches[fa.KERNEL_BWD] == 1  # the plain path ran no kernel
    for name in want:
        assert float(got[name].abs().max()) > 0, name
        cos = torch.nn.functional.cosine_similarity(
            got[name].flatten(), want[name].flatten(), dim=0)
        assert float(cos) >= 0.999, (name, float(cos))


# B1's bf16 forward in both of its forms (fa.attention_nhd_form): N = 1,
# ragged N, N on both sides of ONE_PASS_MAX_SEQ, a block size that does not
# divide N, and the two-pass form up to MAX_SEQ; (seq, block_size)
B1_FORM_CASES = [(1, 0), (37, 0), (100, 0), (145, 5), (148, 37), (192, 0), (200, 7),
                 (255, 0), (256, 0), (257, 0), (300, 7), (577, 0), (1024, 0)]


def _b1_heads(d):
    return 384 // d // 2  # 6 heads of 32, 3 of 64, 1 of 128


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n,bs", B1_FORM_CASES)
def test_b1_bf16_forward_matches_plain_in_both_forms(cuda_device, n, bs, d):
    """Both entries against the plain version on either side of the
    one-pass/two-pass boundary: the output within BF16_TOL, the training
    output equal to the inference output bit for bit, the statistics within
    1e-5 and zero past n."""
    h, b = _b1_heads(d), 3
    xq, xk, xv = _inputs(b, n, h, d, torch.bfloat16, cuda_device, seed=n + d)
    scale = 1.0 / d ** 0.5
    out = fa.attention_nhd_fwd(xq, xk, xv, h, scale, bs)
    out_t, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, scale, bs)
    torch.cuda.synchronize()
    assert torch.equal(out, out_t)
    torch.testing.assert_close(out.float(), fa.attention_nhd_reference(
        xq, xk, xv, h, scale, bs).float(), **BF16_TOL)
    torch.testing.assert_close(stats[:, :, :n], fa.attention_nhd_stats_reference(
        xq, xk, h, scale, bs), atol=1e-5, rtol=1e-5)
    assert not stats[:, :, n:].any()


@pytest.mark.parametrize("n", [145, 577])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_b1_bf16_forward_runs_the_hopper_kernel(cuda_device, d, n):
    """Both bf16 entries launch the form of attention_fwd_sm90.cuh that
    attention_nhd_form names (one pass at N = 145, two at 577), shown by
    name in a profile of the call (:func:`_device_kernel_names`), and
    nothing of the mma.sync body."""
    h = _b1_heads(d)
    xq, xk, xv = _inputs(32, n, h, d, torch.bfloat16, cuda_device, seed=d + 21)
    body = fa.FORWARD_BODIES[fa.attention_nhd_form(n)]
    for entry in (fa.attention_nhd_fwd, fa.attention_nhd_fwd_stats):
        names = _device_kernel_names(lambda: entry(xq, xk, xv, h, 1.0 / d ** 0.5),
                                     want=(f"{body}<{d},",))
        assert f"{body}<{d}," in names, names
        assert "bf16_kernel" not in names, names


@pytest.mark.parametrize("n", [145, 577])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_b1_bf16_forward_repeats_bit_for_bit(cuda_device, d, n):
    """No atomics, no order that changes between calls: two calls of each
    entry on the same inputs give the same bits, output and statistics."""
    h = _b1_heads(d)
    xq, xk, xv = _inputs(4, n, h, d, torch.bfloat16, cuda_device, seed=d + 22)
    first = fa.attention_nhd_fwd_stats(xq, xk, xv, h, 0.125, 37)
    second = fa.attention_nhd_fwd_stats(xq, xk, xv, h, 0.125, 37)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    assert torch.equal(fa.attention_nhd_fwd(xq, xk, xv, h, 0.125),
                       fa.attention_nhd_fwd(xq, xk, xv, h, 0.125))


@pytest.mark.parametrize("n", [145, 577])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_b1_bf16_forward_keeps_to_its_head_and_image(cuda_device, d, n):
    """A box that reached a neighbouring head's columns or ran past row n
    into the next image would read them: with head 1's columns all inf and
    image 1 all NaN, heads 0 and 2 of images 0 and 2 equal the plain version
    of each head alone, in both entries (the tensor maps over (H·D, N, B)
    zero-fill past n)."""
    h, b = 3, 3
    xq, xk, xv = _inputs(b, n, h, d, torch.bfloat16, cuda_device, seed=d + 23)
    for x in (xq, xk, xv):
        x.view(b, n, h, d)[:, :, 1] = float("inf")
        x[1] = float("nan")
    out = fa.attention_nhd_fwd(xq, xk, xv, h, 0.125)
    out_t, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, 0.125)
    torch.cuda.synchronize()
    for img in (0, 2):
        for head in (0, 2):
            alone = [x.view(b, n, h, d)[img:img + 1, :, head].contiguous()
                     for x in (xq, xk, xv)]
            want = fa.attention_nhd_reference(*alone, 1, 0.125).float()
            for got in (out, out_t):
                got = got.view(b, n, h, d)[img:img + 1, :, head].float()
                assert torch.isfinite(got).all(), (img, head)
                torch.testing.assert_close(got, want, **BF16_TOL)
            assert torch.isfinite(stats[img, head, :n]).all(), (img, head)


@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_b1_bf16_forward_refuses_a_non_positive_scale(cuda_device, scale):
    """The Hopper body takes the row max before scaling: a bf16 call with
    scale <= 0 raises by name, and never reaches another body; fp32 takes
    it."""
    xq, xk, xv = _inputs(2, 37, 2, 64, torch.bfloat16, cuda_device, seed=24)
    before = dict(kernels.launches)
    for entry in (fa.attention_nhd_fwd, fa.attention_nhd_fwd_stats):
        with pytest.raises(ValueError, match="scale must be positive"):
            entry(xq, xk, xv, 2, scale)
    assert dict(kernels.launches) == before
    f32 = [x.float() for x in (xq, xk, xv)]
    torch.testing.assert_close(fa.attention_nhd_fwd(*f32, 2, scale),
                               fa.attention_nhd_reference(*f32, 2, scale), **FP32_TOL)


# Kernel B4 at DINO ViT-S/8's widths: the student's globals, a short served
# batch, T = 1 and a ragged T. max |kernel - plain| over max |plain|; bf16:
# h and dpre round to bf16 on both sides and may land on either side of a
# tie; fp32: sums in another order
MLP_ROWS = [37120, 5365, 1, 70]
MLP_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _mlp_inputs(t, dtype, device, seed=0, d=384, d_ff=1536):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy(
            scale * rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)

    x = arr(t, d)
    w1, b1 = arr(d_ff, d, scale=d ** -0.5), arr(d_ff, scale=0.1)
    w2, b2 = arr(d, d_ff, scale=d_ff ** -0.5), arr(d, scale=0.1)
    mask = torch.from_numpy(rng.random((t, d_ff)) >= 0.1).to(device)
    do = arr(t, d)
    return x, w1, b1, w2, b2, mask, do


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", MLP_ROWS)
def test_fused_mlp_forwards_match_plain(cuda_device, t, dtype):
    x, w1, b1, w2, b2, mask, _ = _mlp_inputs(t, getattr(torch, dtype), cuda_device, t)
    before = dict(kernels.launches)
    out = fm.fused_mlp_fwd(x, w1, b1, w2, b2)
    out_mask = fm.fused_mlp_fwd(x, w1, b1, w2, b2, mask, 0.9)
    out_pre, pre = fm.fused_mlp_fwd(x, w1, b1, w2, b2, mask, 0.9, save_pre=True)
    torch.cuda.synchronize()
    assert kernels.launches[fm.KERNEL] == before.get(fm.KERNEL, 0) + 2
    assert kernels.launches[fm.KERNEL_TRAIN] == before.get(fm.KERNEL_TRAIN, 0) + 1
    assert torch.equal(out_pre, out_mask)
    want, want_pre = fm.fused_mlp_reference(x, w1, b1, w2, b2, mask, 0.9, save_pre=True)
    pairs = [(out, fm.fused_mlp_reference(x, w1, b1, w2, b2)), (out_mask, want),
             (pre, want_pre)]
    for got, ref in pairs:
        assert got.dtype == x.dtype and got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert _rel_err(got, ref) <= MLP_REL_TOL[dtype], _rel_err(got, ref)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no-mask"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", MLP_ROWS)
def test_fused_mlp_backward_matches_plain(cuda_device, t, dtype, with_mask):
    x, w1, b1, w2, b2, mask, do = _mlp_inputs(t, getattr(torch, dtype), cuda_device,
                                              t + 1)
    mask = mask if with_mask else None
    _, pre = fm.fused_mlp_reference(x, w1, b1, w2, b2, mask, 0.9, save_pre=True)
    before = kernels.launches[fm.KERNEL_BWD]
    got = fm.fused_mlp_bwd(x, pre, do, w1, w2, mask, 0.9)
    torch.cuda.synchronize()
    assert kernels.launches[fm.KERNEL_BWD] == before + 1
    want = fm.fused_mlp_bwd_reference(x, pre, do, w1, w2, mask, 0.9)
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert g.dtype == x.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= MLP_REL_TOL[dtype], (name, _rel_err(g, w))
    again = fm.fused_mlp_bwd(x, pre, do, w1, w2, mask, 0.9)
    assert all(torch.equal(a, g) for a, g in zip(again, got))  # no atomics


# B4 at ViT-B's and ViT-L's widths: the supervised ViT-B/16 at 384 px
# (64 x 577 tokens), ViT-L/16 at 224 px (64 x 197), and short ragged T
MLP_WIDE_CASES = [(36928, 768, 3072), (70, 768, 3072), (12608, 1024, 4096),
                  (1, 1024, 4096)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t,d,d_ff", MLP_WIDE_CASES)
def test_fused_mlp_matches_plain_at_the_wide_widths(cuda_device, t, d, d_ff, dtype):
    """The three forwards and the backward (with and without the mask) at
    d_model 768 and 1024, whose row kernels take 32-row blocks and 16-wide
    d_ff chunks."""
    dt = getattr(torch, dtype)
    x, w1, b1, w2, b2, mask, do = _mlp_inputs(t, dt, cuda_device, t, d, d_ff)
    out = fm.fused_mlp_fwd(x, w1, b1, w2, b2)
    out_mask = fm.fused_mlp_fwd(x, w1, b1, w2, b2, mask, 0.9)
    out_pre, pre = fm.fused_mlp_fwd(x, w1, b1, w2, b2, mask, 0.9, save_pre=True)
    want, want_pre = fm.fused_mlp_reference(x, w1, b1, w2, b2, mask, 0.9, save_pre=True)
    pairs = [(out, fm.fused_mlp_reference(x, w1, b1, w2, b2)), (out_mask, want),
             (pre, want_pre)]
    for m in (mask, None):
        got = fm.fused_mlp_bwd(x, want_pre, do, w1, w2, m, 0.9)
        pairs += zip(got, fm.fused_mlp_bwd_reference(x, want_pre, do, w1, w2, m, 0.9))
    torch.cuda.synchronize()
    assert torch.equal(out_pre, out_mask)
    for got, ref in pairs:
        assert got.dtype == x.dtype and got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert _rel_err(got, ref) <= MLP_REL_TOL[dtype], _rel_err(got, ref)


def test_fused_mlp_refuses_what_the_kernels_cannot_take(cuda_device):
    x, w1, w2 = (torch.zeros(s, device=cuda_device)
                 for s in ((8, 512), (2048, 512), (512, 2048)))
    with pytest.raises(ValueError, match="d_in"):
        fm.fused_mlp(x, w1, torch.zeros(2048, device=cuda_device), w2,
                     torch.zeros(512, device=cuda_device))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_feed_forward_gradient_through_fused_kernels(cuda_device, monkeypatch, dtype):
    """A gradient through FeedForwardBlock(use_fused=True) on the card
    reaches every parameter through the B4 kernels and equals the plain
    path's (dropout on, one generator seed for both)."""
    dt = getattr(torch, dtype)
    torch.manual_seed(0)
    ff = FeedForwardBlock(384, 1536, dropout=0.1, dtype=dt, use_fused=True).to(cuda_device)
    x = torch.randn(8, 145, 384, device=cuda_device)

    def grads():
        ff.zero_grad()
        g = torch.Generator(device=cuda_device).manual_seed(1)
        (ff(x, False, g).float() ** 2).sum().backward()
        return {k: p.grad.clone() for k, p in ff.named_parameters()}

    kernels.launches.clear()
    got = grads()
    assert kernels.launches[fm.KERNEL_TRAIN] == 1
    assert kernels.launches[fm.KERNEL_BWD] == 1
    monkeypatch.setattr(fm, "fused_mlp_fwd", fm.fused_mlp_reference)
    monkeypatch.setattr(fm, "fused_mlp_bwd", fm.fused_mlp_bwd_reference)
    want = grads()
    assert kernels.launches[fm.KERNEL_BWD] == 1  # the plain path ran no kernel
    for name in want:
        assert float(got[name].abs().max()) > 0, name
        cos = torch.nn.functional.cosine_similarity(
            got[name].flatten().float(), want[name].flatten().float(), dim=0)
        assert float(cos) >= 0.999, (name, float(cos))


# Kernel B3 (head-major, no mask), (batch, heads, seq, head_dim, dtype):
# ViT-B/16 at 384 px, N = 1, N = 1024 and ragged N with each head dim
FUSED_CASES = [
    (64, 12, 577, 64, "bfloat16"),
    (16, 12, 577, 64, "float32"),
    (4, 12, 1, 64, "bfloat16"),
    (4, 12, 1, 64, "float32"),
    (4, 12, 1024, 64, "bfloat16"),
    (8, 4, 70, 32, "bfloat16"),
    (8, 4, 70, 32, "float32"),
    (8, 2, 203, 128, "bfloat16"),
    (8, 2, 203, 128, "float32"),
]


def _head_inputs(b, h, n, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, n, d), dtype=np.float32))
            .to(device, dtype) for _ in range(3)]


@pytest.mark.parametrize("b,h,n,d,dtype", FUSED_CASES)
def test_fused_attention_forwards_match_plain(cuda_device, b, h, n, d, dtype):
    """The inference kernel within BF16_TOL / FP32_TOL of the plain version;
    the training kernel's output equal to it bit for bit, its statistics
    within 1e-5 of the plain ones and zero past n."""
    dt = getattr(torch, dtype)
    q, k, v = _head_inputs(b, h, n, d, dt, cuda_device, seed=b + n)
    scale = 1.0 / d ** 0.5
    before = dict(kernels.launches)
    out = fa.fused_attention(q, k, v, scale)
    out_t, stats = fa.fused_attention_fwd_stats(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernels.launches[fa.FUSED_KERNEL] == before.get(fa.FUSED_KERNEL, 0) + 1
    assert kernels.launches[fa.FUSED_KERNEL_TRAIN] == before.get(fa.FUSED_KERNEL_TRAIN, 0) + 1
    ref = fa.fused_attention_reference(q, k, v, scale)
    assert out.dtype == dt and out.shape == ref.shape and torch.isfinite(out).all()
    torch.testing.assert_close(
        out.float(), ref.float(), **(FP32_TOL if dtype == "float32" else BF16_TOL))
    assert torch.equal(out, out_t)
    assert stats.shape == (b, h, -(-n // 64) * 64, 2) and not stats[:, :, n:].any()
    torch.testing.assert_close(stats[:, :, :n],
                               fa.fused_attention_stats_reference(q, k, scale),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,n,d,dtype", FUSED_CASES)
def test_fused_attention_backward_matches_plain(cuda_device, b, h, n, d, dtype):
    """dq, dk, dv within GRAD_REL_TOL of max|plain|."""
    dt = getattr(torch, dtype)
    q, k, v = _head_inputs(b, h, n, d, dt, cuda_device, seed=b + n + 1)
    (do,) = _head_inputs(b, h, n, d, torch.float32, cuda_device, seed=9)[:1]
    scale = 1.0 / d ** 0.5
    _, stats = fa.fused_attention_fwd_stats(q, k, v, scale)
    before = kernels.launches[fa.FUSED_KERNEL_BWD]
    got = fa.fused_attention_bwd(q, k, v, do, stats, scale)
    torch.cuda.synchronize()
    assert kernels.launches[fa.FUSED_KERNEL_BWD] == before + 1
    want = fa.fused_attention_bwd_reference(q, k, v, do, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape and torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= GRAD_REL_TOL[dtype], (name, _rel_err(g, w))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_attention_is_b1_on_the_head_major_layout(cuda_device, dtype):
    """B3 computes B1's function on the head-major layout. The forward is
    one body for both layouts in each dtype (fp32: the CUDA cores; bf16:
    the two-pass form of attention_fwd_sm90.cuh, which B1 takes at
    N = 577), so output and statistics are equal bit for bit. The backward:
    fp32 one body, equal bit for bit; bf16 B3's own Hopper backward (wgmma
    sums in another order than B1's mma.sync backward): fed B1's
    statistics, its gradients within GRAD_REL_TOL of max|B1|."""
    dt = getattr(torch, dtype)
    b, h, n, d = 4, 12, 577, 64
    q, k, v = _head_inputs(b, h, n, d, dt, cuda_device, seed=11)
    (do,) = _head_inputs(b, h, n, d, dt, cuda_device, seed=12)[:1]

    def nhd(x):
        return x.transpose(1, 2).reshape(b, n, h * d).contiguous()

    out, stats = fa.fused_attention_fwd_stats(q, k, v, 0.125)
    b1_out, b1_stats = fa.attention_nhd_fwd_stats(nhd(q), nhd(k), nhd(v), h, 0.125)
    assert fa.attention_nhd_form(n) == "two-pass"
    assert torch.equal(nhd(out), b1_out) and torch.equal(stats, b1_stats)
    got = fa.fused_attention_bwd(q, k, v, do, b1_stats, 0.125)
    want = fa.attention_nhd_bwd(nhd(q), nhd(k), nhd(v), nhd(do), b1_stats, h, 0.125)
    if dtype == "float32":
        assert all(torch.equal(nhd(g), w) for g, w in zip(got, want))
    else:
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert _rel_err(nhd(g), w) <= GRAD_REL_TOL[dtype], (name, _rel_err(nhd(g), w))


@pytest.mark.parametrize("d,dtype", [(32, "bfloat16"), (64, "bfloat16"), (128, "bfloat16"),
                                     (64, "float32")])
def test_fused_attention_backward_repeats_bit_for_bit(cuda_device, d, dtype):
    """No atomics, no order that changes between calls: two backward calls
    on the same inputs give the same bits, in every bf16 head dim and in
    fp32."""
    dt = getattr(torch, dtype)
    q, k, v = _head_inputs(4, 12 * 64 // d, 577, d, dt, cuda_device, seed=d + 15)
    (do,) = _head_inputs(4, 12 * 64 // d, 577, d, dt, cuda_device, seed=d + 16)[:1]
    _, stats = fa.fused_attention_fwd_stats(q, k, v, 1.0 / d ** 0.5)
    first = fa.fused_attention_bwd(q, k, v, do, stats, 1.0 / d ** 0.5)
    second = fa.fused_attention_bwd(q, k, v, do, stats, 1.0 / d ** 0.5)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.parametrize("n", [577, 70])
def test_fused_attention_backward_keeps_to_its_head(cuda_device, n):
    """With head 1's q, k, v and do all inf, the backward's gradients of
    heads 0 and 2 stay finite and within GRAD_REL_TOL of the plain version
    of each head alone: no tile reads another head's rows, statistics or
    delta."""
    b, h, d = 2, 3, 64
    q, k, v = _head_inputs(b, h, n, d, torch.bfloat16, cuda_device, seed=n + 17)
    (do,) = _head_inputs(b, h, n, d, torch.bfloat16, cuda_device, seed=n + 18)[:1]
    for x in (q, k, v, do):
        x[:, 1] = float("inf")
    _, stats = fa.fused_attention_fwd_stats(q, k, v, 0.125)
    got = fa.fused_attention_bwd(q, k, v, do, stats, 0.125)
    torch.cuda.synchronize()
    for head in (0, 2):
        alone = [x[:, head:head + 1].contiguous() for x in (q, k, v, do)]
        want = fa.fused_attention_bwd_reference(*alone, 0.125)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g = g[:, head:head + 1]
            assert torch.isfinite(g).all(), (head, name)
            assert _rel_err(g, w) <= GRAD_REL_TOL["bfloat16"], (head, name, _rel_err(g, w))


def _device_kernel_names(fn, sessions: int = 10, want=()) -> str:
    """The device kernels that profiles of ``fn`` record, by name: each
    session records the second of two calls. A session can lose all or
    some of its device events (on an NVIDIA H100 80GB HBM3 with torch 2.11,
    a session now and then lost all of them, whatever the activities,
    schedule or window length, and the first session of B2's forward
    profile lost one or both of its two kernels in most runs), so sessions
    run until together they record some device kernel and every name in
    ``want``, up to ``sessions`` times. Returns the names that the sessions
    recorded together."""
    from torch.profiler import ProfilerActivity, profile, schedule

    names = set()
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        names |= {e.key for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        joined = " ".join(sorted(names))
        if names and all(name in joined for name in want):
            break
    return joined


@pytest.mark.parametrize("d", [32, 64, 128])
def test_fused_attention_bf16_backward_runs_the_hopper_kernels(cuda_device, d):
    """A bf16 backward launches the two kernels of attention_bwd_sm90.cuh
    at every head dim, shown by name in a profile of the call
    (:func:`_device_kernel_names`), and none of the mma.sync body's."""
    q, k, v, do = (_head_inputs(2, 4, 203, d, torch.bfloat16, cuda_device, seed=d + 19)
                   + _head_inputs(2, 4, 203, d, torch.bfloat16, cuda_device, seed=d + 20))[:4]
    _, stats = fa.fused_attention_fwd_stats(q, k, v, 1.0 / d ** 0.5)
    names = _device_kernel_names(
        lambda: fa.fused_attention_bwd(q, k, v, do, stats, 1.0 / d ** 0.5),
        want=(f"attention_bwd_dq_sm90_kernel<{d}>", f"attention_bwd_dkv_sm90_kernel<{d}>"))
    assert f"attention_bwd_dq_sm90_kernel<{d}>" in names, names
    assert f"attention_bwd_dkv_sm90_kernel<{d}>" in names, names
    assert "bf16_kernel" not in names, names


@pytest.mark.parametrize("n", [577, 70])
def test_fused_attention_forward_keeps_to_its_head(cuda_device, n):
    """A tile that ran past row n of one head would read the next head's
    rows: with head 1's q, k and v all inf, heads 0 and 2 still equal the
    plain version of each head alone (the 3-D tensor maps zero-fill past
    n), in both forward entries."""
    b, h, d = 2, 3, 64
    q, k, v = _head_inputs(b, h, n, d, torch.bfloat16, cuda_device, seed=n + 13)
    for x in (q, k, v):
        x[:, 1] = float("inf")
    out = fa.fused_attention_fwd(q, k, v, 0.125)
    out_t, stats = fa.fused_attention_fwd_stats(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out[:, 0::2], out_t[:, 0::2])  # head 1 is NaN in both
    for head in (0, 2):
        alone = [x[:, head:head + 1].contiguous() for x in (q, k, v)]
        got = out[:, head:head + 1]
        assert torch.isfinite(got).all() and torch.isfinite(stats[:, head, :n]).all()
        torch.testing.assert_close(got.float(),
                                   fa.fused_attention_reference(*alone, 0.125).float(),
                                   **BF16_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_attention_forward_repeats_bit_for_bit(cuda_device, dtype):
    """No atomics, no order that changes between calls: two calls on the
    same inputs give the same bits, output and statistics."""
    q, k, v = _head_inputs(8, 12, 577, 64, getattr(torch, dtype), cuda_device, seed=14)
    first = fa.fused_attention_fwd_stats(q, k, v, 0.125)
    second = fa.fused_attention_fwd_stats(q, k, v, 0.125)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    assert torch.equal(fa.fused_attention_fwd(q, k, v, 0.125),
                       fa.fused_attention_fwd(q, k, v, 0.125))


def test_fused_attention_refuses_what_the_kernel_cannot_take(cuda_device):
    x = torch.zeros(2, 2, 37, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.fused_attention(x, x, x, 0.125)
    x = torch.zeros(2, 2, 37, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention(x, x.transpose(2, 3).contiguous().transpose(2, 3), x, 0.125)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_multi_head_attention_gradient_through_b3(cuda_device, monkeypatch, dtype):
    """ViT-B's widths at N = 577 route to B3 (B1 does not fit them): one
    training forward and one backward of B3, no B1, the gradient reaches
    w_query and every parameter's equals the plain path's (cosine >= 0.999)."""
    dt = getattr(torch, dtype)
    torch.manual_seed(0)
    mha = attention_mod.MultiHeadAttention(768, 12, dtype=dt).to(cuda_device)
    x = torch.randn(4, 577, 768, device=cuda_device)

    def grads():
        mha.zero_grad()
        (mha(x).float() ** 2).sum().backward()
        return {k: p.grad.clone() for k, p in mha.named_parameters()}

    kernels.launches.clear()
    got = grads()
    assert dict(kernels.launches) == {fa.FUSED_KERNEL_TRAIN: 1, fa.FUSED_KERNEL_BWD: 1}
    monkeypatch.setattr(attention_mod, "fused_attention", fa.fused_attention_plain)
    want = grads()
    assert dict(kernels.launches) == {fa.FUSED_KERNEL_TRAIN: 1, fa.FUSED_KERNEL_BWD: 1}
    for name in want:
        assert float(got[name].abs().max()) > 0, name
        cos = torch.nn.functional.cosine_similarity(
            got[name].flatten(), want[name].flatten(), dim=0)
        assert float(cos) >= 0.999, (name, float(cos))


# ---------------------------------------------------------------------------
# Kernel B2 (blockwise flash attention) and P1 (its exp2 form)

# ViT-B/16 at 512 px first (bf16, fp32), then N = 1, a ragged N <= 1024,
# N = 2048 and 4096, and head dims 32 and 128
BLOCKWISE_CASES = [
    (64, 12, 1025, 64, "bfloat16"),
    (16, 12, 1025, 64, "float32"),
    (4, 12, 1, 64, "bfloat16"),
    (4, 12, 1, 64, "float32"),
    (8, 4, 777, 64, "bfloat16"),
    (8, 4, 777, 64, "float32"),
    (4, 6, 2048, 64, "bfloat16"),
    (2, 6, 4096, 64, "bfloat16"),
    (8, 4, 300, 32, "bfloat16"),
    (8, 4, 300, 32, "float32"),
    (4, 2, 1100, 128, "bfloat16"),
    (4, 2, 1100, 128, "float32"),
]
# The bf16 backward's ragged edges past 1024: one query and key tile past a
# 64-row edge (1088 = 17 tiles; 1089 one row into the 18th) and a whole
# 128-row block (1152 = 9 blocks)
BLOCKWISE_BWD_EDGES = [
    (4, 4, 1088, 64, "bfloat16"),
    (4, 4, 1089, 64, "bfloat16"),
    (4, 4, 1152, 64, "bfloat16"),
]
# lse: max |kernel - plain| over max |plain|; the scores' sums run in
# another order, and the bf16 kernels' exponentials are ex2.approx
LSE_REL_TOL = 1e-5


def _blockwise_grad_errs(q, k, v, do, scale, got, want):
    """Each of dq, dk, dv: max |kernel - plain| over max |plain|, the
    denominator floored at 1e-3 of the scale of the terms that cancel in
    dq and dk, scale max_i |do_i| max_j |v_j| max(|q|, |k|) (row norms):
    they are sums of p (dp - delta) scale, and delta (from do and o)
    cancels dp only to rounding. Where the exact gradient is 0 (N = 1, one
    key) both sides give that rounding noise."""
    def top(x):
        return float(x.float().abs().max())

    floor = 1e-3 * scale * top(do.float().norm(dim=-1)) * top(v.float().norm(dim=-1)) \
        * max(top(q), top(k))
    return [float((g.float() - w.float()).abs().max()) / max(top(w), floor, 1e-30)
            for g, w in zip(got, want)]


@pytest.mark.parametrize("b,h,n,d,dtype", BLOCKWISE_CASES)
def test_blockwise_forward_matches_plain(cuda_device, b, h, n, d, dtype):
    """One launch of blockwise_fwd: o within BF16_TOL / FP32_TOL of the
    plain version at the kernel's key tile (the bf16 output depends on the
    tiling: p rounds relative to the running max), lse within LSE_REL_TOL."""
    dt = getattr(torch, dtype)
    q, k, v = _head_inputs(b, h, n, d, dt, cuda_device, seed=b + n + 2)
    scale = 1.0 / d ** 0.5
    before = kernels.launches[fb.KERNEL]
    out, lse = fb.blockwise_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernels.launches[fb.KERNEL] == before + 1
    ref, ref_lse = fb.blockwise_attention_reference(q, k, v, scale, fb.KERNEL_BLOCK_K)
    assert out.dtype == dt and out.shape == ref.shape and torch.isfinite(out).all()
    assert lse.dtype == torch.float32 and lse.shape == (b, h, n)
    torch.testing.assert_close(
        out.float(), ref.float(), **(FP32_TOL if dtype == "float32" else BF16_TOL))
    assert _rel_err(lse, ref_lse) <= LSE_REL_TOL, _rel_err(lse, ref_lse)


@pytest.mark.parametrize("with_dlse", [True, False], ids=["dlse", "no-dlse"])
@pytest.mark.parametrize("b,h,n,d,dtype", BLOCKWISE_CASES + BLOCKWISE_BWD_EDGES)
def test_blockwise_backward_matches_plain(cuda_device, b, h, n, d, dtype, with_dlse):
    """blockwise_bwd_dq and blockwise_bwd_dkv once each: dq, dk, dv within
    GRAD_REL_TOL of max|plain| (floored, _blockwise_grad_errs) from the same
    o and lse, with and without an lse cotangent, at every case and at the
    bf16 backward's ragged edges; a second call gives the same bits (no
    atomics)."""
    dt = getattr(torch, dtype)
    q, k, v = _head_inputs(b, h, n, d, dt, cuda_device, seed=b + n + 3)
    (do,) = _head_inputs(b, h, n, d, torch.float32, cuda_device, seed=13)[:1]
    dlse = (torch.randn(b, h, n, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(14)) if with_dlse else None)
    scale = 1.0 / d ** 0.5
    out, lse = fb.blockwise_attention_fwd(q, k, v, scale)
    before = dict(kernels.launches)
    got = fb.blockwise_attention_bwd(q, k, v, out, lse, do, scale, dlse)
    torch.cuda.synchronize()
    for entry in (fb.KERNEL_DQ, fb.KERNEL_DKV):
        assert kernels.launches[entry] == before.get(entry, 0) + 1
    want = fb.blockwise_attention_bwd_reference(q, k, v, out, lse, do, scale, dlse)
    errs = _blockwise_grad_errs(q, k, v, do, scale, got, want)
    for name, g, w, err in zip(("dq", "dk", "dv"), got, want, errs):
        assert g.dtype == dt and g.shape == w.shape and torch.isfinite(g).all(), name
        assert err <= GRAD_REL_TOL[dtype], (name, err)
    again = fb.blockwise_attention_bwd(q, k, v, out, lse, do, scale, dlse)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("b,h,n,d", [(8, 6, 2048, 64), (4, 6, 4096, 64),
                                     (64, 12, 1025, 64), (4, 2, 1100, 128),
                                     (4, 12, 1, 64), (8, 4, 300, 32)])
def test_exp2_forward_matches_plain_and_b2(cuda_device, b, h, n, d):
    """P1 (bf16): o within BF16_TOL of its plain version at the kernel's
    tile and within the probe's atol/rtol 3e-2 of B2's forward; its lse,
    returned as natural log, within LSE_REL_TOL of B2's."""
    q, k, v = _head_inputs(b, h, n, d, torch.bfloat16, cuda_device, seed=n + 4)
    scale = 1.0 / d ** 0.5
    before = kernels.launches[fb.KERNEL_EXP2]
    out, lse = fb.blockwise_attention_fwd_exp2(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernels.launches[fb.KERNEL_EXP2] == before + 1
    ref, ref_lse = fb.blockwise_attention_exp2_reference(q, k, v, scale,
                                                         fb.KERNEL_BLOCK_K)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    b2, b2_lse = fb.blockwise_attention_fwd(q, k, v, scale)
    torch.testing.assert_close(out.float(), b2.float(), atol=3e-2, rtol=3e-2)
    assert _rel_err(lse, b2_lse) <= LSE_REL_TOL
    assert _rel_err(lse, ref_lse) <= LSE_REL_TOL


@pytest.mark.parametrize("d,dtype", [(32, "bfloat16"), (64, "bfloat16"),
                                     (128, "bfloat16"), (64, "float32")])
def test_blockwise_forward_repeats_bit_for_bit(cuda_device, d, dtype):
    """No atomics, no order that changes between calls: two forward calls
    on the same inputs give the same o and lse, in every bf16 head dim (B2
    and P1) and in fp32."""
    dt = getattr(torch, dtype)
    q, k, v = _head_inputs(4, 12 * 64 // d, 1025, d, dt, cuda_device, seed=d + 21)
    forwards = [fb.blockwise_attention_fwd]
    if dtype == "bfloat16":
        forwards.append(fb.blockwise_attention_fwd_exp2)
    for forward in forwards:
        first = forward(q, k, v, d ** -0.5)
        second = forward(q, k, v, d ** -0.5)
        assert all(torch.equal(a, c) for a, c in zip(first, second)), forward.__name__


@pytest.mark.parametrize("n", [1025, 70])
def test_blockwise_forward_keeps_to_its_head(cuda_device, n):
    """A tile that ran past row n of one head would read the next head's
    rows: with a NaN planted in head 1's K, heads 0 and 2 stay finite and
    equal the plain version of each head alone at the kernel's tile (o
    within BF16_TOL, lse within LSE_REL_TOL), in B2 and P1."""
    b, h, d = 2, 3, 64
    q, k, v = _head_inputs(b, h, n, d, torch.bfloat16, cuda_device, seed=n + 22)
    k[:, 1, n // 2, 3] = float("nan")
    for forward, plain in ((fb.blockwise_attention_fwd, fb.blockwise_attention_reference),
                           (fb.blockwise_attention_fwd_exp2,
                            fb.blockwise_attention_exp2_reference)):
        out, lse = forward(q, k, v, 0.125)
        torch.cuda.synchronize()
        assert not torch.isfinite(out[:, 1]).all()  # the planted NaN spreads in its head
        for head in (0, 2):
            alone = [x[:, head:head + 1].contiguous() for x in (q, k, v)]
            ref, ref_lse = plain(*alone, 0.125, fb.KERNEL_BLOCK_K)
            got = out[:, head:head + 1]
            assert torch.isfinite(got).all() and torch.isfinite(lse[:, head]).all()
            torch.testing.assert_close(got.float(), ref.float(), **BF16_TOL)
            assert _rel_err(lse[:, head:head + 1], ref_lse) <= LSE_REL_TOL


@pytest.mark.parametrize("where", ["k", "do"])
@pytest.mark.parametrize("n", [1025, 70])
def test_blockwise_backward_keeps_to_its_head(cuda_device, n, where):
    """A tile, a statistic or a delta read past row n of one head would
    read the next head's: with a NaN planted in head 1's K (so its o and
    lse are NaN too), and apart from that in head 1's dO, the backward's
    dq, dk and dv of heads 0 and 2 stay finite and within GRAD_REL_TOL
    (floored) of the plain version of each head alone, with an lse
    cotangent."""
    b, h, d = 2, 3, 64
    q, k, v, do = (_head_inputs(b, h, n, d, torch.bfloat16, cuda_device, seed=n + 24)
                   + _head_inputs(b, h, n, d, torch.bfloat16, cuda_device, seed=n + 25))[:4]
    dlse = torch.randn(b, h, n, device=cuda_device,
                       generator=torch.Generator(device=cuda_device).manual_seed(26))
    {"k": k, "do": do}[where][:, 1, n // 2, 3] = float("nan")
    out, lse = fb.blockwise_attention_fwd(q, k, v, 0.125)
    got = fb.blockwise_attention_bwd(q, k, v, out, lse, do, 0.125, dlse)
    torch.cuda.synchronize()
    assert not torch.isfinite(got[0][:, 1]).all()  # the NaN spreads in its head
    for head in (0, 2):
        alone = [x[:, head:head + 1].contiguous() for x in (q, k, v, out, lse, do)]
        want = fb.blockwise_attention_bwd_reference(*alone, 0.125,
                                                    dlse[:, head:head + 1].contiguous())
        mine = [g[:, head:head + 1] for g in got]
        errs = _blockwise_grad_errs(*alone[:3], alone[5], 0.125, mine, want)
        for name, g, err in zip(("dq", "dk", "dv"), mine, errs):
            assert torch.isfinite(g).all(), (head, name)
            assert err <= GRAD_REL_TOL["bfloat16"], (head, name, err)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_blockwise_bf16_backward_runs_the_hopper_kernels(cuda_device, d):
    """A bf16 backward launches the two kernels of attention_bwd_sm90.cuh in
    its lse form at every head dim, shown by name in a profile of the call
    (:func:`_device_kernel_names`), and no other bf16 body; the library
    holds none of the mma.sync bodies they replaced."""
    q, k, v, do = (_head_inputs(2, 4, 1025, d, torch.bfloat16, cuda_device, seed=d + 27)
                   + _head_inputs(2, 4, 1025, d, torch.bfloat16, cuda_device, seed=d + 28))[:4]
    out, lse = fb.blockwise_attention_fwd(q, k, v, d ** -0.5)
    want = (f"blockwise_bwd_dq_sm90_kernel<{d}>", f"blockwise_bwd_dkv_sm90_kernel<{d}>")
    names = _device_kernel_names(
        lambda: fb.blockwise_attention_bwd(q, k, v, out, lse, do, d ** -0.5), want=want)
    assert all(name in names for name in want), names
    assert "bf16_kernel" not in names, names
    binary = kernels.library_path(fb.BWD_LIBRARY).read_bytes()
    assert b"blockwise_bwd_dq_sm90_kernel" in binary
    assert b"blockwise_dq_bf16_kernel" not in binary and b"blockwise_dkv_bf16_kernel" not in binary


def test_vit_512_step_runs_the_hopper_backward(cuda_device):
    """ViT-B/16's widths at 512 px (N = 1025; 2 of its 12 blocks, batch 2,
    bf16, dropout on): a training forward and backward launches B2's
    forward, dq and dk/dv once a block by the launch counters, and a
    profile of the step names the Hopper backward's kernels on every dq and
    dk/dv launch and no other backward body."""
    from torch.profiler import ProfilerActivity, profile

    from vit_ssl_tpu_torch.models import ViT

    blocks = 2
    torch.manual_seed(0)
    model = ViT(num_classes=1000, num_blocks=blocks, input_shape=(3, 512, 512),
                embed_dim=768, patch_size=16, num_heads=12, mlp_dim=3072, dropout=0.1,
                dtype=torch.bfloat16).to(cuda_device)
    x = torch.rand(2, 512, 512, 3, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def step():
        model.zero_grad()
        model(x, deterministic=False, generator=gen).float().square().mean().backward()

    step()
    torch.cuda.synchronize()
    kernels.launches.clear()
    step()
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {fb.KERNEL: blocks, fb.KERNEL_DQ: blocks,
                                      fb.KERNEL_DKV: blocks}
    want = {"blockwise_bwd_dq_sm90_kernel<64>": blocks,
            "blockwise_bwd_dkv_sm90_kernel<64>": blocks}
    for _ in range(10):  # a session can lose device events (_device_kernel_names)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        got = {name: sum(c for key, c in counts.items() if name in key) for name in want}
        if got == want:
            break
    assert got == want, counts
    assert not any("blockwise_d" in key and "bf16_kernel" in key for key in counts), counts


@pytest.mark.parametrize("d", [32, 64, 128])
def test_blockwise_bf16_forward_runs_the_hopper_kernel(cuda_device, d):
    """A bf16 forward launches the wgmma/TMA kernel of
    flash_blockwise_fwd_sm90.cuh at every head dim, in both forms, shown by
    name in a profile of the calls (:func:`_device_kernel_names`), and no
    other bf16 body; the library holds no other."""
    q, k, v = _head_inputs(2, 4, 1025, d, torch.bfloat16, cuda_device, seed=d + 23)

    def both_forms():
        fb.blockwise_attention_fwd(q, k, v, d ** -0.5)
        fb.blockwise_attention_fwd_exp2(q, k, v, d ** -0.5)

    names = _device_kernel_names(both_forms, want=(f"blockwise_fwd_sm90_kernel<{d}, false>",
                                                   f"blockwise_fwd_sm90_kernel<{d}, true>"))
    assert f"blockwise_fwd_sm90_kernel<{d}, false>" in names, names
    assert f"blockwise_fwd_sm90_kernel<{d}, true>" in names, names
    assert "bf16_kernel" not in names, names
    binary = kernels.library_path(fb.FWD_LIBRARY).read_bytes()
    assert b"blockwise_fwd_sm90_kernel" in binary and b"blockwise_fwd_bf16_kernel" not in binary


def test_blockwise_refuses_what_the_kernels_cannot_take(cuda_device):
    x = torch.zeros(2, 2, 37, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        fb.blockwise_attention(x, x, x, 0.125)
    x = torch.zeros(2, 2, 37, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fb.blockwise_attention(x, x.transpose(2, 3).contiguous().transpose(2, 3), x, 0.125)
    with pytest.raises(ValueError, match="bfloat16"):
        fb.blockwise_attention_fwd_exp2(x, x, x, 0.125)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="scale > 0"):
        fb.blockwise_attention(xb, xb, xb, 0.0)
    with pytest.raises(ValueError, match="scale > 0"):
        fb.blockwise_attention_fwd_exp2(xb, xb, xb, -0.125)
    with pytest.raises(ValueError, match="lse"):
        fb.blockwise_attention_bwd(x, x, x, x, torch.zeros(2, 2, 36, device=cuda_device),
                                   x, 0.125)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_multi_head_attention_gradient_through_b2(cuda_device, monkeypatch, dtype):
    """ViT-B's widths at N = 1025 (ViT-B/16 at 512 px) route to B2: one
    forward and one launch of each backward kernel, nothing else; every
    parameter's gradient equals the plain path's (cosine >= 0.999)."""
    dt = getattr(torch, dtype)
    torch.manual_seed(0)
    mha = attention_mod.MultiHeadAttention(768, 12, dtype=dt).to(cuda_device)
    x = torch.randn(2, 1025, 768, device=cuda_device)

    def grads():
        mha.zero_grad()
        (mha(x).float() ** 2).sum().backward()
        return {k: p.grad.clone() for k, p in mha.named_parameters()}

    launched = {fb.KERNEL: 1, fb.KERNEL_DQ: 1, fb.KERNEL_DKV: 1}
    kernels.launches.clear()
    got = grads()
    assert dict(kernels.launches) == launched
    monkeypatch.setattr(attention_mod, "blockwise_attention", fb.blockwise_attention_plain)
    want = grads()
    assert dict(kernels.launches) == launched
    for name in want:
        assert float(got[name].abs().max()) > 0, name
        cos = torch.nn.functional.cosine_similarity(
            got[name].flatten(), want[name].flatten(), dim=0)
        assert float(cos) >= 0.999, (name, float(cos))


# Kernel P2 (dropout-masked second FFN product), (T, d_ff, d_out): the DINO
# student-globals FFN, a ragged T, T = 1, ViT-B/16's FFN at 384 px
MASKED_CASES = [(37120, 1536, 384), (5365, 1536, 384), (1, 1536, 384),
                (36928, 3072, 768)]


def _masked_inputs(t, d_ff, d_out, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy(
            scale * rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)

    h = torch.nn.functional.gelu(arr(t, d_ff).float()).to(dtype)
    mask = torch.from_numpy(rng.random((t, d_ff)) >= 0.1).to(device)
    return h, mask, arr(d_out, d_ff, scale=d_ff ** -0.5), arr(d_out, scale=0.1), arr(t, d_out)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t,d_ff,d_out", MASKED_CASES)
def test_masked_matmul_matches_plain(cuda_device, t, d_ff, d_out, dtype):
    """The forward, and the backward's dh, dw2 and db2 (which repeat bit for
    bit: no atomics), each one launch."""
    h, mask, w2, b2, do = _masked_inputs(t, d_ff, d_out, getattr(torch, dtype),
                                         cuda_device, t)
    before = dict(kernels.launches)
    out = mm.masked_matmul_fwd(h, mask, w2, b2, 0.9)
    got = mm.masked_matmul_bwd(h, mask, do, w2, 0.9)
    torch.cuda.synchronize()
    assert kernels.launches[mm.KERNEL] == before.get(mm.KERNEL, 0) + 1
    assert kernels.launches[mm.KERNEL_BWD] == before.get(mm.KERNEL_BWD, 0) + 1
    pairs = [(out, mm.masked_matmul_reference(h, mask, w2, b2, 0.9)),
             *zip(got, mm.masked_matmul_bwd_reference(h, mask, do, w2, 0.9))]
    for g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        assert _rel_err(g, w) <= MLP_REL_TOL[dtype], _rel_err(g, w)
    again = mm.masked_matmul_bwd(h, mask.to(torch.uint8), do, w2, 0.9)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_masked_matmul_refuses_what_the_kernels_cannot_take(cuda_device):
    h, mask, w2, b2, _ = _masked_inputs(8, 192, 128, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiples of 128"):
        mm.masked_matmul(h, mask, w2, b2, 0.9)
    h, mask, w2, b2, _ = _masked_inputs(8, 256, 128, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="nn.Linear layout"):
        mm.masked_matmul(h, mask, w2.t().contiguous(), b2, 0.9)
    with pytest.raises(ValueError, match="keep-mask"):
        mm.masked_matmul(h, mask.float(), w2, b2, 0.9)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_masked_matmul_gradient_through_kernels(cuda_device, dtype):
    """Autograd through masked_matmul on the card: one forward and one
    backward launch, the plain versions' gradients for h, w2 and b2."""
    h, mask, w2, b2, do = _masked_inputs(1000, 1536, 384, getattr(torch, dtype),
                                         cuda_device, 3)
    leaves = [y.clone().requires_grad_() for y in (h, w2, b2)]
    kernels.launches.clear()
    got = torch.autograd.grad(mm.masked_matmul(leaves[0], mask, *leaves[1:], 0.9),
                              leaves, do)
    assert dict(kernels.launches) == {mm.KERNEL: 1, mm.KERNEL_BWD: 1}
    want = mm.masked_matmul_bwd_reference(h, mask, do, w2, 0.9)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= MLP_REL_TOL[dtype], _rel_err(g, w)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
from vit_ssl_tpu_torch.ops import attention as attention_mod
from vit_ssl_tpu_torch.ops import flash_attention as fa

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

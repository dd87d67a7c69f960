"""The supervised ViT at N = 1025 (kernel B2's route) against the JAX
package's, on the CPU.

ViT-B/16 at 512 px has (512/16)² + 1 = 1025 tokens, one more than kernels
B1 and B3 take: both packages send every block's attention to the
blockwise kernel B2. Here a narrow ViT (2 blocks, embed 32, 2 heads of 16)
at 64 px with patch 2 has the same N = 1025, and both packages pick B2
without help (JAX's in interpret mode, the port's plain versions): logits
and input gradient at atol/rtol 1e-4, as ``tests/test_torch_vit.py``. A
narrow ViT at the config's own 512 px and patch 16 is served from a
``.pth`` and answers what the JAX module answers. The full-width config
is checked by its shapes and routing only: it runs on the card
(``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ssl_tpu.ops.attention as jax_attention_mod
from vit_ssl_tpu.config import compose, to_container
from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu.ops import flash_attention as jfa
from vit_ssl_tpu_torch import serve
from vit_ssl_tpu_torch.models import ViT
from vit_ssl_tpu_torch.ops import attention as attention_mod
from vit_ssl_tpu_torch.ops import flash_attention as fa
from vit_ssl_tpu_torch.utils.checkpoint import vit_state_dict_from_flax

TOL = dict(atol=1e-4, rtol=1e-4)
NARROW = dict(num_classes=10, num_blocks=2, input_shape=(3, 64, 64), embed_dim=32,
              patch_size=2, num_heads=2, mlp_dim=64, dropout=0.0)
N = (64 // 2) ** 2 + 1  # 1025


def _jiggle(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(np.shape(p)).astype(np.float32),
        params,
    )


def _spy(monkeypatch, module, name):
    """Record the q shape of every call of ``module.name``."""
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda q, *a, **kw: calls.append(tuple(q.shape)) or real(q, *a, **kw))
    return calls


def test_narrow_vit_at_n1025_takes_b2_and_matches_jax(monkeypatch):
    """Both packages route the N = 1025 blocks to B2 on their own; logits
    and the input gradient agree at TOL."""
    assert N == 1025 and not jfa.flash_attention_available(N)
    assert not jfa.attention_nhd_profitable(N, 2, 2, 32, 4)
    assert fa.attention_route(2, N, 2, 32, 4) == "B2"
    jax_calls = _spy(monkeypatch, jax_attention_mod, "blockwise_attention")
    port_calls = _spy(monkeypatch, attention_mod, "blockwise_attention")
    module = JaxViT(**NARROW)
    params = _jiggle(module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
                     ["params"], 1)
    jax_calls.clear()  # init's trace
    rng = np.random.default_rng(2)
    x = rng.random((2, 64, 64, 3), np.float32)
    g = rng.standard_normal((2, 10)).astype(np.float32)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    assert jax_calls == [(2, 2, N, 16)] * 2
    want_gx = np.asarray(jax.grad(lambda xin: jnp.sum(
        module.apply({"params": params}, xin) * jnp.asarray(g)))(jnp.asarray(x)))

    vit = ViT(**NARROW)
    vit.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    logits = vit(xt)
    (logits * torch.from_numpy(g)).sum().backward()
    assert port_calls == [(2, 2, N, 16)] * 2
    np.testing.assert_allclose(logits.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, **TOL)


def test_vit_b_config_at_512_is_the_b2_shape():
    """configs/vit_b_imagenet.yaml with data.img_size=512: 1025 tokens of 12
    heads of 64, past B1's and B3's 1024: JAX picks its blockwise kernel
    and the port B2, in bf16 and fp32."""
    cfg = to_container(compose("configs", "vit_b_imagenet",
                               overrides=["data.img_size=512"]))
    m = cfg["model"]
    n = (512 // m["patch_size"]) ** 2 + 1
    assert (n, m["num_heads"], m["embed_dim"]) == (1025, 12, 768)
    for itemsize in (2, 4):
        assert not jfa.attention_nhd_profitable(n, 64, m["num_heads"], m["embed_dim"],
                                                itemsize)
        assert not jfa.flash_attention_available(n)
        assert fa.attention_route(64, n, m["num_heads"], m["embed_dim"], itemsize) == "B2"


@pytest.fixture(scope="module")
def served_512(tmp_path_factory):
    """configs/vit_b_imagenet.yaml at 512 px and patch 16 (N = 1025),
    narrowed to 1 block of embed 32 in fp32: JAX's weights written as the
    ``.pth`` the port serves, and JAX's logits on three images."""
    cfg = to_container(compose("configs", "vit_b_imagenet", overrides=[
        "data.img_size=512", "model.embed_dim=32", "model.num_heads=2",
        "model.num_blocks=1", "model.mlp_dim=64", "model.num_classes=5",
        "model.compute_dtype=float32", "parallel.remat=false"]))
    m = cfg["model"]
    module = JaxViT(num_classes=5, num_blocks=1, input_shape=(3, 512, 512),
                    embed_dim=32, patch_size=m["patch_size"], num_heads=2, mlp_dim=64,
                    dropout=m["dropout"])
    params = _jiggle(module.init(jax.random.PRNGKey(3), jnp.zeros((1, 512, 512, 3)))
                     ["params"], 4)
    pth = str(tmp_path_factory.mktemp("vit_512") / "vit_512.pth")
    torch.save({"model_state_dict": vit_state_dict_from_flax(params), "config": cfg,
                "epoch": 0}, pth)
    x = np.random.default_rng(5).random((3, 512, 512, 3), np.float32)
    return pth, x, np.asarray(module.apply({"params": params}, jnp.asarray(x)))


def test_served_512px_checkpoint_matches_jax(served_512, monkeypatch):
    """``Server.forward_batch`` at batch 2 on a ``.pth`` at 512 px: one B2
    call a batch (N = 1025), logits at TOL against the JAX module, and a
    zero-padded short batch gives the full batch's rows."""
    pth, x, want = served_512
    calls = _spy(monkeypatch, attention_mod, "blockwise_attention")
    server = serve.Server(pth, batch_size=2, device="cpu")
    assert server.classifier and server.img == 512
    calls.clear()  # the server's start-up warm batch
    full = server.forward_batch(x[:2])
    assert calls == [(2, 2, 1025, 16)]
    short = server.forward_batch(x[2:])
    np.testing.assert_allclose(full, want[:2], **TOL)
    np.testing.assert_allclose(short, want[2:], **TOL)
    np.testing.assert_array_equal(server.forward_batch(x[:1]), full[:1])

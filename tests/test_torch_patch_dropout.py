"""The port's patch dropout (``model.patch_dropout``, PatchDropout, Liu et
al., arXiv:2208.07220) against the JAX package's, on the CPU.

- Given the uniform scores JAX draws (numpy-seeded scores handed to both
  packages), the port keeps the same patch indices, gives the same tokens
  (exact) and the same training logits as JAX's ViT (fp32, atol/rtol 1e-5).
- The keep count max(1, round(n·(1 − p))) equals JAX's over a grid of p
  and n; the CLS token is always kept.
- Evaluation and ``return_attn`` see every token; a training step runs
  under remat and ``grad_accum``, remat bit-equal to no remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu_torch.models import ViT
from vit_ssl_tpu_torch.models import vit as vit_mod
from vit_ssl_tpu_torch.train import AdamW, SupervisedTrainState, make_supervised_steps
from vit_ssl_tpu_torch.utils.checkpoint import vit_state_dict_from_flax

NET = dict(num_classes=5, num_blocks=2, input_shape=(3, 16, 16), embed_dim=32,
           patch_size=4, num_heads=2, mlp_dim=64, dropout=0.0, patch_dropout=0.5)
N = 16  # patches of a 16-px image at patch 4


@pytest.fixture(autouse=True)
def two_threads():
    """Two CPU threads for the port (the suite runs beside other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _random_params(module, x, seed):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.05 * noise if path[-1].key == "scale" else 0.2 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture
def shared_scores(monkeypatch):
    """One (B, N) score table for both packages: JAX's ``jax.random.uniform``
    (its only draw with dropout 0) and the port's ``draw_patch_scores``."""
    scores = np.random.default_rng(1).random((3, N), np.float32)
    real = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) == scores.shape:
            return jnp.asarray(scores)
        return real(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(vit_mod, "draw_patch_scores",
                        lambda generator, b, n: torch.from_numpy(scores).reshape(b, n))
    return scores


def test_tokens_and_logits_match_jax_given_its_scores(shared_scores):
    module = JaxViT(**NET)
    x = np.random.default_rng(2).random((3, 16, 16, 3), np.float32)
    params = _random_params(module, x, 3)
    rngs = {"dropout": jax.random.PRNGKey(4)}
    want_tokens = module.apply({"params": params}, jnp.asarray(x), False,
                               method=module.embed, rngs=rngs)
    want = module.apply({"params": params}, jnp.asarray(x), False, rngs=rngs)
    vit = ViT(**NET)
    vit.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    gen = torch.Generator().manual_seed(0)
    tokens = vit.embed(torch.from_numpy(x), False, gen)
    keep = vit_mod.patch_keep_count(N, 0.5)
    assert tokens.shape == (3, 1 + keep, 32) == want_tokens.shape
    np.testing.assert_array_equal(tokens.detach().numpy(), np.asarray(want_tokens))
    idx = vit_mod.patch_keep_indices(torch.from_numpy(shared_scores), keep)
    np.testing.assert_array_equal(
        idx.numpy(), np.argsort(shared_scores, axis=-1, kind="stable")[:, :keep])
    logits = vit(torch.from_numpy(x), False, gen)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5, 0.75, 0.9, 0.99])
def test_keep_count_matches_jax(rate):
    """Over n = 1…200: the port's keep count is the length JAX's
    ``_drop_patches`` gives (its shape, traced)."""
    module = JaxViT(**{**NET, "patch_dropout": rate})
    for n in list(range(1, 40)) + [49, 64, 98, 144, 196, 200]:
        out = jax.eval_shape(
            lambda t: module.apply({}, t, method=module._drop_patches,
                                   rngs={"dropout": jax.random.PRNGKey(0)}),
            jax.ShapeDtypeStruct((2, n + 1, 8), jnp.float32))
        assert vit_mod.patch_keep_count(n, rate) == out.shape[1] - 1, (n, rate)
    assert vit_mod.patch_keep_count(196, 0.5) == 98


def test_cls_is_kept_and_eval_and_return_attn_see_every_token():
    torch.manual_seed(5)
    vit = ViT(**NET)
    x = torch.rand(2, 16, 16, 3)
    full = vit.patch_embedding(x)
    kept = vit.embed(x, False, torch.Generator().manual_seed(6))
    assert torch.equal(kept[:, 0], full[:, 0])
    # every kept token is one of the image's own patch tokens, none twice
    for b in range(2):
        rows = [int((full[b, 1:] == t).all(-1).nonzero()) for t in kept[b, 1:]]
        assert len(set(rows)) == len(rows) == vit_mod.patch_keep_count(N, 0.5)
    assert torch.equal(vit.embed(x, True), full)
    logits, probs = vit(x, False, torch.Generator().manual_seed(6), return_attn=True)
    assert probs.shape == (2, 2, 1 + N, 1 + N)
    with torch.no_grad():
        assert torch.equal(vit(x), vit.finish(vit.encode(full)))


def test_training_step_with_remat_and_grad_accum():
    """Two steps with grad_accum 2 and dropout 0.1: finite, the parameters
    move, and remat gives the no-remat step bit for bit."""
    rng = np.random.default_rng(7)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)),
             "label": torch.arange(4), "weight": torch.ones(4)}
    states = []
    for remat in (False, True):
        vit = ViT(**{**NET, "dropout": 0.1}, remat=remat)
        vit.reset_parameters(torch.Generator().manual_seed(8))
        before = [p.detach().clone() for p in vit.parameters()]
        optimizer = AdamW(lambda step: 1e-3)
        state = SupervisedTrainState(vit, optimizer, seed=9)
        train_step, _ = make_supervised_steps(optimizer, grad_accum=2)
        losses = [float(train_step(state, batch)["loss"]) for _ in range(2)]
        assert all(np.isfinite(losses))
        assert any(not torch.equal(a, b) for a, b in zip(before, vit.parameters()))
        states.append((losses, vit.state_dict()))
    assert states[0][0] == states[1][0]
    for k, v in states[0][1].items():
        assert torch.equal(v, states[1][1][k]), k

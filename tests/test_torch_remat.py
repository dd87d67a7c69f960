"""``parallel.remat`` in the port (``ops/encoder_block.py::remat_block``)
against the port without it and against the JAX package's ``nn.remat``.

- With dropout on (rate 0.2), the supervised ViT and the DINO network (the
  globals, and the packed locals with their block-diagonal mask) give the
  same loss, gradients and final generator state bit for bit with and
  without remat, on the CPU: each checkpointed block replays the masks it
  drew.
- At dropout 0, on weights bridged from the JAX package, the port's remat
  gradients match JAX's remat gradients at rtol 1e-5, with an absolute
  floor of 1e-5 of the tensor's largest gradient entry (sums run in
  another order in each framework: the attention weights' smallest
  entries differ by up to 1.6e-6 of that largest one).
- Remat keeps fewer activations for the backward than the plain forward,
  and the wrapper is skipped where no backward runs (no grad mode, a
  network whose parameters need no gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_ssl_tpu.models.dino import DINONetwork as JaxDINONetwork
from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu.utils.checkpoint import dino_params_to_torch, vit_params_to_torch
from vit_ssl_tpu_torch.models import DINONetwork, ViT
from vit_ssl_tpu_torch.models import dino as dino_mod
from vit_ssl_tpu_torch.models import vit as vit_mod
from vit_ssl_tpu_torch.utils.checkpoint import dino_state_dict_from_flax, vit_state_dict_from_flax

VIT = dict(num_classes=5, num_blocks=3, input_shape=(3, 16, 16), embed_dim=32,
           patch_size=4, num_heads=2, mlp_dim=64)
DINO = dict(num_blocks=3, input_shape=(3, 16, 16), embed_dim=32, patch_size=8,
            num_heads=2, mlp_dim=64, output_dim=16)
GRAD_RTOL = 1e-5
GRAD_FLOOR = 1e-5  # of the tensor's largest gradient entry


def _pair(cls, kwargs, dropout):
    plain = cls(dropout=dropout, **kwargs)
    plain.reset_parameters(torch.Generator().manual_seed(1))
    remat = cls(dropout=dropout, remat=True, **kwargs)
    remat.load_state_dict(plain.state_dict())
    return plain, remat


def _run(model, forward, seed=5):
    """Loss, gradients and the generator's state after one forward with
    dropout on and its backward."""
    generator = torch.Generator().manual_seed(seed)
    loss = forward(model, generator).float().square().mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, grads, generator.get_state()


def _assert_bit_equal(a, b):
    assert torch.equal(a[0], b[0])
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    assert torch.equal(a[2], b[2])


FORWARDS = {
    "vit": (ViT, VIT, lambda m, g, x: m(x, False, g)),
    "dino_globals": (DINONetwork, DINO, lambda m, g, x: m(x, False, g)),
    "dino_packed_locals": (DINONetwork, DINO,
                           lambda m, g, x: m.forward_packed(x, 4, False, g)),
}


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_remat_is_bit_equal_with_dropout_on(name):
    cls, kwargs, forward = FORWARDS[name]
    plain, remat = _pair(cls, kwargs, dropout=0.2)
    x = torch.from_numpy(np.random.default_rng(0).random((8, 16, 16, 3), np.float32))
    got = _run(remat, lambda m, g: forward(m, g, x))
    want = _run(plain, lambda m, g: forward(m, g, x))
    _assert_bit_equal(got, want)
    # the masks were drawn: a second seed changes the loss
    assert not torch.equal(_run(plain, lambda m, g: forward(m, g, x), seed=6)[0], want[0])


def _saved_numel(model, x):
    """Elements autograd keeps for the backward of one forward."""
    total = [0]

    def pack(t):
        total[0] += t.numel()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x, False, torch.Generator().manual_seed(0))
    return total[0]


def test_remat_keeps_fewer_activations():
    plain, remat = _pair(ViT, VIT, dropout=0.1)
    x = torch.rand(8, 16, 16, 3)
    assert _saved_numel(remat, x) < _saved_numel(plain, x) / 2


@pytest.mark.parametrize("where", ["no_grad", "frozen", "train"])
def test_wrapper_is_skipped_where_no_backward_runs(where, monkeypatch):
    calls = []
    for module in (vit_mod, dino_mod):
        real = module.remat_block
        monkeypatch.setattr(module, "remat_block",
                            lambda *a, _real=real, **kw: calls.append(1) or _real(*a, **kw))
    vit = ViT(remat=True, dropout=0.1, **VIT)
    net = DINONetwork(remat=True, dropout=0.1, **DINO)
    x = torch.rand(2, 16, 16, 3)
    if where == "frozen":  # the DINO teacher
        vit.requires_grad_(False)
        net.requires_grad_(False)
    with torch.set_grad_enabled(where != "no_grad"):
        vit(x, False, torch.Generator().manual_seed(0))
        net(x, False, torch.Generator().manual_seed(0))
        vit(x, True, return_attn=True)
    want = 2 * VIT["num_blocks"] - 1 + DINO["num_blocks"] if where == "train" else 0
    assert len(calls) == want


def _close(got, want, key):
    floor = GRAD_FLOOR * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=floor, err_msg=key)


def test_vit_remat_gradients_match_jax_remat():
    module = JaxViT(dropout=0.0, remat=True, **VIT)
    rng = np.random.default_rng(3)
    x = rng.random((4, 16, 16, 3), np.float32)
    labels = rng.integers(0, 5, 4)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]

    def loss_fn(p):
        logits = module.apply({"params": p}, jnp.asarray(x), deterministic=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    want = vit_params_to_torch(jax.jit(jax.grad(loss_fn))(params))
    port = ViT(dropout=0.0, remat=True, **VIT)
    port.load_state_dict(vit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    logits = port(torch.from_numpy(x), False, torch.Generator().manual_seed(0))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    names = [n for n, _ in port.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(port.parameters()))))
    assert set(got) == set(want)
    for key, value in want.items():
        _close(got[key].numpy(), np.asarray(value, np.float32).reshape(got[key].shape), key)


def test_dino_remat_gradients_match_jax_remat():
    module = JaxDINONetwork(dropout=0.0, remat=True, **DINO)
    x = np.random.default_rng(4).random((4, 16, 16, 3), np.float32)
    params = module.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))["params"]

    def loss_fn(p):
        return jnp.mean(jnp.square(module.apply({"params": p}, jnp.asarray(x),
                                                deterministic=True)))

    grads = jax.jit(jax.grad(loss_fn))(params)
    want = {k[len("student_"):]: v for k, v in
            dino_params_to_torch(grads, grads, np.zeros((1, 16))).items()
            if k.startswith("student_")}
    port = DINONetwork(dropout=0.0, remat=True, **DINO)
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = dino_state_dict_from_flax(tree, tree, np.zeros((1, 16), np.float32))
    port.load_state_dict({k[len("student_"):]: v for k, v in sd.items()
                          if k.startswith("student_")})
    out = port(torch.from_numpy(x), False, torch.Generator().manual_seed(0))
    loss = out.float().square().mean()
    names = [n for n, _ in port.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(port.parameters()))))
    assert set(got) == set(want)
    for key, value in want.items():
        _close(got[key].numpy(), np.asarray(value, np.float32).reshape(got[key].shape), key)

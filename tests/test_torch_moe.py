"""The port's Mixture-of-Experts FFN (``vit_ssl_tpu_torch.ops.moe``) and the
V-MoE ViT against the JAX package's, on the CPU.

Seeded numpy inputs at tiny widths (d 32, f 64, E 4, two dozen tokens):
routing against JAX's ``moe_routing`` under capacity overflow (exact),
``expert_capacity`` on a grid (exact), ``MoEFeedForward`` forward, router
loss and gradients with and without routing groups, the ViT with MoE blocks
(placement, logits and gradients), one supervised step with and without
``grad_accum`` (loss with the router loss, gradients, updated parameters,
``moe_dropped_frac``), remat, and sparse upcycling, all fp32 at the stated
tolerances. The JAX side is jitted; its parameters are seeded numpy drawn
in the shapes ``jax.eval_shape`` gives (no init is compiled).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_ssl_tpu.models.builder import load_weights as jax_load_weights
from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu.ops.moe import MoEFeedForward as JaxMoE
from vit_ssl_tpu.ops.moe import expert_capacity as jax_expert_capacity
from vit_ssl_tpu.ops.moe import moe_routing as jax_moe_routing
from vit_ssl_tpu.train.state import create_train_state
from vit_ssl_tpu.train.steps import make_supervised_steps as jax_make_supervised_steps
from vit_ssl_tpu_torch.models import ViT
from vit_ssl_tpu_torch.models.builder import load_weights
from vit_ssl_tpu_torch.ops import FeedForwardBlock
from vit_ssl_tpu_torch.ops.moe import (MoEFeedForward, expert_capacity, moe_routing,
                                       top_k_lower_index)
from vit_ssl_tpu_torch.train import SGD, AdamW, SupervisedTrainState, make_supervised_steps
from vit_ssl_tpu_torch.utils.checkpoint import vit_state_dict_from_flax

TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 forward and gradients
D, F_, E = 32, 64, 4
VIT = dict(num_classes=5, num_blocks=4, input_shape=(3, 16, 16), embed_dim=D,
           patch_size=4, num_heads=2, mlp_dim=F_, dropout=0.0)
MOE = dict(moe_experts=E, moe_capacity_factor=1.0, moe_group_size=17)


@pytest.fixture(autouse=True)
def two_threads():
    """Two CPU threads for the port (the suite runs beside other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x, np.float32)


def _random_params(module, x, seed):
    """Seeded numpy parameters in the shapes of ``module.init`` (traced by
    ``jax.eval_shape``, not compiled): LayerNorm scales near 1, the rest
    N(0, 0.2²)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.05 * noise if path[-1].key == "scale" else 0.2 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_matches_jax_under_overflow(top_k):
    """combine, balance, z-loss and dropped share equal JAX's (atol 1e-6)
    with a capacity that drops assignments; ties go to the lower index."""
    logits = np.random.default_rng(top_k).standard_normal((3, 24, E)).astype(np.float32)
    logits[0, :6] = logits[0, 6]  # identical rows compete for the same seats
    capacity = 4
    want_c, want_aux = jax.jit(jax.vmap(lambda lg: jax_moe_routing(lg, top_k, capacity)))(
        jnp.asarray(logits))
    got_c, got_aux = moe_routing(torch.from_numpy(logits), top_k, capacity)
    np.testing.assert_allclose(got_c.numpy(), _np(want_c), atol=1e-6)
    for key in ("balance", "zloss", "dropped_frac"):
        np.testing.assert_allclose(got_aux[key].numpy(), _np(want_aux[key]), atol=1e-6,
                                   err_msg=key)
    assert float(got_aux["dropped_frac"].max()) > 0
    tied = torch.tensor([[0.25, 0.5, 0.5, 0.25]])
    assert top_k_lower_index(tied, 2)[1].tolist() == [[1, 2]]
    assert top_k_lower_index(tied, 4)[1].tolist() == [[1, 2, 0, 3]]


def test_expert_capacity_matches_jax():
    for t in (1, 7, 17, 24, 197, 1000):
        for e in (1, 2, 4, 8):
            for k in (1, 2):
                for cf in (0.5, 1.0, 1.25, 2.0):
                    assert expert_capacity(t, e, k, cf) == jax_expert_capacity(t, e, k, cf)
    assert expert_capacity(197, 8, 2, 1.25) == 64


def _jax_moe(group_size, capacity_factor=1.0):
    module = JaxMoE(d_model=D, d_ff=F_, num_experts=E, top_k=2,
                    capacity_factor=capacity_factor, group_size=group_size, dropout=0.0)
    x = np.random.default_rng(4).standard_normal((2, 12, D)).astype(np.float32)
    params = _random_params(module, x, 5)
    return module, params, x


@pytest.mark.parametrize("group_size", [0, 6], ids=["one_group", "groups_of_6"])
def test_moe_ffn_matches_jax(group_size):
    """Output, router loss, dropped share, and the gradients of
    Σ y·g + aux by input and every parameter, at TOL."""
    module, params, x = _jax_moe(group_size)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def loss(p, xin):
        y, mut = module.apply({"params": p}, xin, deterministic=True,
                              mutable=["losses", "moe_stats"])
        aux = sum(jax.tree_util.tree_leaves(mut["losses"]))
        return jnp.sum(y * g) + aux, (y, aux, jax.tree_util.tree_leaves(mut["moe_stats"]))

    (_, (want_y, want_aux, want_dropped)), (want_gp, want_gx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    moe = MoEFeedForward(D, F_, E, top_k=2, capacity_factor=1.0, group_size=group_size,
                         dropout=0.0)
    moe.load_state_dict({k: torch.from_numpy(_np(v)) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_()
    y, aux, dropped = moe(xt)
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(want_y), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), **TOL)
    np.testing.assert_allclose(float(dropped), float(want_dropped[0]), atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), _np(want_gx), **TOL)
    for name, p in moe.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(want_gp[name]), **TOL,
                                   err_msg=name)


def test_identical_experts_equal_the_dense_ffn():
    """Every expert a copy of one dense FFN and ample capacity: the MoE
    output is the dense block's (the gates are a convex combination)."""
    torch.manual_seed(0)
    dense = FeedForwardBlock(D, F_, dropout=0.0)
    moe = MoEFeedForward(D, F_, E, top_k=2, capacity_factor=float(E), dropout=0.0)
    with torch.no_grad():
        moe.w1.copy_(dense.linear_in.weight.t().expand_as(moe.w1))
        moe.b1.copy_(dense.linear_in.bias.expand_as(moe.b1))
        moe.w2.copy_(dense.linear_out.weight.t().expand_as(moe.w2))
        moe.b2.copy_(dense.linear_out.bias.expand_as(moe.b2))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 9, D))
                         .astype(np.float32))
    y, _, dropped = moe(x)
    assert float(dropped) == 0.0
    torch.testing.assert_close(y, dense(x), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_moe_vit():
    module = JaxViT(**VIT, **MOE)
    x = np.random.default_rng(8).random((2, 16, 16, 3), np.float32)
    params = _random_params(module, x, 9)
    return module, params, x


def _port_vit(params, **kw):
    vit = ViT(**VIT, **MOE, **kw)
    vit.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return vit


def test_vit_moe_matches_jax(jax_moe_vit):
    """V-MoE placement (blocks 1 and 3 of 4), then the logits and every
    parameter's gradient of Σ logits·g + Σ aux at TOL."""
    module, params, x = jax_moe_vit
    assert [("moe" in params[f"encoder_blocks_{i}"]) for i in range(4)] == \
        [False, True, False, True]
    vit = _port_vit(params)
    assert [b.is_moe for b in vit.encoder_blocks] == [False, True, False, True]
    g = np.random.default_rng(10).standard_normal((2, 5)).astype(np.float32)

    def loss(p):
        logits, mut = module.apply({"params": p}, jnp.asarray(x), deterministic=True,
                                   mutable=["losses", "moe_stats"])
        aux = sum(jax.tree_util.tree_leaves(mut["losses"]))
        return jnp.sum(logits * g) + aux, (logits, aux)

    (_, (want, want_aux)), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    logits, aux, _ = vit(torch.from_numpy(x), return_aux=True)
    ((logits * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(logits.detach().numpy(), _np(want), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), **TOL)
    want_sd = vit_state_dict_from_flax(want_g)
    for name, p in vit.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(), **TOL,
                                   err_msg=name)


def _batch(b=4, seed=11):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, 16, 16, 3), np.float32),
            "label": rng.integers(0, 5, b).astype(np.int32),
            "weight": np.array([1, 1, 1, 0], np.float32)[:b]}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_supervised_step_matches_jax(jax_moe_vit, grad_accum):
    """One step of both packages from the same weights, dropout and router
    noise 0, each with SGD at lr 1, so that the update is the gradient: the
    loss with the router loss (rtol 1e-5), the gradients and the updated
    parameters (TOL; JAX's gradient read back as params − updated params,
    exact to 1e-8 here) and, without grad_accum, moe_dropped_frac (atol
    1e-6)."""
    module, params, _ = jax_moe_vit
    batch = _batch()
    tx = optax.sgd(1.0)
    jstep, _ = jax_make_supervised_steps(module, tx, donate=False, grad_accum=grad_accum)
    jstate, jout = jstep(create_train_state(params, tx, jax.random.PRNGKey(0)),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    before = vit_state_dict_from_flax(params)
    want = vit_state_dict_from_flax(jstate.params)

    vit = _port_vit(params)
    optimizer = SGD(lambda step: 1.0)
    state = SupervisedTrainState(vit, optimizer, seed=0)
    train_step, _ = make_supervised_steps(optimizer, grad_accum=grad_accum)
    out = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                     with_grads=True)
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-5)
    if grad_accum == 1:
        np.testing.assert_allclose(float(out["moe_dropped_frac"]),
                                   float(jout["moe_dropped_frac"]), atol=1e-6)
        assert float(out["moe_dropped_frac"]) > 0  # capacity factor 1 drops
    else:
        assert "moe_dropped_frac" not in out and "moe_dropped_frac" not in jout
    for name, g in out["grads"].items():
        want_g = (before[name] - want[name]).numpy()
        np.testing.assert_allclose(g.numpy(), want_g, **TOL, err_msg=name)
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL, err_msg=name)


def test_eval_step_has_no_router_loss(jax_moe_vit):
    """eval_step's loss is the cross-entropy alone: the router loss goes
    into the training loss only."""
    _, params, _ = jax_moe_vit
    vit = _port_vit(params)
    optimizer = AdamW(lambda step: 1e-3)
    _, eval_step = make_supervised_steps(optimizer)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    out = eval_step(SupervisedTrainState(vit, optimizer, 0), batch)
    with torch.no_grad():
        logits = vit(batch["image"])
    ce = torch.nn.functional.cross_entropy(logits, batch["label"].long(), reduction="none")
    want = (ce * batch["weight"]).sum() / batch["weight"].sum()
    assert float(out["loss"]) == pytest.approx(float(want), rel=1e-6)


def test_remat_gives_the_same_gradients_and_aux(jax_moe_vit):
    """remat on and off from the same weights, dropout on: the router loss,
    the dropped share and every gradient bit-equal (the recompute adds
    nothing to the returned loss)."""
    _, params, x = jax_moe_vit
    outs = []
    for remat in (False, True):
        vit = ViT(**{**VIT, "dropout": 0.1}, **MOE, remat=remat)
        vit.load_state_dict(vit_state_dict_from_flax(params), strict=True)
        logits, aux, dropped = vit(torch.from_numpy(x), False,
                                   torch.Generator().manual_seed(3), return_aux=True)
        (logits.square().sum() + aux).backward()
        outs.append((aux.detach(), dropped, {n: p.grad for n, p in vit.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for name, g in outs[0][2].items():
        assert torch.equal(g, outs[1][2][name]), name


@pytest.mark.parametrize("source", ["dense", "dino_extended"])
def test_sparse_upcycling_matches_jax(source):
    """A dense ViT's weights into an MoE ViT (directly, or as a DINO
    teacher backbone with extended): every expert takes its block's dense
    FFN, the router keeps its draw, as JAX's load_weights gives them; at
    ample capacity the upcycled ViT's logits are the dense ViT's (atol
    1e-5)."""
    moe_kw = dict(moe_experts=2, moe_capacity_factor=4.0)
    dense, moe = JaxViT(**VIT), JaxViT(**VIT, **moe_kw)
    x = np.random.default_rng(12).random((2, 16, 16, 3), np.float32)
    dense_params = _random_params(dense, x, 13)
    moe_params = _random_params(moe, x, 14)
    extended = source == "dino_extended"
    src = {"teacher": {"backbone": dense_params}} if extended else dense_params
    want = vit_state_dict_from_flax(jax_load_weights(moe_params, src, extended=extended))

    dense_sd = vit_state_dict_from_flax(dense_params)
    pretrained = ({f"teacher.backbone.{k}": v for k, v in dense_sd.items()}
                  if extended else dense_sd)
    got = load_weights(vit_state_dict_from_flax(moe_params), pretrained, extended)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    port = ViT(**VIT, **moe_kw)
    port.load_state_dict(got, strict=True)
    plain = ViT(**VIT)
    plain.load_state_dict(dense_sd, strict=True)
    with torch.no_grad():
        torch.testing.assert_close(port(torch.from_numpy(x)), plain(torch.from_numpy(x)),
                                   atol=1e-5, rtol=1e-5)

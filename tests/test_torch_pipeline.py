"""The port's pipeline schedule (``vit_ssl_tpu_torch/parallel/pipeline.py``)
against JAX's ``pipeline_apply`` on the 8-device CPU mesh (``conftest.py``),
with JAX's cases and bounds (``tests/test_pipeline.py``): the same
``EncoderBlock`` weights (L = 4 blocks of 32 wide, 4 heads) carried across
by the weight bridge, the same inputs.

- GPipe forward at (pp, M) = (4, 4), (4, 2), (2, 2) at 1e-5; gradients at
  pp = 4, M = 4 at 2e-4; dp × pp (JAX's data groups: each group's rows
  pipelined alone); one stage at 1e-6;
- interleaved (V = 2) forward in JAX's cases and its gradients;
- the refusals' messages and ``pipeline_bubble_fraction``, JAX's;
- the same bodies over 2 and 4 real gloo ranks (``tests/torch_dist_worker.py``)
  equal to the virtual stages, bit for bit, at dropout 0 and 0.1;
- dropout 0.1 draws the same masks at pp = 2 and pp = 4 at equal M, and
  interleaved; remat inside the stages draws no second mask;
- DINO's packed locals (a block-diagonal mask) through the stages against
  the unpipelined network, forward and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.ops import EncoderBlock as JaxEncoderBlock
from vit_ssl_tpu.parallel import create_pipe_mesh, pipeline_apply, stack_block_params
from vit_ssl_tpu.parallel.integrate import PipelinedModel
from vit_ssl_tpu.parallel.pipeline import pipeline_bubble_fraction as jax_bubble
from vit_ssl_tpu_torch.ops import EncoderBlock
from vit_ssl_tpu_torch.parallel.integrate import refuse_layout, virtual_pipeline
from vit_ssl_tpu_torch.parallel.pipeline import (
    Pipeline,
    check_schedule,
    pipeline_bubble_fraction,
    schedule,
    stage_layers,
)
from vit_ssl_tpu_torch.utils.checkpoint import encoder_block_state_dict_from_flax

L, D_MODEL, HEADS, MLP = 4, 32, 4, 64
B, N = 8, 10


@pytest.fixture(scope="module")
def setup():
    """JAX's blocks, their sequential stack, and the port's blocks on the
    same weights."""
    block = JaxEncoderBlock(d_model=D_MODEL, num_heads=HEADS, mlp_dim=MLP, dropout=0.0,
                            use_flash=False)
    x = jax.random.normal(jax.random.PRNGKey(0), (B, N, D_MODEL))
    params = {f"encoder_blocks_{i}": block.init(jax.random.PRNGKey(i + 1), x)["params"]
              for i in range(L)}

    def block_fn(layer_params, h):
        return block.apply({"params": layer_params}, h, True)

    def sequential(params, x):
        for i in range(L):
            x = block_fn(params[f"encoder_blocks_{i}"], x)
        return x

    blocks = torch.nn.ModuleList(EncoderBlock(D_MODEL, HEADS, MLP, dropout=0.0)
                                 for _ in range(L))
    for i, b in enumerate(blocks):
        b.load_state_dict(encoder_block_state_dict_from_flax(
            params[f"encoder_blocks_{i}"]), strict=True)
    return block_fn, params, x, sequential, blocks


def _port(blocks, x, pp, m=0, v=1, groups=1, grad=False):
    """The port's virtual stages over ``x`` (in ``groups`` data groups, each
    pipelined alone); with ``grad``, also the gradients of sum(out²) by
    ``(layer, name)``."""
    xt = torch.from_numpy(np.asarray(x)).requires_grad_(grad)
    pipe = Pipeline(L, pp, m, v)
    out = torch.cat([pipe(blocks, part) for part in xt.chunk(groups)])
    if not grad:
        return out.detach().numpy()
    named = [((i, n), p) for i, b in enumerate(blocks) for n, p in b.named_parameters()]
    grads = torch.autograd.grad(out.square().sum(), [p for _, p in named])
    return out.detach().numpy(), {k: g.numpy() for (k, _), g in zip(named, grads)}


def _jax_forward(block_fn, params, x, mesh, m, v=1):
    """JAX's ``pipeline_apply`` over the stacked ``params``, jitted."""
    return jax.jit(lambda params, x: pipeline_apply(
        block_fn, stack_block_params(params, L), x, mesh, num_microbatches=m,
        interleave=v))(params, x)


def _bridged(jax_grads):
    """JAX's gradient tree by the port's ``(layer, name)``."""
    return {(i, n): t.numpy() for i in range(L) for n, t in
            encoder_block_state_dict_from_flax(jax_grads[f"encoder_blocks_{i}"]).items()}


@pytest.mark.parametrize("pp,m", [(4, 4), (4, 2), (2, 2)])
def test_forward_matches_jax(setup, pp, m):
    block_fn, params, x, sequential, blocks = setup
    want = _jax_forward(block_fn, params, x, create_pipe_mesh(8, pp=pp), m)
    got = _port(blocks, x, pp, m)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(sequential(params, x)), atol=1e-5,
                               rtol=1e-5)


def _grads_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **tol)


def test_gradients_match_jax(setup):
    block_fn, params, x, sequential, blocks = setup
    mesh = create_pipe_mesh(8, pp=4)

    def loss(params, x):
        stacked = stack_block_params(params, L)
        return jnp.sum(pipeline_apply(block_fn, stacked, x, mesh, num_microbatches=4) ** 2)

    want = _bridged(jax.jit(jax.grad(loss))(params, x))
    _, got = _port(blocks, x, 4, 4, grad=True)
    _grads_close(got, want, atol=2e-4, rtol=2e-3)


def test_data_parallel_groups_match_jax(setup):
    """dp = 2 × pp = 4: JAX shards the batch over 'data'; each of the port's
    data groups pipelines its own rows, M = 2."""
    block_fn, params, x, _, blocks = setup
    mesh = create_pipe_mesh(8, pp=4)
    xs = jax.device_put(x, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data")))
    want = _jax_forward(block_fn, params, xs, mesh, 2)
    got = _port(blocks, x, 4, 2, groups=2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_single_stage_is_sequential(setup):
    block_fn, params, x, sequential, blocks = setup
    want = pipeline_apply(block_fn, stack_block_params(params, L), x,
                          create_pipe_mesh(8, pp=1))
    got = _port(blocks, x, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(sequential(params, x)), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("nd,pp,m,v", [(8, 2, 2, 2), (2, 2, 4, 2), (2, 2, 8, 2),
                                       (4, 2, 4, 2), (8, 4, 4, 1)])
def test_interleaved_forward_matches_jax(setup, nd, pp, m, v):
    """JAX's interleaved cases: per-group batch B / dp, M ≥ P."""
    block_fn, params, x, _, blocks = setup
    want = _jax_forward(block_fn, params, x, create_pipe_mesh(nd, pp=pp), m, v)
    got = _port(blocks, x, pp, m, v, groups=nd // pp)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_interleaved_gradients_match_jax(setup):
    block_fn, params, x, _, blocks = setup
    mesh = create_pipe_mesh(2, pp=2)

    def loss(params, x):
        stacked = stack_block_params(params, L)
        return jnp.sum(pipeline_apply(block_fn, stacked, x, mesh, num_microbatches=4,
                                      interleave=2) ** 2)

    want = _bridged(jax.jit(jax.grad(loss))(params, x))
    _, got = _port(blocks, x, 2, 4, 2, grad=True)
    _grads_close(got, want, atol=2e-4, rtol=1e-4)


def _jax_message(fn):
    with pytest.raises(ValueError) as error:
        fn()
    return str(error.value)


def test_refusals_match_jax(setup):
    """The batch, chunk and microbatch refusals, each with JAX's message."""
    block_fn, params, x, _, blocks = setup
    stacked = stack_block_params(params, L)
    mesh4, mesh2 = create_pipe_mesh(8, pp=4), create_pipe_mesh(8, pp=2)
    cases = [
        # dp = 2: a per-group batch of 4 rows in 3 microbatches
        (lambda: pipeline_apply(block_fn, stacked, x, mesh4, num_microbatches=3),
         lambda: _port(blocks, x[:4], 4, 3)),
        (lambda: pipeline_apply(block_fn, stacked, x, mesh2, num_microbatches=2,
                                interleave=3),
         lambda: check_schedule(L, 2, 2, 3)),
        (lambda: pipeline_apply(block_fn, stacked, x, mesh2, num_microbatches=1,
                                interleave=2),
         lambda: check_schedule(L, 2, 1, 2)),
    ]
    for jax_fn, port_fn in cases:
        want = _jax_message(jax_fn)
        with pytest.raises(ValueError) as got:
            port_fn()
        assert str(got.value) == want


@pytest.mark.parametrize("blocks,pp,m,v", [(3, 2, 0, 1), (4, 2, 0, 3), (4, 2, 1, 2),
                                           (6, 3, 2, 2)])
def test_model_refusals_match_jax(blocks, pp, m, v):
    """``PipelinedModel``'s refusals (``parallel.pp`` × ``pp_interleave``
    must divide ``num_blocks``; interleaving needs M ≥ pp), JAX's messages."""
    from vit_ssl_tpu.models.vit import ViT as JaxViT

    model = JaxViT(num_classes=3, num_blocks=blocks, input_shape=(3, 16, 16),
                   embed_dim=32, patch_size=8, num_heads=2, mlp_dim=64)
    want = _jax_message(lambda: PipelinedModel(model, create_pipe_mesh(6, pp=pp), m, v))
    with pytest.raises(ValueError) as got:
        refuse_layout(blocks, pp, m, v)
    assert str(got.value) == want


@pytest.mark.parametrize("pp,m,v", [(2, 2, 1), (4, 4, 1), (4, 4, 2), (4, 4, 4),
                                    (4, 0, 1), (3, 8, 2), (1, 1, 1)])
def test_bubble_fraction_is_jax(pp, m, v):
    assert pipeline_bubble_fraction(pp, m, v) == jax_bubble(pp, m, v)


def test_schedule_is_jax_timetable():
    """Chunk (v, p) runs microbatch mb at tick v·M + mb + p; V·M + P − 1
    ticks; rank p holds chunks p, P + p, …"""
    items = schedule(2, 4, 2)
    assert len(items) == 2 * 2 * 4
    assert max(i.tick for i in items) + 1 == 2 * 4 + 2 - 1
    assert all(i.tick == i.v * 4 + i.mb + i.stage for i in items)
    assert stage_layers(8, 2, 2, 1) == [2, 3, 6, 7]


# (world, layout m:v:dropout); each world's layouts run in one spawn
REAL = [(2, "2:1:0.0"), (2, "4:2:0.0"), (2, "2:2:0.1"), (4, "4:1:0.0"), (4, "4:1:0.1")]


@pytest.fixture(scope="module")
def real_ranks(tmp_path_factory):
    """Every layout of REAL over its world of gloo ranks."""
    from torch_dist_worker import spawn

    root = tmp_path_factory.mktemp("pipe")
    for world in sorted({w for w, _ in REAL}):
        spawn("pipeline", world, root / str(world),
              *[layout for w, layout in REAL if w == world], timeout=120)
    return root


@pytest.mark.parametrize("world,layout", REAL)
def test_real_ranks_equal_virtual_stages(real_ranks, world, layout):
    """The per-stage bodies on ``world`` gloo ranks (isend/irecv, the output
    broadcast, the first stage's cotangent broadcast) give the virtual
    stages' output on every rank, and each rank the gradients of the
    parameters it holds, bit for bit; the embedding's and the head's on
    every rank."""
    v = int(layout.split(":")[1])
    ranks = [np.load(real_ranks / str(world) / f"pipeline_{layout}_{r}.npz")
             for r in range(world)]
    virtual = ranks[0]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["out"], virtual["virtual_out"])
        grads = [k for k in res.files if k.startswith("grad/")]
        held = {int(k.split(".")[1]) for k in grads if "encoder_blocks" in k}
        assert held == set(stage_layers(4, world, v, r))
        assert any("patch_embedding" in k for k in grads)
        assert any("classification_head" in k for k in grads)
        for k in grads:
            np.testing.assert_array_equal(res[k], virtual["virtual/" + k[5:]], err_msg=k)


def _dropout_run(pp, m, v, remat=False):
    from torch_dist_worker import pipeline_model, pipeline_step

    model, x = pipeline_model(0.1)
    model.remat = remat
    with virtual_pipeline(model, pp, m, v):
        return pipeline_step(model, x, 0.1)


def test_dropout_masks_independent_of_the_layout():
    """At dropout 0.1 each (layer, microbatch) draws its own masks: pp = 2
    and pp = 4 at M = 4, interleaved or not, and with remat (which replays
    them) give the same output and gradients bit for bit; another M draws
    other masks."""
    want_out, want_grads = _dropout_run(2, 4, 1)
    for pp, v, remat in ((4, 1, False), (2, 2, False), (2, 1, True)):
        out, grads = _dropout_run(pp, 4, v, remat)
        assert torch.equal(out, want_out), (pp, v, remat)
        for k, g in want_grads.items():
            assert torch.equal(grads[k], g), (pp, v, remat, k)
    assert not torch.equal(_dropout_run(2, 2, 1)[0], want_out)


def test_packed_locals_through_the_stages():
    """DINO's packed locals (block size 5 in length-15 sequences) through two
    virtual stages, M = 2, equal the unpipelined network's forward and
    gradients (fp32, the plain versions of B1 on the CPU)."""
    from vit_ssl_tpu_torch.models import DINONetwork

    net = DINONetwork(num_blocks=4, input_shape=(3, 16, 16), embed_dim=32, patch_size=8,
                      num_heads=4, mlp_dim=64, output_dim=16, dropout=0.0)
    net.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(4).random((3 * 4, 8, 8, 3), np.float32))

    def run():
        out = net.forward_packed(x, 3, False, torch.Generator().manual_seed(1))
        return out, torch.autograd.grad(out.square().sum(), list(net.parameters()))

    want_out, want_grads = run()
    with virtual_pipeline(net, 2, 2):
        got_out, got_grads = run()
    torch.testing.assert_close(got_out, want_out, atol=1e-5, rtol=1e-5)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-3)

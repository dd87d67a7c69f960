"""The port's tensor and expert parallelism (``vit_ssl_tpu_torch/parallel/
{sharding_rules,tensor_parallel}.py``) against the JAX package's:

- the rule table: the port's spec of every parameter of ViT, DINO, SimMIM
  and the MoE ViT (found through the weight bridge's names and layouts)
  equals JAX's ``_fitted_spec`` of its leaf on (data, model), (data,
  expert) and (data, model, expert) meshes, the attention apart where tp
  does not divide the heads (replicated by design);
- each sharded layer (attention, packed attention, FFN unfused and fused,
  MoE at tp and at ep, the DINO head, a checkpointed block) at tp or ep = 2
  over two gloo processes, and over two virtual ranks in this process (the
  MoE also at tp = 2 × ep = 2), held to the unsharded layer: output and
  every gradient, fp32, 1e-5;
- the port's tp = 2 DINO step from JAX-bridged weights held to JAX's tp
  step (``tests/test_sharding.py::test_tp_sharded_dino_step_matches_replicated``'s
  setup on ``create_dp_tp_mesh(2, tp=2)``): loss rtol 1e-5, parameters
  atol 2e-4.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from torch_dist_worker import (
    spawn,
    tp_dino_setup,
    tp_layer_cases,
    tp_layer_inputs,
    tp_layer_run,
)
from vit_ssl_tpu.models.dino import DINONetwork as JaxDINONetwork
from vit_ssl_tpu.models.simmim import SimMIMViT as JaxSimMIMViT
from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu.parallel import create_dp_tp_mesh, shard_params
from vit_ssl_tpu.parallel.mesh import shard_batch
from vit_ssl_tpu.parallel.sharding_rules import _fitted_spec
from vit_ssl_tpu.train.state import create_train_state
from vit_ssl_tpu.train.steps import make_dino_steps as jax_make_dino_steps
from vit_ssl_tpu.utils.checkpoint import dino_params_to_torch
from vit_ssl_tpu_torch.parallel.sharding_rules import fitted_spec, tp_spec_for
from vit_ssl_tpu_torch.parallel.tensor_parallel import virtual_shards
from vit_ssl_tpu_torch.utils.checkpoint import (
    dino_state_dict_from_flax,
    simmim_state_dict_from_flax,
    vit_state_dict_from_flax,
)

IMG = (1, 16, 16, 3)
NET = dict(num_blocks=2, input_shape=(3, 16, 16), embed_dim=32, patch_size=8,
           num_heads=4, mlp_dim=64, dropout=0.0)
MESHES = {"tp2": {"data": 1, "model": 2}, "ep2": {"data": 1, "expert": 2},
          "tp2_ep2": {"data": 1, "model": 2, "expert": 2}}


def _dino_bridge(student):
    zeros = jax.tree_util.tree_map(np.zeros_like, student)
    return dino_state_dict_from_flax(student, zeros, np.zeros((1, 32), np.float32))


MODELS = {
    "vit": (lambda: JaxViT(num_classes=4, **NET), vit_state_dict_from_flax, 4),
    "vit_3_classes": (lambda: JaxViT(num_classes=3, **NET), vit_state_dict_from_flax, 4),
    "dino": (lambda: JaxDINONetwork(output_dim=32, **NET), _dino_bridge, 4),
    "simmim": (lambda: JaxSimMIMViT(patch_size=4, **{k: v for k, v in NET.items()
                                                     if k != "patch_size"}),
               simmim_state_dict_from_flax, 4),
    "moe_vit": (lambda: JaxViT(num_classes=4, moe_experts=4, **NET),
                vit_state_dict_from_flax, 4),
}


def _leaf_shapes(model):
    rngs = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda r: model.init(r, jnp.zeros(IMG))["params"], rngs)
    return {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(shapes).items()}


def _bridged_leaves(make, bridge):
    """Each JAX leaf's port name and, per port dimension, the JAX dimension
    it comes from (None for a dimension the bridge added): the bridge run
    once a leaf, that leaf an arange and every other leaf zero."""
    shapes = _leaf_shapes(make())
    zeros = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    out = {}
    for path, shape in shapes.items():
        tagged = dict(zeros)
        tagged[path] = (np.arange(int(np.prod(shape)), dtype=np.float32) + 1).reshape(shape)
        sd = bridge(traverse_util.unflatten_dict(tagged))
        (name, t), = [(k, v) for k, v in sd.items()
                      if not k.startswith("teacher_") and bool(v.abs().sum())]
        strides = np.cumprod((shape + (1,))[::-1])[::-1][1:]
        base = float(t.reshape(-1)[0])
        dims = []
        for k, size in enumerate(t.shape):
            if size == 1:
                dims.append(None)
                continue
            step = float(t.narrow(k, 1, 1).reshape(-1)[0]) - base
            dims.append([j for j, s in enumerate(strides) if s == step and shape[j] > 1][0])
        out[path] = (name, tuple(t.shape), dims, shape)
    return out


def _jax_spec_in_port_layout(path, jax_shape, dims, sizes):
    """JAX's fitted spec of a leaf, carried to the port's dimensions."""
    spec = tuple(_fitted_spec(tuple(path), np.zeros(jax_shape, np.float32),
                              types.SimpleNamespace(shape=sizes), warn=False))
    spec += (None,) * (len(jax_shape) - len(spec))
    return tuple(None if j is None else spec[j] for j in dims)


@pytest.fixture(scope="module")
def bridged():
    return {m: _bridged_leaves(make, bridge) for m, (make, bridge, _) in MODELS.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", list(MODELS))
def test_rule_table_matches_jax(bridged, model, mesh):
    """Every leaf: JAX's fitted spec, carried to the port's layout, is the
    port's fitted spec of the bridged name and shape (on the expert-only
    mesh only the MoE ViT has leaves to shard)."""
    sizes = MESHES[mesh]
    heads = MODELS[model][2]
    sharded = 0
    for path, (name, shape, dims, jax_shape) in bridged[model].items():
        want = _jax_spec_in_port_layout(path, jax_shape, dims, sizes)
        got = fitted_spec(name, shape, sizes, heads)
        assert got == want, (model, path, name, got, want)
        sharded += any(got)
    assert (sharded > 0) == ("model" in sizes or model == "moe_vit")


def test_attention_stays_replicated_where_tp_does_not_divide_the_heads(caplog):
    """tp = 4 with 6 heads (ViT-S's): JAX's rule shards the (48, 48)
    projections, the port keeps them whole (the deliberate divergence,
    JAX's own head condition) and warns once; every other leaf agrees."""
    net = dict(NET, embed_dim=48, num_heads=6)
    leaves = _bridged_leaves(lambda: JaxViT(num_classes=4, **net), vit_state_dict_from_flax)
    sizes = {"data": 1, "model": 4}
    differ = []
    with caplog.at_level("WARNING"):
        for path, (name, shape, dims, jax_shape) in leaves.items():
            want = _jax_spec_in_port_layout(path, jax_shape, dims, sizes)
            got = fitted_spec(name, shape, sizes, 6)
            if got != want:
                differ.append(name)
                assert not any(got)
    assert sorted(differ) == sorted(
        f"encoder_blocks.{i}.self_attention.{w}.weight" for i in range(2)
        for w in ("w_query", "w_key", "w_value", "final_linear"))
    assert sum("does not divide the 6 attention heads" in r.message
               for r in caplog.records) == 1


def test_spec_rules_by_name():
    """JAX's ``test_tp_spec_rules`` in the port's names and layout."""
    assert tp_spec_for("encoder_blocks.0.feed_forward.linear_in.weight") == ("model", None)
    assert tp_spec_for("encoder_blocks.0.feed_forward.linear_out.weight") == (None, "model")
    assert tp_spec_for("encoder_blocks.0.self_attention.w_query.weight") == ("model", None)
    assert tp_spec_for("encoder_blocks.0.self_attention.final_linear.weight") == (None,
                                                                                  "model")
    assert tp_spec_for("head.fully_connected.parametrizations.weight.original1") == (
        "model", None)
    assert tp_spec_for("patch_embedding.cls_token") == ()
    assert tp_spec_for("encoder_blocks.1.moe.w1") == ("expert", None, "model")


def test_a_dimension_the_axis_does_not_divide_stays_whole(caplog):
    with caplog.at_level("WARNING"):
        spec = fitted_spec("classification_head.linear.weight", (3, 32), {"model": 2})
    assert spec == (None, None)
    assert "does not divide mesh axis size 2" in caplog.text


# ---------------------------------------------------------------------------
# each sharded layer against the unsharded one


@pytest.fixture(scope="module")
def layer_runs(tmp_path_factory):
    out = spawn("tp_layers", 2, tmp_path_factory.mktemp("tp_layers"), timeout=180)
    return [dict(np.load(out / f"tp_layers_{r}.npz")) for r in range(2)]


def _assert_layer(res, name):
    keys = sorted(k[:-len(":want")] for k in res if k.startswith(f"{name}:")
                  and k.endswith(":want"))
    assert len(keys) > 2
    for key in keys:
        np.testing.assert_allclose(res[f"{key}:got"], res[f"{key}:want"], atol=1e-5,
                                   rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", [n for n, (sizes, _, _) in tp_layer_cases().items()
                                  if len(sizes) == 2])
def test_sharded_layer_matches_unsharded_over_two_ranks(layer_runs, name):
    """Two gloo ranks: the output and every gradient (the input's and each
    parameter's, gathered whole) of the unsharded layer, on both ranks."""
    for res in layer_runs:
        _assert_layer(res, name)


@pytest.mark.parametrize("name", list(tp_layer_cases()))
def test_virtual_ranks_match_unsharded(name):
    """The same per-rank bodies over two virtual ranks in this process (the
    form the card checks)."""
    sizes, factory, call = tp_layer_cases()[name]
    x = tp_layer_inputs()
    with torch.no_grad():
        shape = call(factory(), x).shape
    cot = torch.randn(shape, generator=torch.Generator().manual_seed(6))
    want_out, want = tp_layer_run(factory, call, x, cot)
    module = factory()
    xv = x.clone().requires_grad_()
    with virtual_shards(module, {a: s for a, s in sizes.items() if a != "data"}) as plan:
        assert plan
        got_out = call(module, xv)
        got = torch.autograd.grad((got_out * cot).sum(), [xv] + list(module.parameters()))
    names = ["x"] + [n for n, _ in module.named_parameters()]
    torch.testing.assert_close(got_out, want_out, atol=1e-5, rtol=1e-5)
    for n, g in zip(names, got):
        torch.testing.assert_close(g, want[n], atol=1e-5, rtol=1e-5, msg=n)


# ---------------------------------------------------------------------------
# the DINO step against JAX's tp step


def test_tp_dino_step_matches_jax(tmp_path):
    model = JaxDINONetwork(num_blocks=1, input_shape=(3, 16, 16), embed_dim=32,
                           patch_size=8, num_heads=4, mlp_dim=64, dropout=0.0,
                           output_dim=32, use_flash=False, use_fused_mlp=False)
    rng = jax.random.PRNGKey(0)
    student = model.init(rng, jnp.zeros((1, 16, 16, 3)))["params"]
    teacher = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), student)
    tx = optax.adamw(1e-3)
    rs = np.random.RandomState(0)
    raw_batch = {
        "views": tuple(rs.randn(8, 16 if v < 2 else 8, 16 if v < 2 else 8, 3)
                       .astype(np.float32) for v in range(3)),
        "weight": np.ones((8,), np.float32),
    }
    sd = dino_state_dict_from_flax(jax.device_get(student), jax.device_get(teacher),
                                   np.zeros((1, 32), np.float32))
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, weight=raw_batch["weight"],
             **{f"view{i}": v for i, v in enumerate(raw_batch["views"])},
             **{f"sd:{k}": v.numpy() for k, v in sd.items()})
    with ThreadPoolExecutor(1) as pool:  # the ranks step while JAX compiles its step
        ranks = pool.submit(spawn, "tp_dino_step", 2, tmp_path / "run", inputs,
                            timeout=180)
        train_step, _ = jax_make_dino_steps(model, tx, num_global_views=2,
                                            num_all_views=3, student_temp=0.1,
                                            center_momentum=0.9, donate=False)
        mesh = create_dp_tp_mesh(2, tp=2)
        assert dict(mesh.shape) == {"data": 1, "model": 2}
        state = create_train_state(shard_params(student, mesh), tx, rng,
                                   teacher_params=shard_params(teacher, mesh),
                                   center=jnp.zeros((1, 32)))
        after, out = train_step(state, shard_batch(raw_batch, mesh), jnp.float32(0.04),
                                jnp.float32(0.996))
        want = {k: np.asarray(v, np.float32) for k, v in dino_params_to_torch(
            after.params, after.teacher_params, after.center).items()}
        ranks.result()
    got = torch.load(tmp_path / "run" / "tp_dino_step.pt", weights_only=True)
    np.testing.assert_allclose(got["loss"], float(out["loss"]), rtol=1e-5)
    tree = got["state"]
    ported = {**{f"student_{k}": v for k, v in tree["student"].items()},
              **{f"teacher_{k}": v for k, v in tree["teacher"].items()},
              "center": tree["center"]}
    assert set(ported) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(ported[key].numpy().reshape(value.shape), value,
                                   atol=2e-4, err_msg=key)
    # and the port's own one-process step from the same weights, to the same bar
    _, state1, step1 = tp_dino_setup()
    state1.load_model_state_dict(sd)
    step1(state1, {"views": [torch.from_numpy(v) for v in raw_batch["views"]],
                   "weight": torch.from_numpy(raw_batch["weight"])}, 0.04, 0.996)
    for key, value in state1.model_state_dict().items():
        np.testing.assert_allclose(ported[key].numpy(), value.detach().numpy(),
                                   atol=2e-4, err_msg=key)


def test_scan_layers_with_tp_refused_as_jax():
    """The config check refuses ``model.scan_layers`` with tp > 1 as JAX's
    does, and the sharding itself refuses a scanned stack."""
    from vit_ssl_tpu.config import compose as jax_compose
    from vit_ssl_tpu.config import validate_train_config as jax_validate
    from vit_ssl_tpu.config.schemas import ConfigValidationError as JaxError
    from vit_ssl_tpu_torch.config import (ConfigValidationError, compose,
                                          validate_train_config)
    from vit_ssl_tpu_torch.models import ViT
    from vit_ssl_tpu_torch.parallel.tensor_parallel import plan

    overrides = ["model.num_classes=3", "data.data_dir=/tmp", "data.data_csv=/tmp/x",
                 "model.scan_layers=true", "parallel.tp=2"]
    with pytest.raises(JaxError, match="scan_layers"):
        jax_validate(jax_compose("configs", "supervised", overrides))
    with pytest.raises(ConfigValidationError, match="scan_layers"):
        validate_train_config(compose("configs", "supervised", overrides))
    scanned = ViT(3, 2, (3, 16, 16), 32, 8, 4, 64, scan_layers=True)
    with pytest.raises(ValueError, match="scan_layers"):
        plan(scanned, {"model": 2})

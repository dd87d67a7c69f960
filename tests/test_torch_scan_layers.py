"""The port's scanned encoder stack (``model.scan_layers``,
``vit_ssl_tpu_torch.ops.encoder_stack``) against the JAX package's, on the
CPU.

- The layout converters give JAX's results on the same keys (JAX's
  ``encoder_blocks_{i}`` mapped to the port's ``encoder_blocks.{i}``),
  DINO teacher prefixes included; both refuse non-contiguous indices and
  anchor the block pattern to a key-component boundary.
- A JAX scanned ViT, DINO network and SimMIM, their parameters seeded with
  numpy and carried by the port's bridge (which takes the ``encoder_scan``
  subtree), against the port's scanned modules: outputs at atol/rtol 1e-5
  and every parameter's gradient at rtol 1e-5 and atol 1e-5·max(1,
  max|gradient|) (fp32 sums over the batch cancel).
- The port's scanned and unrolled models, from the same init generator,
  hold the same weights and train bit-equal with dropout on and remat, in
  the supervised, DINO and SimMIM steps.
- ``load_weights`` converts both ways; ``return_attn`` is refused; the
  config combinations JAX refuses are refused.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.models.dino import DINONetwork as JaxDINONetwork
from vit_ssl_tpu.models.simmim import SimMIMViT as JaxSimMIMViT
from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu.ops import encoder_stack as jes
from vit_ssl_tpu_torch.config import compose, validate_train_config
from vit_ssl_tpu_torch.config.schemas import ConfigValidationError
from vit_ssl_tpu_torch.models import DINONetwork, SimMIMViT, ViT, build_vit
from vit_ssl_tpu_torch.models.builder import (check_loaded_model, freeze_backbone_mask,
                                              load_state_any_layout, load_weights)
from vit_ssl_tpu_torch.ops import encoder_stack as es
from vit_ssl_tpu_torch.train import (AdamW, SupervisedTrainState, TrainState,
                                     make_dino_steps, make_simmim_steps,
                                     make_supervised_steps)
from vit_ssl_tpu_torch.utils.checkpoint import (dino_backbone_state_dict_from_flax,
                                                simmim_state_dict_from_flax,
                                                vit_state_dict_from_flax)

TOL = dict(atol=1e-5, rtol=1e-5)
NET = dict(num_blocks=3, input_shape=(3, 16, 16), embed_dim=32, patch_size=4,
           num_heads=2, mlp_dim=64, dropout=0.0)


@pytest.fixture(autouse=True)
def two_threads():
    """Two CPU threads for the port (the suite runs beside other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _to_jax_key(key):
    return re.sub(r"encoder_blocks\.(\d+)\.", r"encoder_blocks_\1.", key)


def _flat(seed, prefixes=("",), blocks=3):
    rng = np.random.default_rng(seed)
    flat = {}
    for pre in prefixes:
        flat[f"{pre}patch_embedding.cls_token"] = rng.random((1, 1, 4), np.float32)
        for i in range(blocks):
            for rest in ("layer_norm1.weight", "self_attention.w_query.weight"):
                flat[f"{pre}encoder_blocks.{i}.{rest}"] = rng.random((4, 4), np.float32)
    return flat


@pytest.mark.parametrize("prefixes", [("",), ("backbone.", "teacher.backbone.")],
                         ids=["plain", "dino_teacher"])
def test_converters_match_jax(prefixes):
    flat = _flat(0, prefixes)
    jflat = {_to_jax_key(k): v for k, v in flat.items()}
    scanned, jscanned = es.flat_to_scanned(flat), jes.flat_to_scanned(jflat)
    assert set(scanned) == set(jscanned)
    for k, v in jscanned.items():
        np.testing.assert_array_equal(scanned[k], v, err_msg=k)
    assert es.flat_has_scanned(scanned) and not es.flat_has_unrolled(scanned)
    back, jback = es.flat_to_unrolled(scanned), jes.flat_to_unrolled(jscanned)
    assert {_to_jax_key(k) for k in back} == set(jback) and set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    torch_flat = {k: torch.from_numpy(v) for k, v in flat.items()}
    for k, v in es.flat_to_unrolled(es.flat_to_scanned(torch_flat)).items():
        assert torch.equal(v, torch_flat[k]) and v._base is None, k  # copies, not views


def test_converters_refuse_gaps_and_anchor_the_pattern():
    flat = _flat(1)
    del flat["encoder_blocks.1.layer_norm1.weight"]
    jflat = {_to_jax_key(k): v for k, v in flat.items()}
    for module, f in ((es, flat), (jes, jflat)):
        with pytest.raises(ValueError, match="non-contiguous"):
            module.flat_to_scanned(f)
    assert not es.flat_has_unrolled({"my_encoder_blocks.0.x": 1})
    assert not jes.flat_has_unrolled({"my_encoder_blocks_0.x": 1})
    assert es.flat_has_unrolled({"a.encoder_blocks.0.x": 1})
    assert es.flat_to_scanned({"my_encoder_blocks.0.x": 1}) == {"my_encoder_blocks.0.x": 1}


def _random_params(module, x, seed, *args):
    shapes = jax.eval_shape(lambda key, xin: module.init(key, xin, *args),
                            jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.05 * noise if path[-1].key == "scale" else 0.2 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(seed=2, b=2):
    return np.random.default_rng(seed).random((b, 16, 16, 3), np.float32)


def _check_grads(model, want_grads_sd):
    for name, p in model.named_parameters():
        want = want_grads_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                   err_msg=name)


def test_scanned_vit_matches_jax():
    module = JaxViT(num_classes=5, scan_layers=True, **NET)
    x = _images()
    params = _random_params(module, x, 3)
    assert params["encoder_scan"]["block"]["layer_norm1"]["scale"].shape == (3, 32)
    g = np.random.default_rng(4).standard_normal((2, 5)).astype(np.float32)

    def loss(p):
        out = module.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * g), out

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    unrolled, want_unrolled = es.unroll_scanned_tree(params), jes.unroll_scanned_tree(params)
    assert set(unrolled) == set(want_unrolled) and "encoder_blocks_2" in unrolled
    for a, b in zip(jax.tree_util.tree_leaves(unrolled), jax.tree_util.tree_leaves(want_unrolled)):
        np.testing.assert_array_equal(a, np.asarray(b))
    vit = ViT(num_classes=5, scan_layers=True, **NET)
    sd = vit_state_dict_from_flax(params)
    assert sd["encoder_scan.block.self_attention.w_query.weight"].shape == (3, 32, 32)
    vit.load_state_dict(sd, strict=True)
    out = vit(torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    _check_grads(vit, vit_state_dict_from_flax(want_g))
    with pytest.raises(ValueError, match="return_attn"):
        vit(torch.from_numpy(x), return_attn=True)
    with pytest.raises(ValueError, match="return_attn"):
        module.apply({"params": params}, jnp.asarray(x), return_attn=True)


def test_scanned_dino_matches_jax():
    module = JaxDINONetwork(output_dim=16, scan_layers=True, **NET)
    x = _images(5)
    params = _random_params(module, x, 6)
    g = np.random.default_rng(7).standard_normal((2, 32)).astype(np.float32)

    def loss(p):
        out = module.apply({"params": p}, jnp.asarray(x), method=module.features)
        return jnp.sum(out * g), out

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    net = DINONetwork(output_dim=16, scan_layers=True, **NET)
    net.backbone.load_state_dict(dino_backbone_state_dict_from_flax(params["backbone"]),
                                 strict=True)
    out = net.backbone(torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    _check_grads(net.backbone, dino_backbone_state_dict_from_flax(want_g["backbone"]))


def test_scanned_simmim_matches_jax():
    module = JaxSimMIMViT(mask_ratio=0.5, scan_layers=True, **NET)
    x = _images(8)
    mask = np.random.default_rng(9).random((2, 16)) < 0.5
    params = _random_params(module, x, 10, True, jnp.asarray(mask))
    g = np.random.default_rng(11).standard_normal((2, 16, 48)).astype(np.float32)

    def loss(p):
        preds, _, _ = module.apply({"params": p}, jnp.asarray(x), True, jnp.asarray(mask))
        return jnp.sum(preds * g), preds

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = SimMIMViT(mask_ratio=0.5, scan_layers=True, **NET)
    model.load_state_dict(simmim_state_dict_from_flax(params), strict=True)
    preds, _, _ = model(torch.from_numpy(x), True, mask=torch.from_numpy(mask))
    (preds * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(want), **TOL)
    _check_grads(model, simmim_state_dict_from_flax(want_g))


def _pair(cls, **kw):
    """An unrolled and a scanned model from one init generator, with remat."""
    models = []
    for scan in (False, True):
        m = cls(scan_layers=scan, remat=True, **{**NET, "dropout": 0.1}, **kw)
        m.reset_parameters(torch.Generator().manual_seed(11))
        models.append(m)
    unrolled, scanned = models
    want = es.flat_to_scanned(unrolled.state_dict())
    got = scanned.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    return unrolled, scanned


def _states_bit_equal(unrolled_sd, scanned_sd):
    want = es.flat_to_scanned(unrolled_sd)
    assert set(want) == set(scanned_sd)
    for k, v in scanned_sd.items():
        assert torch.equal(v, want[k]), k


def _labeled(seed=12):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)),
            "label": torch.arange(4), "weight": torch.ones(4)}


@pytest.mark.parametrize("mode", ["supervised", "dino", "simmim"])
def test_scanned_and_unrolled_train_bit_equal(mode):
    """Three steps with dropout 0.1 and remat from the same init: every
    parameter, AdamW moment (and DINO's teacher and center) bit-equal, the
    stacked state converted."""
    outs = []
    if mode == "supervised":
        models = _pair(ViT, num_classes=5)
        batch = _labeled()
    elif mode == "simmim":
        models = _pair(SimMIMViT, mask_ratio=0.5)
        batch = {k: v for k, v in _labeled().items() if k != "label"}
    else:
        models = _pair(DINONetwork, output_dim=16)
        rng = np.random.default_rng(13)
        batch = {"views": [torch.from_numpy(rng.random((4, 16, 16, 3), np.float32))
                           for _ in range(2)]
                 + [torch.from_numpy(rng.random((4, 8, 8, 3), np.float32))
                    for _ in range(2)],
                 "weight": torch.ones(4)}
    for model in models:
        optimizer = AdamW(lambda step: 1e-3, weight_decay=1e-2)
        if mode == "dino":
            state = TrainState(model, optimizer, seed=3)
            step, _ = make_dino_steps(optimizer, 2, 4, 0.1, 0.9, pack_locals=True)
            run = [step(state, batch, 0.04, 0.99) for _ in range(3)]
            sd = {**{f"s.{k}": v for k, v in state.student.state_dict().items()},
                  **{f"t.{k}": v for k, v in state.teacher.state_dict().items()}}
            extra = state.center
        else:
            state = SupervisedTrainState(model, optimizer, seed=3)
            if mode == "simmim":
                step, _ = make_simmim_steps(optimizer, 4, 3)
            else:
                step, _ = make_supervised_steps(optimizer)
            run = [step(state, batch) for _ in range(3)]
            sd, extra = state.model.state_dict(), None
        names = [n for n, _ in model.named_parameters()]
        moments = {f"{b}.{n}": t for b in ("mu", "nu")
                   for n, t in zip(names, state.opt_state.buffers[b])}
        outs.append((sd, moments, extra, [float(o["loss"]) for o in run]))
    (sd_u, mom_u, extra_u, loss_u), (sd_s, mom_s, extra_s, loss_s) = outs
    assert loss_u == loss_s
    _states_bit_equal(sd_u, sd_s)
    _states_bit_equal(mom_u, mom_s)
    if mode == "dino":
        assert torch.equal(extra_u, extra_s)


def test_load_weights_both_ways_and_freezing():
    """An unrolled checkpoint into a scanned ViT and back, the DINO teacher
    backbone through extended too; check_loaded_model counts every
    tensor; the backbone mask freezes the stack."""
    unrolled = ViT(num_classes=5, **NET)
    unrolled.reset_parameters(torch.Generator().manual_seed(14))
    scanned = ViT(num_classes=5, scan_layers=True, **NET)
    sd = load_weights(scanned.state_dict(), unrolled.state_dict())
    scanned.load_state_dict(sd, strict=True)
    _states_bit_equal(unrolled.state_dict(), scanned.state_dict())
    counts = check_loaded_model(scanned.state_dict(), unrolled.state_dict())
    assert counts == {"matched": len(scanned.state_dict()), "mismatched": 0}
    back = ViT(num_classes=5, **NET)
    back.load_state_dict(load_weights(back.state_dict(), scanned.state_dict()), strict=True)
    for k, v in unrolled.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    load_state_any_layout(back, scanned.state_dict())
    load_state_any_layout(scanned, unrolled.state_dict())

    dino = DINONetwork(output_dim=16, **NET)
    dino.reset_parameters(torch.Generator().manual_seed(15))
    pretrained = {f"teacher.{k}": v for k, v in dino.state_dict().items()}
    fresh = ViT(num_classes=5, scan_layers=True, **NET)
    moved = load_weights(fresh.state_dict(), pretrained, extended=True)
    want = es.flat_to_scanned({k[len("backbone."):]: v for k, v in dino.state_dict().items()
                               if k.startswith("backbone.encoder_blocks.")})
    for k, v in want.items():
        assert torch.equal(moved[k], v), k
    mask = freeze_backbone_mask(scanned)
    assert not any(v for k, v in mask.items() if k.startswith("encoder_scan."))
    assert mask["patch_embedding.cls_token"] and mask["classification_head.linear.weight"]


@pytest.mark.parametrize("override", [{"model.moe_experts": "4"}, {"parallel.pp": "2"},
                                      {"parallel.tp": "2"}],
                         ids=["moe_experts", "pp", "tp"])
def test_schema_rejects_scan_layers_combos(override):
    """As JAX's test of the same name: scan_layers with MoE, pp or tp."""
    cfg = compose("configs", "supervised", ["model.scan_layers=true"]
                  + [f"{k}={v}" for k, v in override.items()])
    with pytest.raises(ConfigValidationError, match="scan_layers"):
        validate_train_config(cfg)
    assert build_vit(compose("configs", "supervised", ["model.scan_layers=true"]),
                     "cpu").encoder_scan is not None

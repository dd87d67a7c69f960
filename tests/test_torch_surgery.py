"""Finetune's weight surgery in the port (``models/builder.py``:
``load_pretrained``, ``load_weights``, ``freeze_backbone_mask``,
``check_loaded_model``) against the JAX package's, on the CPU.

One ViT target (2 blocks, embed 32, image 32, patch 8) and checkpoints
written as reference ``.pth`` files from JAX parameter trees: a DINO
network at the same grid and at a 16-px image (a 2 × 2 grid against the
target's 4 × 4), a SimMIM ViT, and a ViT at 16 px (its positional
embedding shorter than the target's). Each package reads the same file
(JAX: ``_load_pretrained_tree`` and the trainer's ``_merged_pre``) and
transfers it into the same target, with and without ``extended``; JAX's
result through ``vit_params_to_torch`` equals the port's state dict tensor
for tensor (copies bit for bit; the resized positional embedding at rtol
1e-5, atol 1e-6: the same Keys cubic in another order of sums). The freeze
masks are equal, and ``check_loaded_model``'s counts are JAX's wherever
JAX looks the tensors up (see ``test_check_loaded_model``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.models.builder import _load_pretrained_tree
from vit_ssl_tpu.models.builder import check_loaded_model as jax_check_loaded_model
from vit_ssl_tpu.models.builder import freeze_backbone_mask as jax_freeze_backbone_mask
from vit_ssl_tpu.models.builder import load_weights as jax_load_weights
from vit_ssl_tpu.models.dino import DINONetwork as JaxDINONetwork
from vit_ssl_tpu.models.simmim import SimMIMViT as JaxSimMIMViT
from vit_ssl_tpu.models.vit import ViT as JaxViT
from vit_ssl_tpu.train.trainers.supervised import _merged_pre
from vit_ssl_tpu.utils.checkpoint import (dino_params_to_torch, save_torch_checkpoint,
                                          simmim_params_to_torch, vit_params_to_torch)
from vit_ssl_tpu_torch.models import DINONetwork, ViT
from vit_ssl_tpu_torch.models.builder import (all_trainable_mask, check_loaded_model,
                                              freeze_backbone_mask, load_pretrained,
                                              load_weights)
from vit_ssl_tpu_torch.train.state import AdamW, TrainState
from vit_ssl_tpu_torch.utils.checkpoint import save_checkpoint, vit_state_dict_from_flax

WIDTH = dict(num_blocks=2, embed_dim=32, patch_size=8, num_heads=2, mlp_dim=64,
             dropout=0.0)


def _jiggle(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(np.shape(p)).astype(np.float32), params)


def _init(module, img, seed):
    return _jiggle(module.init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)))
                   ["params"], seed)


def _target():
    return _init(JaxViT(num_classes=4, input_shape=(3, 32, 32), **WIDTH), 32, 0)


def _dino_sd(img, seed):
    net = JaxDINONetwork(input_shape=(3, img, img), output_dim=16, **WIDTH)
    student, teacher = _init(net, img, seed), _init(net, img, seed + 1)
    return dino_params_to_torch(student, teacher, np.full((1, 16), 0.5, np.float32))


SOURCES = {
    "dino32": lambda: _dino_sd(32, 10),
    "dino16": lambda: _dino_sd(16, 20),
    "simmim32": lambda: simmim_params_to_torch(_init(JaxSimMIMViT(
        input_shape=(3, 32, 32), **WIDTH), 32, 30)),
    "vit16": lambda: vit_params_to_torch(_init(JaxViT(
        num_classes=4, input_shape=(3, 16, 16), **WIDTH), 16, 40)),
}


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    root = tmp_path_factory.mktemp("pth")
    paths = {}
    for name, make in SOURCES.items():
        paths[name] = str(root / f"{name}.pth")
        save_torch_checkpoint(paths[name], make(), {"epoch": 1})
    return paths


def _both(path, extended):
    target = _target()
    pre = _merged_pre(_load_pretrained_tree(path))
    want = vit_params_to_torch(jax_load_weights(target, pre, extended))
    port_target = vit_state_dict_from_flax(target)
    got = load_weights(port_target, load_pretrained(path), extended)
    return target, pre, port_target, got, want


CASES = [("dino32", False), ("dino32", True), ("dino16", True), ("simmim32", False),
         ("simmim32", True), ("vit16", False)]


@pytest.mark.parametrize("source,extended", CASES,
                         ids=[f"{s}-{'extended' if e else 'reference'}" for s, e in CASES])
def test_load_weights_matches_jax(pth, source, extended):
    _, _, port_target, got, want = _both(pth[source], extended)
    assert set(got) == set(want) == set(port_target)
    moved = 0
    for key, value in want.items():
        value = np.asarray(value, np.float32).reshape(got[key].shape)
        if source == "dino16" and key.endswith("positional_embedding"):
            np.testing.assert_allclose(got[key].float().numpy(), value, rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key].float().numpy(), value, err_msg=key)
        moved += not torch.equal(got[key], port_target[key])
    # what each case transfers: nothing from DINO by the reference rules;
    # the teacher backbone's 24 block tensors, the patch projection (2), the
    # CLS token and the positional embedding (resized at 16 px) with
    # extended; SimMIM's 24 block tensors and its padded positional
    # embedding, and with extended its projection as the conv kernel (2);
    # a 16-px ViT all but its shorter positional embedding
    expected = {("dino32", False): 0, ("dino32", True): 28, ("dino16", True): 28,
                ("simmim32", False): 25, ("simmim32", True): 27,
                ("vit16", False): len(port_target) - 1}
    assert moved == expected[(source, extended)]
    ViT(num_classes=4, input_shape=(3, 32, 32), **WIDTH).load_state_dict(got, strict=True)


@pytest.mark.parametrize("source,extended", CASES,
                         ids=[f"{s}-{'extended' if e else 'reference'}" for s, e in CASES])
def test_check_loaded_model(pth, source, extended):
    """The port counts what JAX counts by name; after an extended transfer
    from DINO it also finds each tensor where it came from (JAX's lookup by
    name finds none of them there: its count is the reference rules')."""
    target, pre, _, got, want = _both(pth[source], extended)
    jax_params = jax_load_weights(target, pre, extended)
    theirs = jax_check_loaded_model(jax_params, pre)
    ours = check_loaded_model(got, load_pretrained(pth[source]))
    assert ours == theirs
    if source.startswith("dino") and extended:
        mine = check_loaded_model(got, load_pretrained(pth[source]), extended=True)
        grids_equal = source == "dino32"
        assert mine == {"matched": 27 + grids_equal, "mismatched": 0}
        assert theirs["matched"] == 0


def test_freeze_masks_match_jax():
    target = _target()
    mask = jax_freeze_backbone_mask(target)
    # the mask as arrays of each parameter's shape, through the bridge
    full = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m)), mask, target)
    want = {k: bool(np.asarray(v).all()) for k, v in vit_params_to_torch(full).items()}
    assert all(np.asarray(v).all() or not np.asarray(v).any()
               for v in vit_params_to_torch(full).values())
    model = ViT(num_classes=4, input_shape=(3, 32, 32), **WIDTH)
    assert freeze_backbone_mask(model) == want
    assert sum(want.values()) == 5  # the CLS token and the head's four tensors
    assert all(all_trainable_mask(model).values())


def test_load_pretrained_reads_the_ports_own_checkpoints(tmp_path, pth):
    """A DINO train state written by the port's trainer reads as the same
    flat dict as the ``.pth`` of its weights."""
    net = DINONetwork(input_shape=(3, 32, 32), output_dim=16, **WIDTH)
    state = TrainState(net, AdamW(lambda step: 1e-3), seed=0)
    state.load_model_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                                 for k, v in SOURCES["dino32"]().items()})
    save_checkpoint(str(tmp_path / "best_model"), state.state_dict(), {"epoch": 1})
    mine = load_pretrained(str(tmp_path / "best_model"))
    want = load_pretrained(pth["dino32"])
    assert set(mine) == set(want)
    for key in want:
        assert torch.equal(mine[key].reshape(want[key].shape), want[key]), key
    with pytest.raises(FileNotFoundError):
        load_pretrained(str(tmp_path / "missing"))

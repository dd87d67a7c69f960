"""Evaluator utilities (after ``vit_ssl_tpu/evaluators/evaluator_utils.py``):
batched feature extraction and the experiment-config merge.

:func:`extract_features` runs a model's clean inference path over a loader
and gathers the features to the host; what it reads depends on the model:

- ``SimMIMViT``: ``inference_forward``, the mean of the patch features;
- ``DINONetwork`` (the caller passes DINO's **teacher**): ``features``,
  the backbone's CLS token;
- ``ViT`` (supervised, finetune): the output logits, as the JAX package
  reads them.

:func:`merge_with_experiment_config` re-reads a finished run's
``.hydra/config.yaml`` and ``overrides.yaml`` (what
``python -m vit_ssl_tpu_torch.train`` writes) and merges the current
evaluation config over them.
"""

from __future__ import annotations

import logging
import os
from typing import Tuple

import numpy as np
import torch

from ..config import Config, apply_overrides, from_container, load_yaml, merge
from ..device import resolve_device

logger = logging.getLogger(__name__)


def feature_fn(network: torch.nn.Module):
    """The inference function of ``network``'s family: images → features."""
    from ..models.dino import DINONetwork
    from ..models.simmim import SimMIMViT

    if isinstance(network, SimMIMViT):
        return network.inference_forward
    if isinstance(network, DINONetwork):
        return network.features
    return network  # a ViT: the logits


def extract_features(network: torch.nn.Module, loader, device=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(features float32 (n, d), labels (n,)) over ``loader``'s real rows
    (a padded row has weight 0); labels are zeros when the batches carry
    none. Runs under ``torch.inference_mode`` with every module in eval
    mode, and gives each module its train flag back."""
    device = resolve_device(device)
    fn = feature_fn(network)
    flags = [(module, module.training) for module in network.modules()]
    feats, keeps, labels = [], [], []
    try:
        network.eval()
        with torch.inference_mode():
            for batch in loader:
                x = torch.as_tensor(batch["image"]).to(device)
                feats.append(fn(x).float())
                keeps.append(np.asarray(batch["weight"]) > 0)
                if "label" in batch:
                    labels.append(np.asarray(batch["label"]))
            # one device-to-host fetch for the whole loader
            features = torch.cat(feats).cpu().numpy()
    finally:
        for module, flag in flags:
            module.training = flag
    keep = np.concatenate(keeps)
    features = features[keep]
    label_arr = np.concatenate(labels)[keep] if labels else np.zeros(len(features))
    return features, label_arr


def _load_experiment_config(path: str) -> Config:
    hydra_dir = os.path.join(path, ".hydra")
    config_path = os.path.join(hydra_dir, "config.yaml")
    overrides_path = os.path.join(hydra_dir, "overrides.yaml")
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"Missing: {config_path}")
    base = from_container(load_yaml(config_path))
    if os.path.exists(overrides_path):
        overrides = load_yaml(overrides_path) or []
        apply_overrides(base, [str(o) for o in overrides])
    return base


def merge_with_experiment_config(config) -> Config:
    """The experiment's saved training config with ``config`` merged over
    it."""
    exp_path = config["eval"]["experiment_path"]
    exp_cfg = _load_experiment_config(exp_path)
    merged = from_container({})
    merge(merged, exp_cfg)
    merge(merged, config)
    logger.info("Merged experiment config from %s", exp_path)
    return merged

"""Unsupervised evaluation (after
``vit_ssl_tpu/evaluators/unsupervised_evaluator.py``): KNN, linear probe
and UMAP quality over features extracted once.

Every mode of ``eval.mode`` is an entry of a registry (mode name → runner)
returning an :class:`EvalOutcome`; ``evaluation_summary.{csv,txt}`` are
rendered from the outcomes, byte for byte as the JAX package writes them.
:func:`run_evaluation` runs in training (the trainer passes the network to
read and its own device) or standalone (``python -m
vit_ssl_tpu_torch.evaluate``), where the experiment's saved config is
merged back in and :func:`load_model_state` loads its ``best_model``.
Its ``loaders`` argument (a train and a val loader) replaces the loaders
``eval.*`` describes, e.g. over images held in memory.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..config import is_list
from ..device import resolve_device
from .embedding_analysis import prepare_combined_features, run_umap_analysis, write_csv
from .evaluator_utils import extract_features, merge_with_experiment_config
from .knn import run_knn_evaluation
from .linear_probe import run_linear_evaluation

logger = logging.getLogger(__name__)


@dataclass
class FeatureBank:
    """Features extracted once, shared by every evaluation mode."""

    train_features: Any
    train_labels: Any
    val_features: Any
    val_labels: Any


@dataclass
class EvalOutcome:
    """The result record every mode runner returns."""

    mode: str
    method: str
    headline: str  # one-line result, e.g. "Accuracy: 93.10%"
    scalars: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)
    payload: Dict[str, Any] = field(default_factory=dict)  # arrays etc.


def load_model_state(config, device=None) -> torch.nn.Module:
    """The network whose features the evaluation reads, with the
    experiment's trained weights: the ``SimMIMViT``, the ViT, or a
    ``DINONetwork`` holding DINO's teacher.

    The experiment's ``best_model`` wins (``eval_dino`` reads it too); a
    finetune experiment without one falls back to its
    ``training.pretrained_path`` through the ``load_weights`` surgery
    (an untrained head); otherwise the network keeps its seed-0 init.
    """
    from ..models.builder import (build_model, config_mode, load_pretrained,
                                  load_weights)
    from ..utils.checkpoint import checkpoint_exists, load_checkpoint

    device = resolve_device(device)
    mode = config_mode(config)
    network = build_model(config, device)
    network.reset_parameters(torch.Generator(device=device).manual_seed(0))
    exp_path = config.get("eval", {}).get("experiment_path")
    ckpt = os.path.join(exp_path, "best_model") if exp_path else None
    if ckpt and checkpoint_exists(ckpt):
        tree, _ = load_checkpoint(ckpt)
        network.load_state_dict(tree["teacher"] if "teacher" in tree else tree["model"])
        logger.info("Loaded checkpoint '%s'", ckpt)
    elif mode == "eval_dino":
        raise FileNotFoundError(f"eval_dino: no best_model under {exp_path}")
    elif mode == "finetune":
        extended = bool(config["training"].get("extended_transfer", False))
        pretrained = load_pretrained(str(config["training"]["pretrained_path"]))
        network.load_state_dict(load_weights(network.state_dict(), pretrained, extended))
        logger.warning("No best_model under %s: evaluating the pretrained-path "
                       "surgery weights (untrained head)", exp_path)
    elif exp_path:
        logger.warning("No best_model checkpoint under %s: evaluating the current "
                       "init", exp_path)
    return network


# --- mode registry ----------------------------------------------------------------

def _run_knn(bank: FeatureBank, config, save_path, device) -> EvalOutcome:
    res = run_knn_evaluation(bank.train_features, bank.train_labels,
                             bank.val_features, bank.val_labels,
                             config["eval"]["num_classes"], device=device)
    return EvalOutcome(
        mode="eval_knn", method="KNN",
        headline=f"Accuracy: {res['accuracy'] * 100:.2f}%",
        scalars={"accuracy": float(res["accuracy"])},
        notes=[f"k={res.get('num_neighbors', '?')} (cosine)"], payload=res)


def _run_linear(bank: FeatureBank, config, save_path, device) -> EvalOutcome:
    res = run_linear_evaluation(bank.train_features, bank.train_labels,
                                bank.val_features, bank.val_labels, device=device)
    return EvalOutcome(
        mode="eval_linear", method="LINEAR",
        headline=f"Accuracy: {res['accuracy'] * 100:.2f}%",
        scalars={"accuracy": float(res["accuracy"])},
        notes=["Logistic Regression"], payload=res)


def _run_umap(bank: FeatureBank, config, save_path, device) -> EvalOutcome:
    features, labels = prepare_combined_features(
        bank.train_features, bank.train_labels, bank.val_features, bank.val_labels)
    embedding, metrics, quality, feedback = run_umap_analysis(
        features, labels, save_path, device=device)
    return EvalOutcome(
        mode="eval_umap", method="UMAP", headline=f"Quality: {quality}",
        scalars={k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))},
        notes=[f"Silhouette: {metrics['silhouette_features']:.3f}", *feedback],
        payload={"method": "umap", "embedding": embedding, "metrics": metrics,
                 "quality": quality, "feedback": feedback})


_MODE_REGISTRY: Dict[str, Callable[..., EvalOutcome]] = {
    "eval_knn": _run_knn,
    "eval_linear": _run_linear,
    "eval_umap": _run_umap,
}


def _requested_modes(config) -> List[str]:
    modes = config["eval"]["mode"]
    if not is_list(modes):
        modes = [modes] if modes else []
    return list(modes)


def run_modes(config, bank: FeatureBank, save_path: str, device=None) -> List[EvalOutcome]:
    """Dispatch every requested ``eval.mode`` through the registry."""
    device = resolve_device(device)
    outcomes: List[EvalOutcome] = []
    for mode in _requested_modes(config):
        runner = _MODE_REGISTRY.get(mode)
        if runner is None:
            logger.warning("Unknown evaluation mode '%s' - skipping", mode)
            continue
        logger.info("Running evaluation mode: %s", mode)
        outcomes.append(runner(bank, config, save_path, device))
    return outcomes


# --- summary rendering --------------------------------------------------------------

def render_summary(outcomes: List[EvalOutcome], output_path: str) -> None:
    """``evaluation_summary.csv`` (one row an outcome, the columns in order
    of first appearance, an absent cell empty) and
    ``evaluation_summary.txt``."""
    if not outcomes:
        return
    os.makedirs(output_path, exist_ok=True)

    def row(o: EvalOutcome) -> Dict[str, str]:
        cells = {"Evaluation_Mode": o.mode, "Method": o.method}
        label, _, value = o.headline.partition(": ")
        cells[label] = value
        if o.notes:
            cells["Additional_Info"] = o.notes[0]
        return cells

    rows = [row(o) for o in outcomes]
    header = list(dict.fromkeys(key for cells in rows for key in cells))
    write_csv(os.path.join(output_path, "evaluation_summary.csv"), header,
              [[cells.get(key, "") for key in header] for cells in rows])

    blocks = ["Multi-Evaluation Summary Report", "=" * 40, ""]
    for o in outcomes:
        blocks.append(f"{o.mode.upper()}:")
        blocks.append("-" * 20)
        blocks.append(f"  Method: {o.method}")
        blocks.append(f"  {o.headline}")
        blocks.extend(f"  {note}" for note in o.notes)
        blocks.append("")
    with open(os.path.join(output_path, "evaluation_summary.txt"), "w",
              encoding="utf-8") as fh:
        fh.write("\n".join(blocks))
    logger.info("Combined results saved to %s", output_path)


def _as_legacy_dict(o: EvalOutcome) -> Dict[str, Any]:
    legacy = dict(o.payload)
    if o.mode != "eval_umap":
        legacy.setdefault("method", o.method.lower())
    return legacy


# --- entry point ---------------------------------------------------------------------

def _refuse_eval_dino(config) -> None:
    """``eval.mode`` ``eval_dino`` (alone or first) loads DINO's host
    multi-crop, whose items are lists of views drawn through
    ``transforms["globals"]`` and ``["locals"]``, while the evaluation
    hands its datasets only the clean ``train``/``val`` pipelines and
    extracts features from single images. The JAX package's evaluator
    fails there at the first batch (``KeyError: 'globals'``); this one
    refuses up front, naming why."""
    modes = _requested_modes(config)
    if modes and str(modes[0]).lower() == "eval_dino":
        raise ValueError(
            "eval.mode eval_dino cannot be evaluated: its datasets are DINO's "
            "host multi-crop (lists of 'globals' and 'locals' views), but the "
            "evaluators pass only their 'train'/'val' pipelines and extract "
            "features from single images (the JAX package fails here too, with "
            "KeyError: 'globals'); use eval_knn, eval_linear or eval_umap")


def feature_bank(config, network: Optional[torch.nn.Module] = None, loaders=None,
                 device=None) -> FeatureBank:
    """The train and val features of ``network`` (default: the experiment's,
    :func:`load_model_state`) over ``loaders`` (default: the ``eval.*``
    datasets')."""
    if loaders is None:
        _refuse_eval_dino(config)
    if network is None:
        network = load_model_state(config, device)
    if loaders is None:
        from ..data.builder import prepare_dataloaders

        loaders = prepare_dataloaders(config, config["eval"]["mode"])
    train_loader, val_loader = loaders
    return FeatureBank(*extract_features(network, train_loader, device),
                       *extract_features(network, val_loader, device))


def run_evaluation(config, network: Optional[torch.nn.Module] = None,
                   save_path: Optional[str] = None, loaders=None,
                   device=None) -> Dict[str, Dict]:
    """Extract the features once (:func:`feature_bank`), run every
    ``eval.mode``, render the summary; {mode: result dict}."""
    device = resolve_device(device)
    if save_path:
        os.makedirs(save_path, exist_ok=True)
    if "experiment_path" in (config.get("eval", {}) or {}):
        config = merge_with_experiment_config(config)
    bank = feature_bank(config, network, loaders, device)

    output_path = config["eval"].get("experiment_path") or save_path
    outcomes = run_modes(config, bank, output_path, device)
    render_summary(outcomes, output_path)
    return {o.mode: _as_legacy_dict(o) for o in outcomes}

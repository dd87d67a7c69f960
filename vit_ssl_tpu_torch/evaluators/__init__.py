"""The evaluators of the port (after ``vit_ssl_tpu/evaluators``): feature
extraction, cosine KNN, the linear probe, native UMAP with its quality
metrics, and the unsupervised and supervised evaluation runs. Only torch,
numpy and scipy are imported at module level; figures import matplotlib
(and the 3D animation PIL) where they are drawn."""

from .embedding_analysis import (
    assess_quality,
    create_3d_umap_animation,
    evaluate_feature_quality,
    prepare_combined_features,
    run_umap_analysis,
)
from .evaluator_utils import extract_features, merge_with_experiment_config
from .knn import run_knn_evaluation
from .linear_probe import run_linear_evaluation

__all__ = [
    "assess_quality",
    "create_3d_umap_animation",
    "evaluate_feature_quality",
    "prepare_combined_features",
    "run_umap_analysis",
    "extract_features",
    "merge_with_experiment_config",
    "run_knn_evaluation",
    "run_linear_evaluation",
]

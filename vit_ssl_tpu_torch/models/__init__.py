"""Models of the port (mirrors ``vit_ssl_tpu/models``)."""

from .builder import build_backbone, build_dino_network, build_model, build_vit
from .dino import DINOHead, DINONetwork, ViTBackbone, WeightNormDense
from .vit import ViT

__all__ = [
    "DINOHead",
    "DINONetwork",
    "ViT",
    "ViTBackbone",
    "WeightNormDense",
    "build_backbone",
    "build_dino_network",
    "build_model",
    "build_vit",
]

"""Models of the port (mirrors ``vit_ssl_tpu/models``)."""

from .builder import build_backbone, build_dino_network
from .dino import DINOHead, DINONetwork, ViTBackbone, WeightNormDense

__all__ = [
    "DINOHead",
    "DINONetwork",
    "ViTBackbone",
    "WeightNormDense",
    "build_backbone",
    "build_dino_network",
]

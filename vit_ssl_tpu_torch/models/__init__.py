"""Models of the port (mirrors ``vit_ssl_tpu/models``)."""

from .builder import (build_backbone, build_dino_network, build_model, build_simmim,
                      build_vit)
from .dino import DINOHead, DINONetwork, ViTBackbone, WeightNormDense
from .simmim import SimMIMViT, make_random_mask, masked_l1_loss
from .vit import ViT

__all__ = [
    "DINOHead",
    "DINONetwork",
    "SimMIMViT",
    "ViT",
    "ViTBackbone",
    "WeightNormDense",
    "build_backbone",
    "build_dino_network",
    "build_model",
    "build_simmim",
    "build_vit",
    "make_random_mask",
    "masked_l1_loss",
]

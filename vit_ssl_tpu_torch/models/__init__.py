"""Models of the port (mirrors ``vit_ssl_tpu/models``)."""

from .builder import build_backbone
from .dino import ViTBackbone

__all__ = ["ViTBackbone", "build_backbone"]

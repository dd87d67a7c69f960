"""Encoder ops of the port (mirrors ``vit_ssl_tpu/ops``)."""

from .attention import MultiHeadAttention, scaled_dot_product_attention
from .dropout import Dropout, dropout16, keep_mask16
from .encoder_block import EncoderBlock
from .feed_forward import FeedForwardBlock
from .flash_attention import attention_nhd, attention_nhd_reference
from .mlp_head import MLPHead
from .patch_embedding import ConvPatchEmbed, DynamicPatchEmbed

__all__ = [
    "ConvPatchEmbed",
    "Dropout",
    "DynamicPatchEmbed",
    "EncoderBlock",
    "FeedForwardBlock",
    "MLPHead",
    "MultiHeadAttention",
    "attention_nhd",
    "attention_nhd_reference",
    "dropout16",
    "keep_mask16",
    "scaled_dot_product_attention",
]

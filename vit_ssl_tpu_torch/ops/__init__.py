"""Encoder ops of the port (mirrors ``vit_ssl_tpu/ops``)."""

from .attention import MultiHeadAttention, scaled_dot_product_attention
from .encoder_block import EncoderBlock
from .feed_forward import FeedForwardBlock
from .flash_attention import attention_nhd, attention_nhd_reference
from .patch_embedding import DynamicPatchEmbed

__all__ = [
    "DynamicPatchEmbed",
    "EncoderBlock",
    "FeedForwardBlock",
    "MultiHeadAttention",
    "attention_nhd",
    "attention_nhd_reference",
    "scaled_dot_product_attention",
]

"""Encoder ops of the port (mirrors ``vit_ssl_tpu/ops``)."""

from .attention import MultiHeadAttention, scaled_dot_product_attention
from .dropout import (Dropout, dropout16, dropout_bernoulli, keep_mask16,
                      keep_mask_bernoulli)
from .encoder_block import EncoderBlock
from .feed_forward import FeedForwardBlock
from .flash_attention import attention_nhd, attention_nhd_reference
from .mlp_head import MLPHead
from .patch_embedding import (ConvPatchEmbed, DynamicPatchEmbed, ManualPatchEmbed,
                              extract_patches, patches_to_image)

__all__ = [
    "ConvPatchEmbed",
    "Dropout",
    "DynamicPatchEmbed",
    "EncoderBlock",
    "FeedForwardBlock",
    "MLPHead",
    "ManualPatchEmbed",
    "MultiHeadAttention",
    "attention_nhd",
    "attention_nhd_reference",
    "dropout16",
    "dropout_bernoulli",
    "extract_patches",
    "keep_mask16",
    "keep_mask_bernoulli",
    "patches_to_image",
    "scaled_dot_product_attention",
]

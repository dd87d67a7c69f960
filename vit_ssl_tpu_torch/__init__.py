"""PyTorch/CUDA port of ``vit_ssl_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; each module here mirrors the path of
its counterpart there. Plain tensor code is PyTorch, and every Pallas TPU
kernel on a ported path is a hand-written Hopper kernel under ``csrc/``,
built at first use (:mod:`.kernels`).

Ported so far: the DINO serving path (:mod:`.serve`): checkpoint →
``ViTBackbone`` → teacher CLS embedding, with attention through the
``attention_nhd_fwd`` CUDA kernel.

This package imports neither ``jax`` nor ``vit_ssl_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

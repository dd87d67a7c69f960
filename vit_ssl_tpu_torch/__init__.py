"""PyTorch/CUDA port of ``vit_ssl_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; each module here mirrors the path of
its counterpart there. Plain tensor code is PyTorch, and every Pallas TPU
kernel on a ported path is a hand-written Hopper kernel under ``csrc/``,
built at first use (:mod:`.kernels`).

Ported so far:

- the DINO serving path (:mod:`.serve`): checkpoint → ``ViTBackbone`` →
  teacher CLS embedding, attention through the ``attention_nhd_fwd`` CUDA
  kernel;
- the DINO training step (:func:`.train.make_dino_steps`): multi-crop views
  made on the device (:mod:`.data.device_augment`), student and teacher
  ``DINONetwork``s with dropout and packed locals, the weighted loss and
  center, AdamW with optax's arithmetic, the teacher EMA and the collapse
  statistics; attention through the ``attention_nhd_fwd_stats`` and
  ``attention_nhd_bwd`` CUDA kernels (and the inference kernel for the
  teacher);
- ``model.use_fused_mlp=true`` on both paths: each FFN runs as the fused
  MLP kernels (``fused_mlp_fwd``, ``fused_mlp_fwd_pre``, ``fused_mlp_bwd``);
- the supervised ViT (:class:`.models.ViT`): its training and evaluation
  steps (:func:`.train.make_supervised_steps`, augmentation on the
  device) and serving of supervised/finetune checkpoints (class
  predictions); where B1 does not fit (ViT-B/16 at 384 px) attention runs
  through the head-major kernels ``fused_attention_fwd``,
  ``fused_attention_fwd_stats`` and ``fused_attention_bwd`` (kernel B3).

This package imports neither ``jax`` nor ``vit_ssl_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

"""Classification head (port of ``vit_ssl_tpu/ops/mlp_head.py``).

LayerNorm (eps 1e-5) then Linear over the CLS token, both in fp32
whatever the compute dtype: the logits feed the softmax cross-entropy
directly. Parameter names as in the reference state dict: ``norm.*`` and
``linear.*``.
"""

from __future__ import annotations

from torch import nn


class MLPHead(nn.Module):
    def __init__(self, d_model: int, num_classes: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.linear = nn.Linear(d_model, num_classes, device=device)

    def forward(self, x):
        """(B, d_model) → (B, num_classes) fp32 logits."""
        return self.linear(self.norm(x.float()))

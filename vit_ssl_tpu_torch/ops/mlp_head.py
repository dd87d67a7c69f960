"""Classification head (port of ``vit_ssl_tpu/ops/mlp_head.py``).

LayerNorm (eps 1e-5) then Linear over the CLS token, both in fp32
whatever the compute dtype: the logits feed the softmax cross-entropy
directly. Parameter names as in the reference state dict: ``norm.*`` and
``linear.*``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import axis_of, linear_body, run, whole


class MLPHead(nn.Module):
    def __init__(self, d_model: int, num_classes: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.linear = nn.Linear(d_model, num_classes, device=device)

    def forward(self, x):
        """(B, d_model) → (B, num_classes) fp32 logits; under tensor
        parallelism ``linear`` is column-parallel and the logits gathered
        (JAX's rule also shards the LayerNorm's bias, gathered here)."""
        norm = self.norm
        x = F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                         whole(axis_of(norm), norm.bias), norm.eps)
        return run(axis_of(self.linear), linear_body, (x,),
                   (self.linear.weight, self.linear.bias), (0, 0), "cat")

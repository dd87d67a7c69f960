"""``model.matmul_precision`` (port of ``vit_ssl_tpu/ops/precision.py``).

The JAX package maps the name to a ``jax.lax.Precision`` for every Dense,
conv and einsum. The port's products are PyTorch's and its kernels', and
the names map as follows (:func:`resolve_precision`):

- ``"default"``, ``"bfloat16"``, ``"fastest"`` (JAX: ``Precision.DEFAULT``)
  and ``"none"`` (JAX: its global default) → ``"default"``: what the port
  does. bf16 compute multiplies bf16 operands with fp32 sums; fp32 compute
  runs PyTorch's fp32 products under its global setting and the kernels'
  fp32 paths in full fp32 on the CUDA cores.
- ``"highest"``, ``"float32"`` (``Precision.HIGHEST``) → ``"highest"``:
  full fp32 products, which the port gives while
  ``torch.get_float32_matmul_precision()`` is ``"highest"`` (PyTorch's
  default). In bf16 compute the products are those of ``"default"``: bf16
  operands multiply exactly into fp32 sums either way.
- ``"high"``, ``"tensorfloat32"`` (``Precision.HIGH``, about TF32): refused
  with ``NotImplementedError``, as is ``"highest"`` under another global
  setting: honouring them would change PyTorch's global matmul state
  (``torch.set_float32_matmul_precision``), which the port does not touch.

Any other name raises the JAX package's ``ValueError``.
"""

from __future__ import annotations

import torch

_ALIASES = {
    "default": "default",
    "bfloat16": "default",
    "fastest": "default",
    "high": "high",
    "tensorfloat32": "high",
    "highest": "highest",
    "float32": "highest",
}


def resolve_precision(name) -> str:
    """The port's precision for a config name: ``"default"`` or
    ``"highest"``; see the module docstring for what each means and what
    is refused."""
    key = "none" if name is None else str(name).lower()
    if key == "none":
        return "default"
    if key not in _ALIASES:
        raise ValueError(
            f"Unknown matmul_precision {name!r}; expected one of "
            f"{sorted(_ALIASES)} or 'none'"
        )
    precision = _ALIASES[key]
    current = torch.get_float32_matmul_precision()
    if precision == "high" or (precision == "highest" and current != "highest"):
        raise NotImplementedError(
            f"model.matmul_precision={name!r} is not ported: it needs PyTorch's "
            f"global float32 matmul precision at {precision!r} (it is {current!r}"
            "), and vit_ssl_tpu_torch/ops/precision.py does not change global state"
        )
    return precision

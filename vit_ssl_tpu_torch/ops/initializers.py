"""Parameter initialisation schemes (port of ``vit_ssl_tpu/ops/initializers.py``).

``model.init_scheme`` picks one:

- ``"reference"`` (the default): PyTorch's own ``nn.Linear``/``nn.Conv2d``
  defaults (Kaiming-uniform weights with a=√5, i.e. U(±1/√fan_in), and
  U(±1/√fan_in) biases), U[0, 1) CLS and positional embeddings and a
  standard-normal mask token;
- ``"tpu"``: LeCun-normal weights (a normal truncated at ±2σ and scaled so
  that its std is 1/√fan_in, as ``jax.nn.initializers.lecun_normal``), zero
  biases, and CLS token, positional embedding and mask token from a normal
  of σ 0.02 truncated at ±2σ (``jax.nn.initializers.truncated_normal``,
  which does not correct the variance).

LayerNorms start at ones and zeros under both. Any other name raises, as
in the JAX package. The draws come from a ``torch.Generator``, so they
differ from ``jax.random``'s by design: the distributions match, not the
numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

SCHEMES = ("reference", "tpu")
# std of a standard normal truncated at ±2: lecun_normal divides by it
_TRUNC_STD = 0.87962566103423978
_TOKEN_STD = 0.02
_TOKENS = ("cls_token", "positional_embedding", "mask_token")


def check_scheme(name: str) -> str:
    """``name`` if it is a scheme, else JAX's ``ValueError``."""
    if name not in SCHEMES:
        raise ValueError(f"Unknown init scheme: {name}")
    return name


def _fan_in(weight: torch.Tensor) -> int:
    return weight[0].numel()  # in_features, or in_channels · kh · kw


@torch.no_grad()
def weight_(weight: torch.Tensor, scheme: str,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A Linear or Conv kernel in the ``(out, in, ...)`` layout."""
    if check_scheme(scheme) == "reference":
        return nn.init.kaiming_uniform_(weight, a=math.sqrt(5), generator=generator)
    std = 1.0 / math.sqrt(_fan_in(weight)) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def kernel_(weight: torch.Tensor, fan_in: int, scheme: str,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A kernel of any layout with the given fan-in (the MoE router's
    (d, E), an expert's (d, f) or (f, d) slice): U(±1/√fan_in), the
    reference's Linear default, or LeCun-normal."""
    if check_scheme(scheme) == "reference":
        bound = 1.0 / math.sqrt(fan_in)
        return nn.init.uniform_(weight, -bound, bound, generator=generator)
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def bias_(bias: torch.Tensor, fan_in: int, scheme: str,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if check_scheme(scheme) == "reference":
        bound = 1.0 / math.sqrt(fan_in)
        return nn.init.uniform_(bias, -bound, bound, generator=generator)
    return nn.init.zeros_(bias)


@torch.no_grad()
def linear_(module: nn.Module, scheme: str,
            generator: Optional[torch.Generator] = None) -> nn.Module:
    """Weight, then bias, of a ``nn.Linear`` or ``nn.Conv2d``."""
    weight_(module.weight, scheme, generator)
    if module.bias is not None:
        bias_(module.bias, _fan_in(module.weight), scheme, generator)
    return module


@torch.no_grad()
def token_(param: torch.Tensor, scheme: str,
           generator: Optional[torch.Generator] = None,
           mask_token: bool = False) -> torch.Tensor:
    """A CLS token or positional embedding, or (``mask_token``) a mask
    token."""
    if check_scheme(scheme) == "reference":
        if mask_token:
            return nn.init.normal_(param, generator=generator)
        return nn.init.uniform_(param, generator=generator)
    return nn.init.trunc_normal_(param, 0.0, _TOKEN_STD, -2 * _TOKEN_STD,
                                 2 * _TOKEN_STD, generator=generator)


@torch.no_grad()
def _init_module(module: nn.Module, scheme: str, generator, layer=None) -> None:
    """One module's own parameters; ``layer`` picks that slice of a stacked
    (layer-leading) parameter."""
    def own(t):
        return t if layer is None else t[layer]

    if isinstance(module, (nn.Linear, nn.Conv2d)):
        weight_(own(module.weight), scheme, generator)
        if module.bias is not None:
            bias_(own(module.bias), _fan_in(own(module.weight)), scheme, generator)
    elif isinstance(module, nn.LayerNorm):
        nn.init.ones_(module.weight)
        nn.init.zeros_(module.bias)
    elif hasattr(module, "init_parameters"):  # an MoE FFN's experts
        module.init_parameters(scheme, generator)
    for name in _TOKENS:
        param = getattr(module, name, None)
        if isinstance(param, nn.Parameter):
            token_(own(param), scheme, generator, name == "mask_token")


@torch.no_grad()
def init_(model: nn.Module, scheme: str = "reference",
          generator: Optional[torch.Generator] = None) -> nn.Module:
    """Redraw every Linear, Conv2d and LayerNorm parameter of ``model``, its
    tokens and its MoE experts with ``scheme``, in module order. A scanned
    encoder stack (a module with ``stacked_layers``) draws its layers one
    after another, each in its block's module order: the draws of the
    unrolled stack, bit for bit. Returns ``model``."""
    check_scheme(scheme)
    inside_stack = set()
    for module in model.modules():
        if id(module) in inside_stack:
            continue
        layers = getattr(module, "stacked_layers", None)
        if layers is not None:
            inner = list(module.modules())[1:]
            inside_stack.update(id(m) for m in inner)
            for layer in range(layers):
                for sub in inner:
                    _init_module(sub, scheme, generator, layer)
            continue
        _init_module(module, scheme, generator)
    return model


def reference_init_(model: nn.Module, generator: Optional[torch.Generator] = None):
    """:func:`init_` with the reference scheme."""
    return init_(model, "reference", generator)

"""Train states and optimizer (port of ``vit_ssl_tpu/train/state.py``).

:class:`TrainState` holds what the JAX package threads through its jitted
DINO step: the step count, the student and teacher ``DINONetwork``s, the
center, the AdamW moments (:class:`AdamWState`) and the base seed.
:class:`SupervisedTrainState` holds the supervised step's: the step count,
the model, the moments and the seed. Unlike JAX's immutable pytree each is
updated in place by its step (parameters, moments, teacher, center), which
saves a copy of every tensor.

:class:`AdamW` (the hyper-parameters and the update, as an optax
transformation is) mirrors ``optax.adamw``'s arithmetic, not
``torch.optim.AdamW``'s: ``scale_by_adam`` with bias correction at
count + 1 (m̂ / (√v̂ + eps)), then ``+ weight_decay·param`` on every
parameter, then ``× −lr(count)`` with the schedule read at the count before
it increments.

Random streams: ``next_generators`` derives one ``torch.Generator`` per
stream from ``numpy.random.SeedSequence((seed, step, stream))`` — the
step's streams differ from every other step's and from each other, and a
resumed run redraws the same ones. The numbers differ from
``jax.random``'s by design.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class AdamWState:
    """The optimizer's part of the train state: the update count and the
    first and second moments, one per parameter."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """``optax.adamw(lr_schedule, b1, b2, eps, weight_decay)``: the
    hyper-parameters; the moments live in an :class:`AdamWState`."""

    def __init__(self, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-2):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamWState) -> float:
        """One update of ``params`` and ``state`` in place from ``grads``;
        returns the lr it used."""
        f32 = np.float32
        lr = float(self.lr_schedule(state.count))
        count_inc = state.count + 1
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count_inc))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count_inc))
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - self.b2))
        denom = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(state.mu, bc1), denom)
        torch._foreach_add_(update, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(update, -lr))
        state.count = count_inc
        return lr


def step_generators(seed: int, step: int, n: int, device) -> List[torch.Generator]:
    """Step ``step``'s n generators on ``device``, stream i seeded from
    SeedSequence((seed, step, i))."""
    gens = []
    for stream in range(n):
        seq = np.random.SeedSequence((seed, step, stream))
        value = int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))
        gens.append(torch.Generator(device=device).manual_seed(value))
    return gens


class SupervisedTrainState:
    """The supervised step's train state: the step count, the model (a
    ``ViT``), the AdamW moments and the base seed."""

    def __init__(self, model: nn.Module, optimizer: AdamW, seed: int):
        self.step = 0
        self.seed = int(seed)
        self.model = model
        self.opt_state = optimizer.init(self.params)

    @property
    def params(self) -> List[torch.Tensor]:
        """The model's parameters, in ``named_parameters`` order."""
        return list(self.model.parameters())

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def next_generators(self, n: int, device=None) -> List[torch.Generator]:
        """This step's n generators on ``device`` (default: the model's)."""
        device = self.device if device is None else torch.device(device)
        return step_generators(self.seed, self.step, n, device)


class TrainState:
    """DINO's train state; the teacher starts as an exact copy of the
    student, the center at zero."""

    def __init__(self, student: nn.Module, optimizer: AdamW, seed: int,
                 teacher: Optional[nn.Module] = None,
                 center: Optional[torch.Tensor] = None):
        device = next(student.parameters()).device
        self.step = 0
        self.seed = int(seed)
        self.student = student
        self.teacher = copy.deepcopy(student) if teacher is None else teacher
        self.teacher.requires_grad_(False)
        if center is None:
            output_dim = student.head.fully_connected.bias.shape[0]
            center = torch.zeros(1, output_dim, device=device)
        self.center = center
        self.opt_state = optimizer.init(self.params)

    @property
    def params(self) -> List[torch.Tensor]:
        """The student's parameters, in ``named_parameters`` order."""
        return list(self.student.parameters())

    @property
    def device(self) -> torch.device:
        return self.center.device

    def next_generators(self, n: int, device=None) -> List[torch.Generator]:
        """This step's n generators on ``device`` (default: the state's),
        stream i seeded from SeedSequence((seed, step, i))."""
        device = self.device if device is None else torch.device(device)
        return step_generators(self.seed, self.step, n, device)

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The reference ``DINOViT`` layout: ``student_backbone.*``,
        ``student_head.*``, ``teacher_backbone.*``, ``teacher_head.*``,
        ``center``."""
        sd = {f"student_{k}": v for k, v in self.student.state_dict().items()}
        sd.update({f"teacher_{k}": v for k, v in self.teacher.state_dict().items()})
        sd["center"] = self.center
        return sd

    @torch.no_grad()
    def load_model_state_dict(self, state: Dict[str, torch.Tensor],
                              strict: bool = True) -> None:
        """Loads a reference-layout state dict (e.g. the JAX package's, via
        ``utils.checkpoint.dino_state_dict_from_flax``)."""
        parts = {"student_": {}, "teacher_": {}}
        rest = {}
        for key, value in state.items():
            if key[:8] in parts:
                parts[key[:8]][key[8:]] = value
            else:
                rest[key] = value
        if strict and set(rest) - {"center"}:
            raise KeyError(f"unexpected keys {sorted(set(rest) - {'center'})}")
        if strict and "center" not in rest:
            raise KeyError("missing key 'center'")
        self.student.load_state_dict(parts["student_"], strict=strict)
        self.teacher.load_state_dict(parts["teacher_"], strict=strict)
        if "center" in rest:
            self.center.copy_(rest["center"].reshape(self.center.shape))

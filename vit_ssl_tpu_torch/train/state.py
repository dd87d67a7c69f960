"""Train states and optimizer (port of ``vit_ssl_tpu/train/state.py``).

:class:`TrainState` holds what the JAX package threads through its jitted
DINO step: the step count, the student and teacher ``DINONetwork``s, the
center, the optimizer's buffers (:class:`OptimizerState`) and the base
seed. :class:`SupervisedTrainState` holds the supervised and SimMIM
steps': the step count, the model, the buffers and the seed. Unlike JAX's immutable pytree each is
updated in place by its step (parameters, moments, teacher, center), which
saves a copy of every tensor.

The optimizers (:class:`AdamW`, :class:`Adam`, :class:`SGD`,
:class:`RMSprop`: the hyper-parameters and the update, as an optax
transformation is) mirror optax's arithmetic, not ``torch.optim``'s: e.g.
AdamW is ``scale_by_adam`` with bias correction at count + 1
(m̂ / (√v̂ + eps)), then ``+ weight_decay·param``, then ``× −lr(count)`` with
the schedule read at the count before it increments; RMSprop puts eps
inside the square root. A trainable mask freezes parameters as optax's
``multi_transform`` with ``set_to_zero`` does.

:func:`make_optimizer` builds the optimizer the config names
(``training.optimizer``); each state's ``state_dict`` and
``load_state_dict`` carry it through a checkpoint, so that a resumed run
continues bit for bit.

Random streams: ``next_generators`` derives one ``torch.Generator`` per
stream from ``numpy.random.SeedSequence((seed, step, stream))`` — the
step's streams differ from every other step's and from each other, and a
resumed run redraws the same ones. The numbers differ from
``jax.random``'s by design.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class OptimizerState:
    """The optimizer's part of the train state: the update count and the
    optimizer's buffers by name (AdamW and Adam: the moments ``mu`` and
    ``nu``; SGD with momentum: ``trace``; RMSprop: ``nu``, and ``trace``
    with momentum), each one tensor per trained parameter."""

    count: int
    buffers: Dict[str, List[torch.Tensor]]

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, **{k: list(v) for k, v in self.buffers.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copies the saved buffers into this state's tensors, in place."""
        saved = set(state) - {"count"}
        if saved != set(self.buffers):
            raise ValueError(f"optimizer buffers {sorted(saved)} saved, "
                             f"{sorted(self.buffers)} here")
        for name, ours in self.buffers.items():
            theirs = state[name]
            if len(ours) != len(theirs):
                raise ValueError(f"{name}: {len(theirs)} tensors saved, "
                                 f"{len(ours)} trained parameters here")
            for a, b in zip(ours, theirs):
                if a.shape != b.shape:
                    raise ValueError(f"{name}: shape {tuple(b.shape)} saved, "
                                     f"{tuple(a.shape)} here")
                a.copy_(b)
        self.count = int(state["count"])


def buffers_in_order(opt_state: Dict[str, Any], names: Sequence[str]) -> Dict[str, Any]:
    """A saved optimizer state whose buffers are keyed by parameter name (a
    JAX checkpoint's, ``utils.checkpoint.train_state_from_flax``) with each
    buffer a list in the order of ``names``, the trained parameters' names
    in the optimizer's order, which must be the names it holds; a state of
    lists passes as it is."""
    by_name = {k: v for k, v in opt_state.items() if isinstance(v, dict)}
    if not by_name:
        return opt_state
    out = dict(opt_state)
    for field, buffers in by_name.items():
        if set(buffers) != set(names):
            raise ValueError(
                f"optimizer buffer {field} saved for {len(buffers)} parameters, "
                f"{len(names)} are trained here (saved only: "
                f"{sorted(set(buffers) - set(names))[:5]}, trained only: "
                f"{sorted(set(names) - set(buffers))[:5]})")
        out[field] = [buffers[n] for n in names]
    return out


class Optimizer:
    """An optax optimizer over a list of parameters: its hyper-parameters
    and its update; the buffers live in an :class:`OptimizerState`.

    ``trainable`` (one bool a parameter, in the list's order; None: all)
    is optax's ``multi_transform`` with ``set_to_zero`` on the frozen
    leaves: they get no update, no weight decay and no buffers.
    :meth:`select` picks the trained ones out of any per-parameter list;
    the steps take gradients of those only. The lr is ``lr_schedule`` at
    the count before it increments, as ``optax.scale_by_learning_rate``
    reads it."""

    buffer_names: tuple = ()

    def __init__(self, lr_schedule: Callable[[int], float],
                 trainable: Optional[Sequence[bool]] = None):
        self.lr_schedule = lr_schedule
        self.trainable = None if trainable is None else [bool(t) for t in trainable]

    def select(self, items: Sequence) -> list:
        """The entries of ``items`` (one a parameter) that are trained."""
        items = list(items)
        if self.trainable is None:
            return items
        if len(items) != len(self.trainable):
            raise ValueError(f"{len(items)} entries for {len(self.trainable)} "
                             "parameters in the trainable mask")
        return [x for x, t in zip(items, self.trainable) if t]

    def init(self, params: List[torch.Tensor]) -> OptimizerState:
        trained = self.select(params)
        return OptimizerState(0, {name: [torch.zeros_like(p) for p in trained]
                                  for name in self.buffer_names})

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: OptimizerState) -> float:
        """One update, in place, of the trained ``params`` (as
        :meth:`select` gives them) and ``state`` from their ``grads``;
        returns the lr it used."""
        lr = float(self.lr_schedule(state.count))
        state.count += 1
        if params:
            self._apply(params, list(grads), state, lr)
        return lr

    def _apply(self, params, grads, state, lr):
        raise NotImplementedError


class AdamW(Optimizer):
    """``optax.adamw(lr_schedule, b1, b2, eps, weight_decay)``:
    ``scale_by_adam`` with bias correction at count + 1 (m̂ / (√v̂ + eps)),
    ``+ weight_decay·param``, then ``× −lr``."""

    buffer_names = ("mu", "nu")

    def __init__(self, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-2,
                 trainable: Optional[Sequence[bool]] = None):
        super().__init__(lr_schedule, trainable)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)

    def _apply(self, params, grads, state, lr):
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(state.count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(state.count))
        mu, nu = state.buffers["mu"], state.buffers["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - self.b2))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(update, -lr))


class Adam(AdamW):
    """``optax.adam(lr_schedule, b1, b2, eps)``: AdamW without the decay."""

    def __init__(self, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 trainable: Optional[Sequence[bool]] = None):
        super().__init__(lr_schedule, b1, b2, eps, 0.0, trainable)


class SGD(Optimizer):
    """``optax.sgd(lr_schedule, momentum, nesterov)``: with momentum the
    trace t ← g + momentum·t, the update t (nesterov: g + momentum·t), then
    ``× −lr``; without, −lr·g and no buffer."""

    def __init__(self, lr_schedule: Callable[[int], float], momentum: float = 0.0,
                 nesterov: bool = False, trainable: Optional[Sequence[bool]] = None):
        super().__init__(lr_schedule, trainable)
        self.momentum, self.nesterov = float(momentum), bool(nesterov)
        self.buffer_names = ("trace",) if self.momentum else ()

    def _apply(self, params, grads, state, lr):
        update = grads
        if self.momentum:
            trace = state.buffers["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            update = (torch._foreach_add(grads, torch._foreach_mul(trace, self.momentum))
                      if self.nesterov else trace)
        torch._foreach_add_(params, torch._foreach_mul(update, -lr))


class RMSprop(Optimizer):
    """``optax.rmsprop(lr_schedule, decay, eps, momentum)``: ν ← decay·ν +
    (1 − decay)·g² from ν = 0, the step g·rsqrt(ν + eps) (eps inside the
    square root, unlike ``torch.optim.RMSprop``), ``× −lr``, and then, with
    momentum, the trace of those lr-scaled steps t ← step + momentum·t as
    the update (optax applies momentum after the lr)."""

    def __init__(self, lr_schedule: Callable[[int], float], decay: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0,
                 trainable: Optional[Sequence[bool]] = None):
        super().__init__(lr_schedule, trainable)
        self.decay, self.eps, self.momentum = float(decay), float(eps), float(momentum)
        self.buffer_names = ("nu", "trace") if self.momentum else ("nu",)

    def _apply(self, params, grads, state, lr):
        nu = state.buffers["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - self.decay))
        step = torch._foreach_mul(grads, torch._foreach_rsqrt(
            torch._foreach_add(nu, self.eps)))
        update = torch._foreach_mul(step, -lr)
        if self.momentum:
            trace = state.buffers["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, update)
            update = trace
        torch._foreach_add_(params, update)


def _betas(p):
    b1, b2 = tuple(p.get("betas", (0.9, 0.999)))
    return float(b1), float(b2)


# the JAX package's registry (vit_ssl_tpu/train/state.py::_OPTIMIZERS), with
# its defaults; each entry builds from the config's optimizer.params
_OPTIMIZERS: Dict[str, Callable] = {
    "AdamW": lambda lr, p, mask: AdamW(
        lr, *_betas(p), eps=float(p.get("eps", 1e-8)),
        weight_decay=float(p.get("weight_decay", 1e-2)), trainable=mask),
    "Adam": lambda lr, p, mask: Adam(lr, *_betas(p), eps=float(p.get("eps", 1e-8)),
                                     trainable=mask),
    "SGD": lambda lr, p, mask: SGD(lr, momentum=float(p.get("momentum", 0.0)),
                                   nesterov=bool(p.get("nesterov", False)),
                                   trainable=mask),
    "RMSprop": lambda lr, p, mask: RMSprop(
        lr, decay=float(p.get("alpha", 0.99)), eps=float(p.get("eps", 1e-8)),
        momentum=float(p.get("momentum", 0.0)), trainable=mask),
}


def make_optimizer(config, lr_schedule: Callable[[int], float],
                   trainable_mask: Optional[Sequence[bool]] = None) -> Optimizer:
    """The optimizer ``training.optimizer`` names, with its ``params`` (the
    schedule owns the lr), as ``vit_ssl_tpu/train/state.py::make_optimizer``
    builds it; ``trainable_mask`` (one bool a parameter, in the model's
    ``parameters()`` order) freezes the False ones."""
    opt_cfg = config["training"]["optimizer"]
    name = opt_cfg["name"]
    if name not in _OPTIMIZERS:
        raise ValueError(f"Unknown optimizer '{name}' (have {sorted(_OPTIMIZERS)})")
    params = dict(opt_cfg.get("params", {}) or {})
    params.pop("lr", None)
    return _OPTIMIZERS[name](lr_schedule, params, trainable_mask)


def step_generators(seed: int, step: int, n: int, device,
                    per_rank: Sequence[int] = ()) -> List[torch.Generator]:
    """Step ``step``'s n generators on ``device``, stream i seeded from
    SeedSequence((seed, step, i)). Under data parallelism (dp > 1) the
    streams listed in ``per_rank`` (the dropout streams) fold the data rank
    in, SeedSequence((seed, step, i, rank + 1)): each data rank draws its own
    masks, while the seq ranks of one data index draw the same ones; the
    other streams are the same on every rank (their per-image draws are
    partitioned instead, :func:`..parallel.context.rand_rows`)."""
    from ..parallel.context import data_rank, dp_size

    ranked = set(per_rank) if dp_size() > 1 else set()
    gens = []
    for stream in range(n):
        # rank + 1: SeedSequence pads short entropy with zeros, so a
        # trailing 0 would not change the stream
        key = (seed, step, stream) + ((data_rank() + 1,) if stream in ranked else ())
        seq = np.random.SeedSequence(key)
        value = int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))
        gens.append(torch.Generator(device=device).manual_seed(value))
    return gens


class SupervisedTrainState:
    """A one-model train state (the supervised and SimMIM steps'): the step
    count, the model (a ``ViT`` or a ``SimMIMViT``), the optimizer's buffers
    and the base seed."""

    def __init__(self, model: nn.Module, optimizer: Optimizer, seed: int):
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

    def next_generators(self, n: int, device=None,
                        per_rank: Sequence[int] = ()) -> List[torch.Generator]:
        """This step's n generators on ``device`` (default: the model's);
        ``per_rank`` as :func:`step_generators` takes it."""
        device = self.device if device is None else torch.device(device)
        return step_generators(self.seed, self.step, n, device, per_rank)

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the step, the model's state dict (the
        reference ``ViT`` or ``SimMIM`` layout) and the optimizer's count and buffers
        (the state's own tensors, not copies)."""
        return {"step": self.step, "model": self.model.state_dict(),
                "opt_state": self.opt_state.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copies a :meth:`state_dict` into this state's tensors, in place."""
        self.model.load_state_dict(state["model"], strict=True)
        self.opt_state.load_state_dict(state["opt_state"])
        self.step = int(state["step"])


class TrainState:
    """DINO's train state; the teacher starts as an exact copy of the
    student, the center at zero."""

    def __init__(self, student: nn.Module, optimizer: Optimizer, seed: int,
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

    def next_generators(self, n: int, device=None,
                        per_rank: Sequence[int] = ()) -> List[torch.Generator]:
        """This step's n generators on ``device`` (default: the state's),
        stream i seeded from SeedSequence((seed, step, i)); ``per_rank`` as
        :func:`step_generators` takes it."""
        device = self.device if device is None else torch.device(device)
        return step_generators(self.seed, self.step, n, device, per_rank)

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The reference ``DINOViT`` layout: ``student_backbone.*``,
        ``student_head.*``, ``teacher_backbone.*``, ``teacher_head.*``,
        ``center``."""
        sd = {f"student_{k}": v for k, v in self.student.state_dict().items()}
        sd.update({f"teacher_{k}": v for k, v in self.teacher.state_dict().items()})
        sd["center"] = self.center
        return sd

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the step, the student's and teacher's
        state dicts, the center and the optimizer's count and buffers (the
        state's own tensors, not copies)."""
        return {"step": self.step, "student": self.student.state_dict(),
                "teacher": self.teacher.state_dict(), "center": self.center,
                "opt_state": self.opt_state.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copies a :meth:`state_dict` into this state's tensors, in place
        (they keep their device)."""
        self.student.load_state_dict(state["student"], strict=True)
        self.teacher.load_state_dict(state["teacher"], strict=True)
        self.center.copy_(state["center"].reshape(self.center.shape))
        self.opt_state.load_state_dict(state["opt_state"])
        self.step = int(state["step"])

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

"""The training and evaluation steps (port of ``vit_ssl_tpu/train/steps.py``):
the supervised steps (``make_supervised_steps``, ``:97-271``) and the DINO
steps (``make_dino_steps``, ``:429-692``).

The supervised ``train_step`` makes its images (``augment_fn`` on the
device from uint8, or the batch's own images scaled to [0, 1]), runs the
model with dropout on, takes the weighted mean of the fp32 softmax
cross-entropy, its backward and one optimizer update. Two generators a
step, from ``state.next_generators(2)``: dropout, augmentation. Both
steps take gradients of the parameters the optimizer trains only
(``optimizer.select``: all of them unless a trainable mask freezes some);
the gradient still flows through frozen blocks to what lies before them.
:func:`make_criterion` checks the config's ``training.criterion`` against
what each mode's step computes.

One DINO ``train_step`` runs, in order:

1. the views: ``view_fn(generator, batch["image"])`` (device
   augmentation from uint8 images) or the host's ``batch["views"]``;
2. the student on the concatenated global views and on the local views
   (packed into block-diagonal sequences when ``pack_locals``), dropout on;
3. the teacher on the globals under ``torch.no_grad()``, with dropout on
   when ``teacher_dropout`` (the reference's train-mode teacher);
4. the weighted center EMA, **before** the loss reads it;
5. the weighted loss, its backward, the optimizer, the teacher EMA toward the
   updated student, and ``dino_distribution_stats``.

It updates the :class:`~.state.TrainState` in place and returns
``{"loss", "dino_stats"}``. Four generators per step, from
``state.next_generators(4)``: student globals, student locals, teacher,
augmentation.

Gradient accumulation (``grad_accum > 1``: the JAX package's microbatching,
two-pass for DINO) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..data.device_augment import to_unit_float
from ..models.dino import momentum_update, update_center
from ..utils.metrics import dino_distribution_stats
from .state import Optimizer, SupervisedTrainState, TrainState


def _refuse_grad_accum(grad_accum: int) -> None:
    if grad_accum > 1:
        raise NotImplementedError(
            "grad_accum > 1 (microbatched gradient accumulation) is not "
            "ported yet; see ROADMAP.md queue A item 5"
        )


_CRITERIA = {
    "CrossEntropyLoss": "ce",
    "L1Loss": "l1",
    "MSELoss": "mse",
    "SmoothL1Loss": "smooth_l1",
}
# the criteria each training mode's step computes
_MODE_CRITERIA = {
    "supervised": ("ce",),
    "finetune": ("ce",),
    "simmim": ("l1", "mse", "smooth_l1"),
}


def make_criterion(config, mode: Optional[str] = None) -> str:
    """The short name of ``training.criterion.name`` (default
    CrossEntropyLoss), as ``vit_ssl_tpu/train/steps.py::make_criterion``
    gives it: an unknown name raises, and so does one that the mode's step
    does not compute (the supervised and finetune steps: cross-entropy)."""
    crit = config["training"].get("criterion", {}) or {}
    name = crit.get("name", "CrossEntropyLoss")
    if name not in _CRITERIA:
        raise ValueError(f"Unknown criterion '{name}'")
    key = _CRITERIA[name]
    mode = mode or str(config["training"].get("type", "")).lower()
    if mode in _MODE_CRITERIA and key not in _MODE_CRITERIA[mode]:
        raise ValueError(
            f"Criterion '{name}' is not supported by the {mode} train step; "
            f"supported: {sorted(_MODE_CRITERIA[mode])}")
    return key


def cross_entropy_loss(logits, labels, weight):
    """The weighted mean of fp32 softmax cross-entropy over integer labels
    (Σ w·ce / max(Σ w, 1)): padding rows of weight 0 drop out."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    w = weight.float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def make_supervised_steps(optimizer: Optimizer, augment_fn: Optional[Callable] = None,
                          grad_accum: int = 1):
    """Returns ``(train_step, eval_step)`` over a
    :class:`~.state.SupervisedTrainState`:

    - ``train_step(state, batch) -> dict`` (``with_grads=True`` adds the
      gradients by parameter name)
    - ``eval_step(state, batch) -> dict`` (no gradient, no dropout, no
      augmentation)

    ``batch`` holds ``"image"`` (B, H, W, C) uint8 or float, ``"label"``
    (B,) and ``"weight"`` (B,). Each returns ``{"loss", "weight_sum",
    "preds", "labels", "weight"}``. The JAX function's ``model`` and ``tx``
    are the state's model and ``optimizer`` here."""
    _refuse_grad_accum(grad_accum)

    def images(batch, generator):
        if augment_fn is not None:
            return augment_fn(generator, batch["image"])
        return to_unit_float(batch["image"])

    def outputs(logits, loss, batch):
        return {"loss": loss.detach(), "weight_sum": batch["weight"].sum(),
                "preds": logits.detach().argmax(dim=-1), "labels": batch["label"],
                "weight": batch["weight"]}

    def train_step(state: SupervisedTrainState, batch, with_grads: bool = False):
        g_dropout, g_augment = state.next_generators(2)
        logits = state.model(images(batch, g_augment), False, g_dropout)
        loss = cross_entropy_loss(logits, batch["label"], batch["weight"])
        params = optimizer.select(state.params)
        grads = torch.autograd.grad(loss, params)
        optimizer.update(params, grads, state.opt_state)
        state.step += 1
        out = outputs(logits, loss, batch)
        if with_grads:
            names = optimizer.select(n for n, _ in state.model.named_parameters())
            out["grads"] = dict(zip(names, grads))
        return out

    @torch.no_grad()
    def eval_step(state: SupervisedTrainState, batch):
        logits = state.model(to_unit_float(batch["image"]), True)
        return outputs(logits, cross_entropy_loss(logits, batch["label"],
                                                  batch["weight"]), batch)

    return train_step, eval_step


def weighted_dino_loss(t, s, center, teacher_temp: float, student_temp: float,
                       weight):
    """The DINO loss over teacher (Vt, B, K) and student (Vs, B, K) outputs
    with per-sample weights (B,): exact when all weights are 1."""
    t = t.detach().float()
    sp = F.log_softmax(s.float() / student_temp, dim=-1)
    tp = F.softmax((t - center[None]) / teacher_temp, dim=-1)
    per = -(tp * sp.sum(dim=0)[None])  # (Vt, B, K)
    w = weight.float()[None, :, None]
    return (per * w).sum() / torch.clamp(w.expand_as(per).sum(), min=1.0)


def make_dino_steps(optimizer: Optimizer, num_global_views: int, num_all_views: int,
                    student_temp: float, center_momentum: float,
                    teacher_dropout: bool = True,
                    view_fn: Optional[Callable] = None,
                    grad_accum: int = 1, pack_locals: bool = False):
    """Returns ``(train_step, eval_step)``:

    - ``train_step(state, batch, teacher_temp, teacher_momentum) -> dict``
      (``with_grads=True`` adds the student's gradients by parameter name)
    - ``eval_step(state, batch, teacher_temp) -> dict`` (no gradient, no
      dropout; it advances the center, as the reference's validation does)

    ``batch`` holds ``"weight"`` (B,) and either ``"image"`` (uint8, with
    ``view_fn``) or ``"views"`` (a sequence of ``num_all_views`` tensors,
    globals first). The JAX function's ``model`` and ``tx`` arguments are
    the state's networks and ``optimizer`` here."""
    _refuse_grad_accum(grad_accum)
    ng, na = num_global_views, num_all_views
    nl = na - ng

    def get_views(batch, generator):
        if view_fn is not None and "image" in batch:
            return view_fn(generator, batch["image"])
        return batch["views"]

    def outputs(state: TrainState, batch, gens, training: bool):
        """(teacher views (ng, B, K), student views (na, B, K), new center)."""
        g_student, g_locals, g_teacher, g_augment = gens
        views = get_views(batch, g_augment)
        globals_x = torch.cat(list(views[:ng]), dim=0)
        b = views[0].shape[0]
        student = state.student
        parts = [student(globals_x, not training, g_student)]
        if nl > 0:
            locals_x = torch.cat(list(views[ng:]), dim=0)
            if pack_locals:
                parts.append(student.forward_packed(locals_x, nl, not training,
                                                    g_locals))
            else:
                parts.append(student(locals_x, not training, g_locals))
        student_out = torch.cat(parts, dim=0)
        det_teacher = not (training and teacher_dropout)
        with torch.no_grad():
            t_g = state.teacher(globals_x, det_teacher,
                                None if det_teacher else g_teacher)
        k = t_g.shape[-1]
        new_center = update_center(state.center, t_g, center_momentum,
                                   batch["weight"].repeat(ng))
        return t_g.reshape(ng, b, k), student_out.reshape(na, b, k), new_center

    def train_step(state: TrainState, batch, teacher_temp: float,
                   teacher_momentum: float, with_grads: bool = False):
        t, s, new_center = outputs(state, batch, state.next_generators(4), True)
        loss = weighted_dino_loss(t, s, new_center, teacher_temp, student_temp,
                                  batch["weight"])
        params = optimizer.select(state.params)
        grads = torch.autograd.grad(loss, params)
        optimizer.update(params, grads, state.opt_state)
        momentum_update(state.teacher, state.student, teacher_momentum)
        stats = dino_distribution_stats(t, s.detach(), new_center, batch["weight"])
        state.center = new_center
        state.step += 1
        out = {"loss": loss.detach(), "dino_stats": stats}
        if with_grads:
            names = optimizer.select(n for n, _ in state.student.named_parameters())
            out["grads"] = dict(zip(names, grads))
        return out

    @torch.no_grad()
    def eval_step(state: TrainState, batch, teacher_temp: float):
        (g_augment,) = state.next_generators(1)  # a fixed augmentation stream
        t, s, new_center = outputs(state, batch, (None, None, None, g_augment),
                                   False)
        loss = weighted_dino_loss(t, s, new_center, teacher_temp, student_temp,
                                  batch["weight"])
        stats = dino_distribution_stats(t, s, new_center, batch["weight"])
        state.center = new_center
        return {"loss": loss, "dino_stats": stats}

    return train_step, eval_step

"""The DINO training and evaluation steps (port of
``vit_ssl_tpu/train/steps.py::make_dino_steps``, ``:429-692``).

One ``train_step`` runs, in order:

1. the views: ``view_fn(generator, batch["image"])`` (device
   augmentation from uint8 images) or the host's ``batch["views"]``;
2. the student on the concatenated global views and on the local views
   (packed into block-diagonal sequences when ``pack_locals``), dropout on;
3. the teacher on the globals under ``torch.no_grad()``, with dropout on
   when ``teacher_dropout`` (the reference's train-mode teacher);
4. the weighted center EMA, **before** the loss reads it;
5. the weighted loss, its backward, AdamW, the teacher EMA toward the
   updated student, and ``dino_distribution_stats``.

It updates the :class:`~.state.TrainState` in place and returns
``{"loss", "dino_stats"}``. Four generators per step, from
``state.next_generators(4)``: student globals, student locals, teacher,
augmentation.

Gradient accumulation (``grad_accum > 1``, the JAX package's two-pass
microbatching) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..models.dino import momentum_update, update_center
from ..utils.metrics import dino_distribution_stats
from .state import AdamW, TrainState


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


def make_dino_steps(optimizer: AdamW, num_global_views: int, num_all_views: int,
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
    if grad_accum > 1:
        raise NotImplementedError(
            "grad_accum > 1 (two-pass microbatching) is not ported yet; see "
            "ROADMAP.md queue A"
        )
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
        params = state.params
        grads = torch.autograd.grad(loss, params)
        optimizer.update(params, grads, state.opt_state)
        momentum_update(state.teacher, state.student, teacher_momentum)
        stats = dino_distribution_stats(t, s.detach(), new_center, batch["weight"])
        state.center = new_center
        state.step += 1
        out = {"loss": loss.detach(), "dino_stats": stats}
        if with_grads:
            names = [name for name, _ in state.student.named_parameters()]
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

"""The training and evaluation steps (port of ``vit_ssl_tpu/train/steps.py``):
the supervised steps (``make_supervised_steps``, ``:97-271``), the SimMIM
steps (``make_simmim_steps``, ``:279-426``) and the DINO steps
(``make_dino_steps``, ``:429-692``).

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

The SimMIM ``train_step`` draws three generators a step (dropout, mask,
augmentation), runs the masked forward, and takes the criterion (``l1``,
``mse`` or ``smooth_l1`` with β = 1) weighted by mask × sample weight over
Σw · C·p² (floored at 1), its backward and one optimizer update; PSNR and
SSIM ingredients come from the predictions clamped to [0, 1] against the
raw targets.

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

Data parallelism (a ``data`` axis in the published mesh,
:mod:`..parallel.context`): every normaliser is the global batch's (the
weight sums through :func:`~..parallel.context.dp_sum`), so the sum of the
ranks' gradients, which the optimizer wrapper takes
(:class:`~..parallel.data_parallel.DataParallelOptimizer`), is the global
batch's gradient; each rank's ``loss`` is its share of the global loss (the
trainers sum them). The dropout streams (dropout masks, patch-dropout
scores) fold the data rank in (``per_rank``); the augmentation's and the
mask's per-image draws are the rank's rows of the global batch's. DINO's
center and statistics are the global batch's too.

Gradient accumulation (``grad_accum > 1``) splits the batch into that many
contiguous microbatches (a batch it does not divide raises ``ValueError``),
each with its own generators (stream ``n·j + i`` of the step for stream i
of microbatch j), and updates once. Each microbatch's gradient is that of
the **unnormalised** weighted loss, summed in fp32 and divided once by the
whole batch's normaliser, so the update is the full batch's up to the
order of fp32 sums: Σw for the supervised step, Σ mask·w · C·p² for SimMIM
(its PSNR and SSIM sums added up), ng·K·Σw for DINO. DINO takes two
passes, as the JAX package: pass A runs the teacher on every microbatch and
updates the center once from the whole batch's teacher outputs; pass B
accumulates the student's loss against those outputs and the updated
center. Both passes draw the views of a microbatch from the same stream
state (the step's generators made twice), so they see the same views.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..data.device_augment import to_unit_float
from ..parallel.context import dp_size, dp_sum
from ..models.dino import momentum_update, update_center
from ..utils.metrics import dino_distribution_stats, psnr_stats, ssim_stats
from .state import Optimizer, SupervisedTrainState, TrainState


def microbatches(batch, grad_accum: int):
    """``batch`` cut into ``grad_accum`` contiguous microbatches along the
    batch axis (every tensor, and each tensor of a list such as
    ``"views"``); raises ``ValueError`` when the batch size is not a
    multiple of ``grad_accum``."""
    b = batch["weight"].shape[0]
    if b % grad_accum != 0:
        raise ValueError(f"batch size {b} must divide training.grad_accum_steps "
                         f"({grad_accum})")
    mb = b // grad_accum

    def cut(x, j):
        if isinstance(x, (list, tuple)):
            return [cut(v, j) for v in x]
        return x[j * mb:(j + 1) * mb]

    return [{k: cut(v, j) for k, v in batch.items()} for j in range(grad_accum)]


class _GradSum:
    """fp32 sums of microbatch gradients, divided once at the end."""

    def __init__(self, params):
        self.params = params
        self.sums = [torch.zeros_like(p, dtype=torch.float32) for p in params]

    def add(self, loss):
        grads = torch.autograd.grad(loss, self.params)
        torch._foreach_add_(self.sums, [g.float() for g in grads])

    def divided(self, denom):
        return [(s / denom).to(p.dtype) for s, p in zip(self.sums, self.params)]


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
    return (ce * w).sum() / torch.clamp(dp_sum(w.sum()), min=1.0)


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
    are the state's model and ``optimizer`` here. ``grad_accum`` > 1
    accumulates over microbatches (module docstring).

    A model with Mixture-of-Experts blocks (``moe_experts`` > 0): the
    router losses of its training forward are added to the training loss,
    and only there (not to ``eval_step``'s); under ``grad_accum`` each
    microbatch's is weighted by its weight sum before the one division, and
    capacity applies per microbatch, as in JAX. Without ``grad_accum`` the
    output also holds ``moe_dropped_frac``, the mean over MoE blocks of the
    share of routing assignments past capacity."""
    grad_accum = max(1, int(grad_accum))

    def images(batch, generator):
        if augment_fn is not None:
            return augment_fn(generator, batch["image"])
        return to_unit_float(batch["image"])

    def forward_train(model, x, generator):
        """(logits, MoE router loss, mean dropped share); zeros without MoE."""
        if int(getattr(model, "moe_experts", 0) or 0) > 0:
            return model(x, False, generator, return_aux=True)
        zero = torch.zeros((), device=x.device)
        return model(x, False, generator), zero, None

    def outputs(preds, loss, batch):
        return {"loss": loss.detach(), "weight_sum": batch["weight"].sum(),
                "preds": preds, "labels": batch["label"], "weight": batch["weight"]}

    def accumulated(state, params, batch):
        """(gradients, loss, predictions) over the microbatches."""
        gens = state.next_generators(2 * grad_accum, per_rank=range(0, 2 * grad_accum, 2))
        grads, loss_sum, preds = _GradSum(params), 0.0, []
        for j, micro in enumerate(microbatches(batch, grad_accum)):
            g_dropout, g_augment = gens[2 * j:2 * j + 2]
            logits, aux, _ = forward_train(state.model, images(micro, g_augment),
                                           g_dropout)
            ce = F.cross_entropy(logits.float(), micro["label"].long(), reduction="none")
            w = micro["weight"].float()
            loss = (ce * w).sum() + aux * w.sum()  # Σ w·ce + aux·Σw, no normaliser
            grads.add(loss)
            loss_sum = loss_sum + loss.detach()
            preds.append(logits.detach().argmax(dim=-1))
        w_total = torch.clamp(dp_sum(batch["weight"].float().sum()), min=1.0)
        return grads.divided(w_total), loss_sum / w_total, torch.cat(preds)

    def train_step(state: SupervisedTrainState, batch, with_grads: bool = False):
        params = optimizer.select(state.params)
        dropped = None
        if grad_accum > 1:
            grads, loss, preds = accumulated(state, params, batch)
        else:
            g_dropout, g_augment = state.next_generators(2, per_rank=(0,))
            logits, aux, dropped = forward_train(state.model,
                                                 images(batch, g_augment), g_dropout)
            # the router loss is a mean over routing groups: each data
            # rank's share of the global batch's mean
            loss = (cross_entropy_loss(logits, batch["label"], batch["weight"])
                    + aux / dp_size())
            grads = torch.autograd.grad(loss, params)
            preds = logits.detach().argmax(dim=-1)
        optimizer.update(params, grads, state.opt_state)
        state.step += 1
        out = outputs(preds, loss, batch)
        if dropped is not None:
            out["moe_dropped_frac"] = dropped.detach()
        if with_grads:
            names = optimizer.select(n for n, _ in state.model.named_parameters())
            out["grads"] = dict(zip(names, grads))
        return out

    @torch.no_grad()
    def eval_step(state: SupervisedTrainState, batch):
        logits = state.model(to_unit_float(batch["image"]), True)
        return outputs(logits.argmax(dim=-1), cross_entropy_loss(
            logits, batch["label"], batch["weight"]), batch)

    return train_step, eval_step


def reconstruction_error(preds, targets, criterion: str):
    """Elementwise fp32 error of a SimMIM criterion: |d|, d², or
    ``SmoothL1Loss`` with β = 1 (0.5·d² where |d| < 1, else |d| − 0.5)."""
    diff = preds.float() - targets.float()
    if criterion == "l1":
        return diff.abs()
    if criterion == "mse":
        return diff ** 2
    if criterion == "smooth_l1":
        absd = diff.abs()
        return torch.where(absd < 1.0, 0.5 * diff ** 2, absd - 0.5)
    raise ValueError(f"Unsupported SimMIM criterion '{criterion}'")


def make_simmim_steps(optimizer: Optimizer, patch_size: int, channels: int,
                      criterion: str = "l1", augment_fn: Optional[Callable] = None,
                      grad_accum: int = 1):
    """Returns ``(train_step, eval_step)`` over a
    :class:`~.state.SupervisedTrainState` whose model is a ``SimMIMViT``:

    - ``train_step(state, batch) -> dict`` (``with_grads=True`` adds the
      gradients by parameter name)
    - ``eval_step(state, batch, mask_generator) -> dict`` (no gradient,
      no dropout, no augmentation; the mask from ``mask_generator``)

    ``batch`` holds ``"image"`` (B, H, W, C) uint8 or float and
    ``"weight"`` (B,). Each returns ``{"loss", "psnr_sse", "psnr_count",
    "ssim_sum", "ssim_count"}``, the four sums over the masked patches
    weighted by the sample weights. The JAX function's ``model`` and ``tx``
    are the state's model and ``optimizer`` here."""
    grad_accum = max(1, int(grad_accum))
    if criterion not in _MODE_CRITERIA["simmim"]:
        raise ValueError(f"Unsupported SimMIM criterion '{criterion}'")

    def forward(state, batch, deterministic, g_dropout, g_mask, g_augment=None):
        """(Σ err·w, its normaliser Σw·C·p², the PSNR and SSIM sums)."""
        if augment_fn is not None and g_augment is not None:
            images = augment_fn(g_augment, batch["image"])
        else:
            images = to_unit_float(batch["image"])
        preds, targets, mask = state.model(images, deterministic, (g_dropout, g_mask))
        mask_w = mask.float() * batch["weight"].float()[:, None]
        err = reconstruction_error(preds, targets, criterion)
        w = mask_w[..., None]
        num, denom = (err * w).sum(), dp_sum(w.sum()) * err.shape[-1]
        with torch.no_grad():
            clamped = preds.detach().clamp(0.0, 1.0)  # the predictions only
            sse, cnt = psnr_stats(clamped, targets, w)
            ssim_sum, ssim_cnt = ssim_stats(clamped, targets, mask_w, patch_size,
                                            channels)
        return num, denom, {"psnr_sse": sse, "psnr_count": cnt,
                            "ssim_sum": ssim_sum, "ssim_count": ssim_cnt}

    def accumulated(state, params, batch):
        gens = state.next_generators(3 * grad_accum, per_rank=range(0, 3 * grad_accum, 3))
        grads, num_sum, denom_sum, stats = _GradSum(params), 0.0, 0.0, None
        for j, micro in enumerate(microbatches(batch, grad_accum)):
            num, denom, part = forward(state, micro, False, *gens[3 * j:3 * j + 3])
            grads.add(num)
            num_sum, denom_sum = num_sum + num.detach(), denom_sum + denom
            stats = part if stats is None else {k: stats[k] + v for k, v in part.items()}
        denom = torch.clamp(denom_sum, min=1.0)
        return grads.divided(denom), num_sum / denom, stats

    def train_step(state: SupervisedTrainState, batch, with_grads: bool = False):
        params = optimizer.select(state.params)
        if grad_accum > 1:
            grads, loss, stats = accumulated(state, params, batch)
        else:
            num, denom, stats = forward(state, batch, False,
                                        *state.next_generators(3, per_rank=(0,)))
            loss = num / torch.clamp(denom, min=1.0)
            grads = torch.autograd.grad(loss, params)
        optimizer.update(params, grads, state.opt_state)
        state.step += 1
        out = {"loss": loss.detach(), **stats}
        if with_grads:
            names = optimizer.select(n for n, _ in state.model.named_parameters())
            out["grads"] = dict(zip(names, grads))
        return out

    @torch.no_grad()
    def eval_step(state: SupervisedTrainState, batch, mask_generator: torch.Generator):
        num, denom, stats = forward(state, batch, True, None, mask_generator)
        return {"loss": num / torch.clamp(denom, min=1.0), **stats}

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
    return (per * w).sum() / torch.clamp(dp_sum(w.expand_as(per).sum()), min=1.0)


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
    the state's networks and ``optimizer`` here. ``grad_accum`` > 1 takes
    the two-pass microbatch path (module docstring)."""
    grad_accum = max(1, int(grad_accum))
    ng, na = num_global_views, num_all_views
    nl = na - ng

    def get_views(batch, generator):
        if view_fn is not None and "image" in batch:
            return view_fn(generator, batch["image"])
        return batch["views"]

    def student_outputs(student, views, training, g_student, g_locals):
        """The student on the globals, then the locals: (na·B, K)."""
        parts = [student(torch.cat(list(views[:ng]), dim=0), not training, g_student)]
        if nl > 0:
            locals_x = torch.cat(list(views[ng:]), dim=0)
            if pack_locals:
                parts.append(student.forward_packed(locals_x, nl, not training,
                                                    g_locals))
            else:
                parts.append(student(locals_x, not training, g_locals))
        return torch.cat(parts, dim=0)

    def teacher_outputs(state, views, training, g_teacher):
        """The teacher on the globals, no gradient: (ng·B, K)."""
        det_teacher = not (training and teacher_dropout)
        with torch.no_grad():
            return state.teacher(torch.cat(list(views[:ng]), dim=0), det_teacher,
                                 None if det_teacher else g_teacher)

    def outputs(state: TrainState, batch, gens, training: bool):
        """(teacher views (ng, B, K), student views (na, B, K), new center)."""
        g_student, g_locals, g_teacher, g_augment = gens
        views = get_views(batch, g_augment)
        b = views[0].shape[0]
        student_out = student_outputs(state.student, views, training, g_student,
                                      g_locals)
        t_g = teacher_outputs(state, views, training, g_teacher)
        k = t_g.shape[-1]
        new_center = update_center(state.center, t_g, center_momentum,
                                   batch["weight"].repeat(ng))
        return t_g.reshape(ng, b, k), student_out.reshape(na, b, k), new_center

    def by_view(parts, views):
        """Microbatch outputs (views·mb, K) each → (views, B, K) in batch
        order."""
        k = parts[0].shape[-1]
        stacked = torch.stack([p.reshape(views, -1, k) for p in parts], dim=1)
        return stacked.reshape(views, -1, k)

    def accumulated(state: TrainState, params, batch, teacher_temp: float):
        """(gradients, loss, teacher views, student views, new center)."""
        micro = microbatches(batch, grad_accum)
        dropout_streams = [4 * j + i for j in range(grad_accum) for i in range(3)]
        gens = state.next_generators(4 * grad_accum, per_rank=dropout_streams)
        t_parts = [teacher_outputs(state, get_views(m, gens[4 * j + 3]), True,
                                   gens[4 * j + 2]) for j, m in enumerate(micro)]
        t = by_view(t_parts, ng)
        new_center = update_center(state.center, t, center_momentum,
                                   batch["weight"].repeat(ng))
        # the same streams again: each microbatch's views are pass A's
        gens = state.next_generators(4 * grad_accum, per_rank=dropout_streams)
        grads, num_sum, s_parts = _GradSum(params), 0.0, []
        for j, m in enumerate(micro):
            g_student, g_locals, _, g_augment = gens[4 * j:4 * j + 4]
            views = get_views(m, g_augment)
            s_mb = student_outputs(state.student, views, True, g_student, g_locals)
            k = s_mb.shape[-1]
            sp = F.log_softmax(s_mb.float().reshape(na, -1, k) / student_temp, dim=-1)
            tp = F.softmax((t_parts[j].float().reshape(ng, -1, k) - new_center[None])
                           / teacher_temp, dim=-1)
            per = -(tp * sp.sum(dim=0)[None])  # (ng, mb, K)
            num = (per * m["weight"].float()[None, :, None]).sum()
            grads.add(num)
            num_sum = num_sum + num.detach()
            s_parts.append(s_mb.detach())
        k = t.shape[-1]
        denom = torch.clamp(dp_sum(ng * k * batch["weight"].float().sum()), min=1.0)
        return (grads.divided(denom), num_sum / denom, t, by_view(s_parts, na),
                new_center)

    def train_step(state: TrainState, batch, teacher_temp: float,
                   teacher_momentum: float, with_grads: bool = False):
        params = optimizer.select(state.params)
        if grad_accum > 1:
            grads, loss, t, s, new_center = accumulated(state, params, batch,
                                                        teacher_temp)
        else:
            t, s, new_center = outputs(state, batch,
                                       state.next_generators(4, per_rank=(0, 1, 2)), True)
            loss = weighted_dino_loss(t, s, new_center, teacher_temp, student_temp,
                                      batch["weight"])
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

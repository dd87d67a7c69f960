"""Learning-rate schedules (a jax-free copy of ``vit_ssl_tpu/train/schedules.py``).

The reference composes a per-step linear warmup with torch's
``CosineAnnealingLR`` stepped once per epoch after warmup, which telescopes
to ``eta_min + (target − eta_min)·(1 + cos(π·t/T))/2`` with t the completed
post-warmup epochs and T = num_epochs − warmup_epochs. Warmup step i
(0-based) trains at ``start + i/W·(target − start)``. Each schedule is a
function of the number of completed optimizer steps, evaluated in fp32 as
the JAX package evaluates it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def reference_lr_schedule(*, start_lr: float, target_lr: float, eta_min: float,
                          warmup_epochs: int, num_epochs: int,
                          steps_per_epoch: int,
                          granularity: str = "epoch") -> Callable[[int], float]:
    """Returns ``lr(step)``, step = completed optimizer steps."""
    f32 = np.float32
    warmup_steps = max(1, warmup_epochs * steps_per_epoch)
    t_max = max(1, num_epochs - warmup_epochs)

    def schedule(step) -> float:
        step = f32(step)
        if step < warmup_steps:
            frac = min(step, f32(warmup_steps)) / f32(warmup_steps)
            return float(f32(start_lr) + frac * (f32(target_lr) - f32(start_lr)))
        if granularity == "step":
            t = (step - f32(warmup_steps)) / f32(steps_per_epoch)
        else:
            # torch steps the cosine once per completed epoch after warmup
            epoch = np.floor(step / f32(steps_per_epoch)) + f32(1.0)
            t = max(epoch - f32(warmup_epochs) - f32(1.0), f32(0.0))
        t = min(t, f32(t_max))
        cos = np.cos(f32(np.pi) * t / f32(t_max), dtype=np.float32)
        return float(f32(eta_min) + (f32(target_lr) - f32(eta_min)) * f32(0.5)
                     * (f32(1.0) + cos))

    return schedule


def lr_schedule_from_config(config, steps_per_epoch: int) -> Callable[[int], float]:
    """The schedule from the reference config keys (``configs/base/training.yaml``)."""
    training = config["training"]
    sched_cfg = training.get("lr_scheduler", {}) or {}
    main = sched_cfg.get("main", {}) or {}
    eta_min = float((main.get("params", {}) or {}).get("eta_min", 0.0))
    return reference_lr_schedule(
        start_lr=float(training["warmup_initial_learning_rate"]),
        target_lr=float(training["warmup_final_learning_rate"]),
        eta_min=eta_min,
        warmup_epochs=int(training["warmup_epochs"]),
        num_epochs=int(training["num_epochs"]),
        steps_per_epoch=steps_per_epoch,
        granularity=str(sched_cfg.get("granularity", "epoch")),
    )

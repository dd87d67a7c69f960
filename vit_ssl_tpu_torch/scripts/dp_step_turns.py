"""The DINO ViT-S/8 train step (configs/dino.yaml) three ways, in turns on
one card: plain (no process group), data-parallel (an NCCL group of one
rank: the gradient all-reduce and the global weight sums) and with
``parallel.fsdp`` (the ZeRO-3 gather, reduce-scatter and release around
each step). Card only:

    python -m vit_ssl_tpu_torch.scripts.dp_step_turns

Prints, for each way:

- the warm step: host clock ending in a synchronise, median of 5 steps a
  turn, the turns in the order of ``ORDER`` (each way three times);
- the in-loop step: ``train_epoch`` over the DINO trainer phase's 1300
  in-memory images (1040 train: 9 steps an epoch), the median interval
  between step starts, the epochs in the order of ``LOOP_ORDER`` (each way
  twice), as ``chip_smoke.py``'s trainer phases read it;
- where the host time of a step goes: over 5 steps, the host time (no
  synchronise inside) of the step until it returns, and of each function a
  data-parallel step adds or changes, a step's mean and its calls; then the
  host functions that take the most own time in one step (``cProfile``).
"""

from __future__ import annotations

import contextlib
import cProfile
import io
import pstats
import socket
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import compose
from ..data.builder import make_loaders
from ..models import dino as dino_model
from ..models.builder import build_dino_network
from ..parallel import context as parallel_context
from ..parallel import data_parallel
from ..parallel.fsdp import ShardedState
from ..parallel.mesh import mesh_from_config
from ..train import steps as train_steps
from ..train.__main__ import get_trainer
from ..utils import metrics as train_metrics

CONFIGS = Path(__file__).resolve().parents[2] / "configs"
STEPS = 5
IMAGES = 1300
ORDER = ("plain", "dp", "fsdp", "fsdp", "dp", "plain", "plain", "dp", "fsdp")
LOOP_ORDER = ("plain", "dp", "fsdp", "fsdp", "dp", "plain")


class _Images:
    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None):
        return self.images[idx]


def _trainer(config, images):
    train, val = make_loaders(config, _Images(images))
    trainer = get_trainer("dino", build_dino_network(config, "cuda"), "/nonexistent",
                          config, train, val, "cuda")
    batch = trainer._put(next(iter(train)))
    return trainer, batch


def _step(trainer, batch):
    trainer.train_step(trainer.state, batch, trainer._teacher_temp(1),
                       trainer._teacher_momentum(1))


def _published(mesh):
    """The leg's mesh published (none for the plain leg)."""
    if mesh is None:
        return parallel_context.suspended()

    @contextlib.contextmanager
    def published():
        was = parallel_context.current_mesh()
        parallel_context.set_parallel_context(mesh)
        try:
            yield
        finally:
            parallel_context.set_parallel_context(was)

    return published()


def _timed(trainer, batch, mesh, steps):
    with _published(mesh):
        out = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _step(trainer, batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def _in_loop(trainer, mesh, epoch):
    """One ``train_epoch``: the median interval between step starts, ms."""
    starts = []
    step = trainer.train_step

    def counted(*args, **kwargs):
        starts.append(time.perf_counter())
        return step(*args, **kwargs)

    trainer.train_step = counted
    try:
        with _published(mesh), trainer.train_logger:
            torch.cuda.synchronize()
            trainer.train_epoch(epoch)
            torch.cuda.synchronize()
    finally:
        trainer.train_step = step
    return float(np.median(np.diff(starts) * 1e3)), len(starts)


class _HostTimers:
    """Host time and calls of named functions, wrapped where they are
    looked up; nested calls count in each wrapper they pass."""

    def __init__(self):
        self.ms = defaultdict(float)
        self.calls = defaultdict(int)
        self._undo = []

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[label] += (time.perf_counter() - t0) * 1e3
                self.calls[label] += 1

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def _host_breakdown(trainer, batch, mesh, steps=STEPS):
    """Per step: the host time until the step returns (no synchronise
    inside), its wall time to the synchronise, and each wrapped function's
    host time and calls."""
    timers = _HostTimers()
    inner = getattr(trainer.optimizer, "inner", trainer.optimizer)
    timers.wrap(inner, "update", "optimizer update (the inner AdamW)")
    timers.wrap(torch.autograd, "grad", "torch.autograd.grad (the backward)")
    for module in (train_steps, dino_model, train_metrics):
        timers.wrap(module, "dp_sum", "dp_sum (clone + all_reduce of a weight sum)")
    timers.wrap(data_parallel, "all_reduce_flat",
                "all_reduce_flat (cat, all_reduce, views)")
    if mesh is not None and isinstance(trainer._sharded, ShardedState):
        timers.wrap(ShardedState, "gather", "fsdp gather (resize, cat, all_gather, copies)")
        timers.wrap(ShardedState, "release", "fsdp release (resize to 0)")
        timers.wrap(ShardedState, "reduce", "fsdp reduce (cat, reduce_scatter, views)")
    returned, wall = [], []
    try:
        with _published(mesh):
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _step(trainer, batch)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                returned.append((t1 - t0) * 1e3)
                wall.append((time.perf_counter() - t0) * 1e3)
    finally:
        timers.restore()
    funcs = {k: (v / steps, timers.calls[k] / steps) for k, v in timers.ms.items()}
    return returned, wall, funcs


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_step_turns: no CUDA device; this script runs on the card")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    images = np.random.default_rng(5).integers(0, 256, (IMAGES, 96, 96, 3),
                                               dtype=np.uint8)
    plain, plain_batch = _trainer(compose(CONFIGS, "dino"), images)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        legs = {"plain": (plain, plain_batch, None)}
        for name, extra in (("dp", []), ("fsdp", ["parallel.fsdp=true"])):
            cfg = compose(CONFIGS, "dino", extra)
            mesh = mesh_from_config(cfg)
            parallel_context.set_parallel_context(mesh)
            trainer, batch = _trainer(cfg, images)
            legs[name] = (trainer, batch, mesh)
        parallel_context.set_parallel_context(None)
        print(f"== DINO ViT-S/8 train step, batch 128, plain / dp / fsdp in an NCCL "
              f"group of one rank, in turns; {card}", flush=True)
        for trainer, batch, mesh in legs.values():
            _timed(trainer, batch, mesh, 3)  # warm-up
        readings = {name: [] for name in legs}
        for name in ORDER:
            trainer, batch, mesh = legs[name]
            readings[name].append(float(np.median(_timed(trainer, batch, mesh, STEPS))))
        for name, values in readings.items():
            print(f"  {name}: warm step {np.median(values):.3f} ms (turns "
                  + " / ".join(f"{v:.3f}" for v in values) + f", median of {STEPS} "
                  f"steps each; host clock ending in torch.cuda.synchronize())", flush=True)

        loops = {name: [] for name in legs}
        epochs = defaultdict(int)
        for name in LOOP_ORDER:
            trainer, _, mesh = legs[name]
            epochs[name] += 1
            loops[name].append(_in_loop(trainer, mesh, epochs[name]))
        for name, values in loops.items():
            print(f"  {name}: in-loop step {np.median([v for v, _ in values]):.3f} ms "
                  "(epochs " + " / ".join(f"{v:.3f}" for v, _ in values)
                  + f"; median interval between the starts of an epoch's "
                  f"{values[0][1]} steps)", flush=True)

        for name, (trainer, batch, mesh) in legs.items():
            returned, wall, funcs = _host_breakdown(trainer, batch, mesh)
            print(f"  {name}: host time of a step until it returns "
                  f"{np.median(returned):.3f} ms ("
                  + " / ".join(f"{v:.3f}" for v in returned)
                  + f"), wall to the synchronise {np.median(wall):.3f} ms; per step "
                  "(mean of 5):", flush=True)
            for label, (ms, calls) in sorted(funcs.items(), key=lambda kv: -kv[1][0]):
                print(f"    {ms:9.3f} ms in {calls:g} calls: {label}", flush=True)
        for name, (trainer, batch, mesh) in legs.items():
            profiler = cProfile.Profile()
            with _published(mesh):
                profiler.enable()
                _step(trainer, batch)
                torch.cuda.synchronize()
                profiler.disable()
            text = io.StringIO()
            pstats.Stats(profiler, stream=text).sort_stats("tottime").print_stats(12)
            print(f"  {name}: one step under cProfile, by own time:", flush=True)
            print("\n".join("    " + line for line in text.getvalue().splitlines()
                            if line.strip()), flush=True)
    finally:
        parallel_context.set_parallel_context(None)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

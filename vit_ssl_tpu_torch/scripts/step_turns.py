"""The warm train steps of two checkouts, in turns on one card: DINO
ViT-S/8 (``chip_smoke.py``'s training phase: configs/dino.yaml, batch 128,
2 globals and 4 packed locals, dropout 0.1, device augmentation) and
ViT-B/16 at 384 px (its supervised phase: batch 64, dropout 0.1, the
unfused and the fused FFN). Card only:

    python -m vit_ssl_tpu_torch.scripts.step_turns OTHER_ROOT [--rounds N]

``OTHER_ROOT`` is another checkout of the repo (say a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each turn is a fresh process, pinned to the same ``CORES`` host cores as
every other turn (its own affinity), that builds the steps with that
root's own ``chip_smoke.py`` and package (its kernels built under that
root), takes ``WARMUP`` steps, then times ``STEPS`` steps: host clock
around each step ending in ``torch.cuda.synchronize()``, the median. The
turns run in the order other, this, this, other, ``--rounds`` times; the
script prints each turn's medians and, for each step, the median over each
root's turns and their ratio (this over other).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]
WARMUP = 2
STEPS = 20
CORES = 4
ORDER = ("other", "this", "this", "other")
MARK = "STEP_TURNS "


def _median(xs):
    xs = sorted(xs)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def _timed(step, torch) -> float:
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return _median(ms)


def worker() -> None:
    """One turn, in the root that is the working directory: each step's
    median ms, printed as one JSON line after ``MARK``."""
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:CORES])
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    from vit_ssl_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    out = {}
    state, step, batch = smoke.build_training(torch)
    temp, momentum = smoke.schedule_values()
    out["dino"] = _timed(lambda: step(state, batch, temp, momentum), torch)
    del state, step, batch
    for name, cfg in (("vit_b_384", smoke.VIT_B16_384),
                      ("vit_b_384_fused", smoke.VIT_B16_384_FUSED)):
        state, step, _, batch = smoke.build_supervised_training(torch, cfg)
        out[name] = _timed(lambda: step(state, batch), torch)
        del state, step, batch
        torch.cuda.empty_cache()
    print(MARK + json.dumps(out), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=Path, help="the other checkout's root")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("step_turns: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    roots = {"other": args.other.resolve(), "this": THIS_ROOT}
    readings = {"other": [], "this": []}
    for turn, which in enumerate(ORDER * args.rounds):
        env = dict(os.environ, PYTHONPATH=str(roots[which]))
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), str(roots["other"]), "--worker"],
            cwd=roots[which], env=env, capture_output=True, text=True)
        lines = [line for line in proc.stdout.splitlines() if line.startswith(MARK)]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"step_turns: turn {turn} ({which}) failed", file=sys.stderr)
            return 1
        row = json.loads(lines[-1][len(MARK):])
        readings[which].append(row)
        print(f"turn {turn} {which}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()),
              flush=True)
    summary = {}
    for name in readings["this"][0]:
        med = {w: _median([r[name] for r in readings[w]]) for w in readings}
        summary[name] = {**med, "ratio": med["this"] / med["other"]}
        print(f"{name}: other {med['other']:.3f} ms, this {med['this']:.3f} ms "
              f"({summary[name]['ratio']:.4f}x; medians of {len(readings['this'])} turns "
              f"of {STEPS} steps each)", flush=True)
    print(json.dumps({"step_turns": summary, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

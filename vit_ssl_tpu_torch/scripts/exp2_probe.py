"""Probe: does exp2 beat exp in kernel B2's forward on this card?

Port of ``scripts/exp2_probe.py::main``. Kernel P1
(``blockwise_fwd_exp2``) is B2's forward (``blockwise_fwd``) with log2 e
folded into the softmax scale, so that each exponential is one
``ex2.approx`` on the special-function unit, where B2's forward calls the
accurate ``expf``. For (8, 6, 2048, 64) and (4, 6, 4096, 64) in bf16 the
probe checks P1 against B2's forward (atol/rtol 3e-2, as the original
does) and times both with CUDA events, in turns (exp, exp2, exp2, exp),
beside the card's name and power limit. Run on a machine with an NVIDIA
GPU, from the root of a checkout:

    python -m vit_ssl_tpu_torch.scripts.exp2_probe
"""

from __future__ import annotations

import subprocess
import sys

import torch

SHAPES = [(8, 6, 2048, 64), (4, 6, 4096, 64)]
TOL = dict(atol=3e-2, rtol=3e-2)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds per call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def probe(shapes=SHAPES):
    """Per shape: P1's max |o - B2's o|, and the mean ms of each form, timed
    twice each in turns. Raises AssertionError if P1 disagrees."""
    from vit_ssl_tpu_torch.ops import flash_blockwise as fb

    rows = []
    for b, h, n, d in shapes:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(b, h, n, d, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        scale = d ** -0.5
        out, lse = fb.blockwise_attention_fwd_exp2(q, k, v, scale)
        ref, ref_lse = fb.blockwise_attention_fwd(q, k, v, scale)
        torch.testing.assert_close(out.float(), ref.float(), **TOL)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)

        def exp():
            return fb.blockwise_attention_fwd(q, k, v, scale)

        def exp2():
            return fb.blockwise_attention_fwd_exp2(q, k, v, scale)

        times = [cuda_ms(f) for f in (exp, exp2, exp2, exp)]
        rows.append({"shape": (b, h, n, d),
                     "max_abs_err": float((out.float() - ref.float()).abs().max()),
                     "exp_ms": (times[0], times[3]), "exp2_ms": (times[1], times[2])})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("exp2_probe: no CUDA device; this probe runs on the card", file=sys.stderr)
        return 1
    card = card_line()
    for row in probe():
        exp_ms, exp2_ms = min(row["exp_ms"]), min(row["exp2_ms"])
        print(f"{row['shape']} bf16 on {card}: exp (blockwise_fwd) "
              f"{row['exp_ms'][0]:.4f} / {row['exp_ms'][1]:.4f} ms, exp2 "
              f"(blockwise_fwd_exp2) {row['exp2_ms'][0]:.4f} / {row['exp2_ms'][1]:.4f} ms, "
              f"exp2/exp {exp2_ms / exp_ms:.3f}; max_abs_err {row['max_abs_err']:.3e} "
              f"(atol/rtol {TOL['atol']:g})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernel B3's bf16 forwards against those of another checkout, in turns.

Builds ``vit_ssl_tpu_torch/csrc/fused_attention.cu`` of another checkout
(``--other``, for example a parent commit unpacked with ``git archive``)
beside this checkout's library, both with ``kernels.NVCC_FLAGS``, and times
the two C entries ``fused_attention_fwd`` and ``fused_attention_fwd_stats``
of both on the same inputs with CUDA events, in turns (other, this, this,
other), beside SDPA on the same heads and the bound. Both are held against
the plain version (atol/rtol 1e-2) and against each other. Card only; run
from the root of a checkout:

    python -m vit_ssl_tpu_torch.scripts.b3_forward_turns --other DIR

Prints each time beside the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import flash_attention as fa
from vit_ssl_tpu_torch.scripts.exp2_probe import card_line, cuda_ms

SHAPE = (64, 12, 577, 64)  # ViT-B/16 at 384 px
ENTRIES = (fa.FUSED_KERNEL, fa.FUSED_KERNEL_TRAIN)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_BF16_OPS_PER_S = 989e12


def build_other(root: Path, out_dir: Path) -> ctypes.CDLL:
    """``root``'s B3 library, compiled into ``out_dir``."""
    src = root / "vit_ssl_tpu_torch" / "csrc" / "fused_attention.cu"
    lib = out_dir / "libfused_attention_other.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def entry_fn(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    pointers = 5 if name == fa.FUSED_KERNEL_TRAIN else 4
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def caller(fn, name, q, k, v, scale):
    """A no-argument call of one library's entry, on fresh outputs."""
    b, h, n, d = q.shape

    def call():
        out = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        stats = None
        if name == fa.FUSED_KERNEL_TRAIN:
            stats = torch.zeros(b, h, -(-n // 64) * 64, 2, device=q.device)
            ptrs.append(stats.data_ptr())
        err = fn(*ptrs, b, n, h, d, 1, scale, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        return out, stats
    return call


def bound_ms(b, h, n, d, stats: bool) -> float:
    moved = 4 * b * h * n * d * 2 + (b * h * n * 8 if stats else 0)
    ops = 4 * b * h * n * n * d
    return max(moved / HBM_BYTES_PER_S, ops / PEAK_BF16_OPS_PER_S) * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of the other checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("b3_forward_turns: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    card = card_line()
    b, h, n, d = SHAPE
    scale = 1.0 / d ** 0.5
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, h, n, d, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    ref = fa.fused_attention_reference(q, k, v, scale).float()
    this_lib = kernels.load(fa.FUSED_LIBRARY)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        other_lib = build_other(args.other.resolve(), Path(tmp))
        for name in ENTRIES:
            other = caller(entry_fn(other_lib, name), name, q, k, v, scale)
            this = caller(entry_fn(this_lib, name), name, q, k, v, scale)
            o_other, o_this = other()[0].float(), this()[0].float()
            torch.cuda.synchronize()
            errs = {"other_vs_plain": float((o_other - ref).abs().max()),
                    "this_vs_plain": float((o_this - ref).abs().max()),
                    "this_vs_other": float((o_this - o_other).abs().max())}
            ok = all(bool(((o - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all())
                     for o in (o_other, o_this))
            turns = [cuda_ms(fn) for fn in (other, this, this, other)]
            sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale))
            rows[name] = {"other_ms": [turns[0], turns[3]], "this_ms": [turns[1], turns[2]],
                          "sdpa_ms": sdpa,
                          "bound_ms": bound_ms(b, h, n, d, name == fa.FUSED_KERNEL_TRAIN),
                          "ratio": min(turns[1:3]) / min(turns[0], turns[3]),
                          "agree": ok, **errs}
            print(f"{card}: {name} at {SHAPE} bf16: other {turns[0]:.4f} / {turns[3]:.4f} "
                  f"ms, this {turns[1]:.4f} / {turns[2]:.4f} ms "
                  f"({rows[name]['ratio']:.3f}x), SDPA {sdpa:.4f} ms, bound "
                  f"{rows[name]['bound_ms']:.4f} ms; max_abs vs plain: other "
                  f"{errs['other_vs_plain']:.3e}, this {errs['this_vs_plain']:.3e}; "
                  f"{'ok' if ok else 'MISS'}", flush=True)
    print(json.dumps({"card": card, "shape": SHAPE, "entries": rows}), flush=True)
    return 0 if all(r["agree"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

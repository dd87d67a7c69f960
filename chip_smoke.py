#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (``vit_ssl_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device   — needs a CUDA device; prints the card's name and power limit
2. build    — compiles every kernel of the serving path from ``csrc/``
3. kernels  — each kernel against its plain PyTorch version on the card
4. serving  — a DINO ViT-S/8 ``Server`` at batch 128 through its
              ``forward_batch`` entry point: launch counts, agreement with
              the plain attention path, padding rows inert
5. times    — warm batch, kernel, plain and library times (CUDA events),
              and a ``torch.profiler`` breakdown of five serving batches
6. a JSON line describing every kernel, then the JSON ``ok`` line last.

Imports neither JAX nor the JAX package, and needs no PIL, OpenCV or YAML.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

# DINO ViT-S/8 as configs/dino.yaml composes it (configs/base/model.yaml,
# configs/dino/{model,data}.yaml); tests/test_torch_guards.py pins these
# values to the composed config.
DINO_VIT_S8 = {
    "training": {"type": "dino"},
    "model": {
        "in_channels": 3,
        "embed_dim": 384,
        "num_blocks": 6,
        "num_heads": 6,
        "mlp_dim": 1536,
        "patch_size": 8,
        "compute_dtype": "bfloat16",
        "output_dim": 16384,
    },
    "data": {"img_size": 96},
}
SERVE_BATCH = 128

# H100 SXM data sheet (700 W): memory rate and dense peaks by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# (batch, seq, heads, head_dim, dtype, block_size): the serving shape first
ATTENTION_CASES = [
    (128, 145, 6, 64, "bfloat16", 0),
    (128, 145, 6, 64, "float32", 0),
    (128, 148, 6, 64, "bfloat16", 37),
    (512, 37, 6, 64, "bfloat16", 0),
    (64, 197, 12, 64, "bfloat16", 0),
    (8, 1024, 6, 64, "bfloat16", 0),
    (16, 145, 12, 32, "bfloat16", 0),
    (16, 145, 12, 32, "float32", 0),
    (16, 148, 3, 128, "bfloat16", 37),
    (16, 148, 3, 128, "float32", 37),
    (4, 1, 6, 64, "bfloat16", 0),
    (4, 1, 6, 64, "float32", 0),
]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds per call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

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


def attention_bound(b, n, h, d, dtype, block_size):
    """(bound_ms, bound_by): the larger of bytes moved (q, k, v read once,
    o written once) over the memory rate and the two products' operations
    that these inputs need (only the unmasked block when block_size > 0)
    over the peak rate for the input type."""
    itemsize = 2 if dtype == "bfloat16" else 4
    bytes_ms = 4 * b * n * h * d * itemsize / HBM_BYTES_PER_S * 1e3
    keys = min(block_size, n) if block_size else n
    ops_ms = 4 * b * h * n * keys * d / PEAK_OPS_PER_S[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def qkv(b, n, h, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, n, h * d, generator=g, device="cuda").to(dtype)
            for _ in range(3)]


def phase_kernels(torch, fa):
    print("== kernels: attention_nhd_fwd against attention_nhd_reference", flush=True)
    for idx, (b, n, h, d, dtype_name, bs) in enumerate(ATTENTION_CASES):
        dtype = getattr(torch, dtype_name)
        xq, xk, xv = qkv(b, n, h, d, dtype, seed=idx)
        scale = 1.0 / d ** 0.5
        out = fa.attention_nhd(xq, xk, xv, h, scale, bs)
        torch.cuda.synchronize()
        ref = fa.attention_nhd_reference(xq, xk, xv, h, scale, bs)
        err = (out.float() - ref.float()).abs()
        max_err = float(err.max())
        if dtype == torch.bfloat16:
            tol = "atol 1e-2 rtol 1e-2"
            ok = bool((err <= 1e-2 + 1e-2 * ref.float().abs()).all())
        else:
            tol = "atol 1e-5"
            ok = max_err <= 1e-5
        ok = ok and bool(torch.isfinite(out).all())
        print(f"  ({b},{n},{h}x{d}) {dtype_name} block_size={bs}: "
              f"max_abs_err {max_err:.3e} ({tol}) {'ok' if ok else 'MISS'}",
              flush=True)
        if not ok:
            fail(f"attention_nhd_fwd disagrees at ({b},{n},{h}x{d}) {dtype_name}")


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain PyTorch version."""
    from vit_ssl_tpu_torch.ops import attention as attention_mod
    from vit_ssl_tpu_torch.ops.flash_attention import attention_nhd_reference

    kernel = attention_mod.attention_nhd
    attention_mod.attention_nhd = attention_nhd_reference
    try:
        yield
    finally:
        attention_mod.attention_nhd = kernel


def phase_serving(torch, tmp):
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.models import build_backbone
    from vit_ssl_tpu_torch.ops.flash_attention import KERNEL
    from vit_ssl_tpu_torch.serve import Server

    print("== serving: DINO ViT-S/8, batch 128, img 96 (N=145), bf16", flush=True)
    teacher = build_backbone(DINO_VIT_S8, "cpu").reset_parameters(
        torch.Generator().manual_seed(0))
    student = build_backbone(DINO_VIT_S8, "cpu").reset_parameters(
        torch.Generator().manual_seed(1))
    state = {f"teacher_backbone.{k}": v for k, v in teacher.state_dict().items()}
    state.update({f"student_backbone.{k}": v
                  for k, v in student.state_dict().items()})
    pth = f"{tmp}/dino_vit_s8.pth"
    torch.save({"model_state_dict": state, "config": DINO_VIT_S8, "epoch": 0}, pth)

    server = Server(pth, batch_size=SERVE_BATCH, device="cuda")
    img = DINO_VIT_S8["data"]["img_size"]
    x = np.random.default_rng(0).random((SERVE_BATCH, img, img, 3), np.float32)

    kernels.launches.clear()  # the main path's run starts here
    out = server.forward_batch(x)
    per_forward = kernels.launches[KERNEL]
    short = server.forward_batch(x[:37])
    main_launches = dict(kernels.launches)  # ... and ends here
    blocks = DINO_VIT_S8["model"]["num_blocks"]
    print(f"  launches: {main_launches} ({per_forward} in the first forward)",
          flush=True)
    if per_forward != blocks or main_launches.get(KERNEL) != 2 * blocks:
        fail(f"expected {blocks} attention launches per forward, got "
             f"{per_forward} then {main_launches.get(KERNEL)} in all")

    embed = DINO_VIT_S8["model"]["embed_dim"]
    if out.shape != (SERVE_BATCH, embed) or not np.isfinite(out).all():
        fail(f"embeddings {out.shape} not finite ({SERVE_BATCH}, {embed})")
    pad_err = float(np.abs(short - out[:37]).max())
    print(f"  padding: short batch of 37 vs full batch rows, max_abs_diff "
          f"{pad_err:.3e} (must be 0)", flush=True)
    if pad_err != 0.0:
        fail("zero-padding rows changed real rows")

    ref_model = teacher.to("cuda").eval()
    with plain_attention(), torch.inference_mode():
        ref = ref_model(torch.from_numpy(x).cuda()).float().cpu().numpy()
    if kernels.launches[KERNEL] != 2 * blocks:
        fail("the plain-attention reference run launched the kernel")
    cos = (out * ref).sum(1) / (np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
    max_err = float(np.abs(out - ref).max())
    limit = 2e-2 * float(np.abs(ref).max())
    print(f"  against plain attention on the card: min row cosine "
          f"{cos.min():.6f} (>= 0.999), max_abs_err {max_err:.3e} "
          f"(<= {limit:.3e})", flush=True)
    if cos.min() < 0.999 or max_err > limit:
        fail("serving embeddings disagree with the plain attention path")
    return server, x, main_launches


def phase_times(torch, server, x, card):
    import torch.nn.functional as F
    from vit_ssl_tpu_torch.ops import flash_attention as fa

    print(f"== times on {card}", flush=True)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        server.forward_batch(x)
        host.append(time.perf_counter() - t0)
    warm_ms = 1e3 * float(np.median(host))
    print(f"  serving: warm batch {warm_ms:.3f} ms median of 10 "
          f"({SERVE_BATCH / warm_ms * 1e3:.1f} img/s), host clock incl. "
          f"H2D/D2H; start-up warm batch {server.warm_s * 1e3:.3f} ms",
          flush=True)

    b, n, h, d, dtype_name, bs = ATTENTION_CASES[0]
    xq, xk, xv = qkv(b, n, h, d, getattr(torch, dtype_name), seed=100)
    scale = 1.0 / d ** 0.5
    kernel_ms = cuda_ms(lambda: fa.attention_nhd(xq, xk, xv, h, scale, bs))
    plain_ms = cuda_ms(lambda: fa.attention_nhd_reference(xq, xk, xv, h, scale, bs))

    def heads(t):  # views only: SDPA reads the (B, N, H·D) storage strided
        return t.view(b, n, h, d).transpose(1, 2)

    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        heads(xq), heads(xk), heads(xv), scale=scale))
    kernel_ms2 = cuda_ms(lambda: fa.attention_nhd(xq, xk, xv, h, scale, bs))
    bound_ms, bound_by = attention_bound(b, n, h, d, dtype_name, bs)
    print(f"  attention_nhd_fwd ({b},{n},{h}x{d}) {dtype_name}: kernel "
          f"{kernel_ms:.4f} / {kernel_ms2:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    f32 = [t.float() for t in (xq, xk, xv)]
    f32_ms = cuda_ms(lambda: fa.attention_nhd(*f32, h, scale, bs))
    f32_bound_ms, f32_bound_by = attention_bound(b, n, h, d, "float32", bs)
    print(f"  attention_nhd_fwd ({b},{n},{h}x{d}) float32 (CUDA cores): kernel "
          f"{f32_ms:.4f} ms, bound {f32_bound_ms:.4f} ms ({f32_bound_by})",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            server.forward_batch(x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side entries only (kernels, copies); CPU ops repeat their time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"  profile of 5 serving batches: wall {wall_ms:.3f} ms, device "
          f"busy {device_us / 1e3:.3f} ms, device idle share "
          f"{1 - device_us / 1e3 / wall_ms:.3f}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=14,
                       max_name_column_width=70), flush=True)
    return {"ms": min(kernel_ms, kernel_ms2), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from vit_ssl_tpu_torch import kernels
        from vit_ssl_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the vit_ssl_tpu_torch package is missing ({e}); "
              "run from the root of a checkout", file=sys.stderr)
        return 1

    # the plain versions are the yardstick: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"== device: {card} ({torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"== build: {sorted(kernels.SOURCES)} in {time.perf_counter() - t0:.1f} s "
          f"(compiled: {sorted(built)})", flush=True)
    for name in kernels.SOURCES:
        for line in kernels.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    phase_kernels(torch, fa)
    with tempfile.TemporaryDirectory() as tmp:
        server, x, main_launches = phase_serving(torch, tmp)
    stats = phase_times(torch, server, x, card)

    b, n, h, d, dtype_name, bs = ATTENTION_CASES[0]
    xq, xk, xv = qkv(b, n, h, d, getattr(torch, dtype_name), seed=200)
    ref = fa.attention_nhd_reference(xq, xk, xv, h, 1.0 / d ** 0.5, bs)
    out = fa.attention_nhd(xq, xk, xv, h, 1.0 / d ** 0.5, bs)
    max_abs_err = float((out.float() - ref.float()).abs().max())

    launches = main_launches.get(fa.KERNEL, 0)
    if launches == 0:
        fail(f"{fa.KERNEL} was not launched on the serving path")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": fa.KERNEL,
        "route": "cuda",
        "source": "vit_ssl_tpu_torch/csrc/attention_nhd_fwd.cu",
        "replaces": "vit_ssl_tpu/ops/flash_attention.py:352",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **stats,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A kernel's bf16 entries against those of another checkout, in turns.

Builds one kernel library of another checkout (``--other``, for example a
parent commit unpacked with ``git archive``) beside this checkout's, both
with ``kernels.NVCC_FLAGS``, and times the library's C entries of both on
the same inputs with CUDA events, in turns (other, this, this, other),
beside SDPA on the same heads and the bound. Each library is held to the
plain version, and the two libraries' outputs are compared bit for bit.
Two modes (``--kernel``):

- ``b3`` (the default): ``vit_ssl_tpu_torch/csrc/fused_attention.cu``,
  entries ``fused_attention_fwd``, ``fused_attention_fwd_stats`` and
  ``fused_attention_bwd`` at ViT-B/16's (64, 12, 577, 64) (SDPA's
  backward through autograd; both backwards are fed this checkout's
  statistics); a forward at atol/rtol 1e-2, each gradient within 2e-2 of
  max|plain|. Then the ViT-B/16 384-px training step of ``chip_smoke.py``,
  unfused and with ``model.use_fused_mlp=true``, with B3's entries routed
  to each library in the same turns.
- ``b2``: ``vit_ssl_tpu_torch/csrc/flash_blockwise_fwd.cu``, entries
  ``blockwise_fwd`` (B2's forward) and ``blockwise_fwd_exp2`` (P1) at
  ViT-B/16's (64, 12, 1025, 64) and at the exp2 probe's (8, 6, 2048, 64);
  o at atol/rtol 1e-2 of the plain version at ``KERNEL_BLOCK_K``, lse
  within 1e-5 of max|plain|. Then ``csrc/flash_blockwise_bwd.cu``'s
  ``blockwise_bwd_dq`` and ``blockwise_bwd_dkv`` at (64, 12, 1025, 64), fed
  this checkout's o and lse, each library's dq, dk and dv within 2e-2 of
  max|plain| (floored as ``chip_smoke.b2_grad_errs``), timed as C entries
  and through the wrappers routed to each library (a library without the
  Hopper backward takes the lse and delta unpadded: ``fb.stat_rows`` is
  routed too), beside SDPA's whole backward and the bounds. Then the
  ViT-B/16 512-px training step and a served batch (``chip_smoke.py``'s,
  batch 64), with all four of B2's entries routed to each library in the
  same turns.
- ``b1``: ``vit_ssl_tpu_torch/csrc/attention_nhd_fwd.cu``, entries
  ``attention_nhd_fwd`` (B1's inference forward) and
  ``attention_nhd_fwd_stats`` (its training forward) at DINO ViT-S/8's
  shapes on B1's (B, N, H·D) layout: a served batch (128, 145), the
  teacher's and the student globals' (256, 145), the packed locals (128,
  148, block 37); the output at atol/rtol 1e-2 of the plain version, the
  statistics within 1e-5 of max|plain|; SDPA on views of the same storage
  (a boolean block-diagonal mask at the locals); the two libraries'
  outputs compared bit for bit. Each entry is timed
  through ``chip_smoke.b1_bare`` (the C entry alone, on outputs allocated
  once), with each library's host microseconds a launch (its tensor maps
  encoded, if any, and the launch), and through its wrapper routed to
  each library, back to back (as ``chip_smoke.py``'s ``ms``).
  Then the DINO ViT-S/8 training step and a served DINO batch of 128
  (``chip_smoke.py``'s), with both forward entries routed to each library
  in the same turns.

Each step or batch turn gives the warm time (host clock, median of 10),
device busy a step or batch (``chip_smoke.profile_window`` over 3, which
must show that library's kernels by name) and peak memory. Each mode first
prints the registers and spills (``-Xptxas -v``) of both libraries' bf16
bodies. Card only; run from the root of a checkout (``chip_smoke.py`` is
imported from there):

    python -m vit_ssl_tpu_torch.scripts.b3_turns --other DIR [--kernel b2|b1]

Prints each time beside the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import flash_attention as fa
from vit_ssl_tpu_torch.ops import flash_blockwise as fb
from vit_ssl_tpu_torch.scripts.exp2_probe import card_line, cuda_ms

SHAPE = (64, 12, 577, 64)  # ViT-B/16 at 384 px
B2_SHAPES = [(64, 12, 1025, 64), (8, 6, 2048, 64)]  # ViT-B/16 at 512 px; the exp2 probe's
ENTRIES = (fa.FUSED_KERNEL, fa.FUSED_KERNEL_TRAIN, fa.FUSED_KERNEL_BWD)
B2_ENTRIES = (fb.KERNEL, fb.KERNEL_EXP2)
B1_ENTRIES = (fa.KERNEL, fa.KERNEL_TRAIN)
# DINO ViT-S/8's B1 forwards, (batch, seq, heads, head_dim, block_size,
# entries): a served batch; the teacher (inference) and the student
# globals (training); the packed locals (training)
B1_SHAPES = [(128, 145, 6, 64, 0, (fa.KERNEL,)),
             (256, 145, 6, 64, 0, (fa.KERNEL, fa.KERNEL_TRAIN)),
             (128, 148, 6, 64, 37, (fa.KERNEL_TRAIN,))]
B2_BWD_ENTRIES = (fb.KERNEL_DQ, fb.KERNEL_DKV)
POINTERS = {fa.FUSED_KERNEL: 4, fa.FUSED_KERNEL_TRAIN: 5, fa.FUSED_KERNEL_BWD: 9,
            fb.KERNEL: 5, fb.KERNEL_EXP2: 5, fa.KERNEL: 4, fa.KERNEL_TRAIN: 5,
            fb.KERNEL_DQ: 9, fb.KERNEL_DKV: 8}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_BF16_OPS_PER_S = 989e12
GRAD_REL_TOL = 2e-2  # bf16: p and ds round on both sides
LSE_REL_TOL = 1e-5
# the routed entries' bf16 kernels, the Hopper bodies and the mma.sync
# bodies they replaced: a profile of a step on a library must show by name
# those that library's binary holds
BODIES = {"b3": ("attention_bwd_dq_sm90_kernel", "attention_bwd_dkv_sm90_kernel",
                 "attention_bwd_dq_bf16_kernel", "attention_bwd_dkv_bf16_kernel"),
          "b2": ("blockwise_fwd_sm90_kernel", "blockwise_fwd_bf16_kernel",
                 "blockwise_bwd_dq_sm90_kernel", "blockwise_bwd_dkv_sm90_kernel",
                 "blockwise_dq_bf16_kernel", "blockwise_dkv_bf16_kernel"),
          "b1": ("attention_fwd_onepass_sm90_kernel", "attention_fwd_bf16_kernel")}
STEPS = 10  # timed steps a turn, as chip_smoke.TIMED_STEPS
TURNS = ("other", "this", "this", "other")


def build_other(root: Path, out_dir: Path, library: str = fa.FUSED_LIBRARY) -> ctypes.CDLL:
    """``root``'s kernel library ``library``, compiled into ``out_dir``;
    the compiler's log beside it."""
    src = root / "vit_ssl_tpu_torch" / kernels.SOURCES[library]
    lib = out_dir / f"lib{library}_other.so"
    done = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
                          check=True, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(done.stdout + done.stderr)
    return ctypes.CDLL(str(lib))


def print_registers(card: str, libs: dict) -> None:
    """``-Xptxas -v``'s lines of each library's bf16 bodies (Hopper and
    mma.sync), for both checkouts."""
    import chip_smoke

    for who, by_name in libs.items():
        for name, lib in by_name.items():
            log = Path(lib._name).with_suffix(".log")
            if who == "this":
                log = kernels.log_path(name)
            for line in chip_smoke.ptxas_lines(log.read_text(), kernels.nvcc_path()):
                if "sm90_kernel" in line or "bf16_kernel" in line:
                    print(f"{card}: {who} {name}: {line}", flush=True)


def _libs(lib) -> list:
    return list(lib.values()) if isinstance(lib, dict) else [lib]


def bodies_in(libs: dict, kernel: str) -> dict:
    """Per checkout, the names of ``BODIES[kernel]`` that its libraries'
    binaries hold."""
    found = {who: tuple(name for name in BODIES[kernel]
                        if any(name.encode() in Path(x._name).read_bytes()
                               for x in _libs(lib)))
             for who, lib in libs.items()}
    for who, names in found.items():
        if not names:
            raise RuntimeError(f"the {who} library holds none of {BODIES[kernel]}")
    return found


def takes_padded_stats(lib: ctypes.CDLL) -> bool:
    """Whether a ``flash_blockwise_bwd`` library's bf16 entries take the lse
    and delta padded to ``fb.STATS_ROWS`` rows a head (the Hopper backward)
    or unpadded (the mma.sync bodies before it)."""
    return b"blockwise_bwd_dq_sm90_kernel" in Path(lib._name).read_bytes()


def entry_fn(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    block_size = [ctypes.c_int] if name in B1_ENTRIES else []
    fn.argtypes = ([ctypes.c_void_p] * POINTERS[name] + [ctypes.c_int] * 5
                   + [ctypes.c_float, *block_size, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def caller(fn, name, q, k, v, do, stats, scale):
    """A no-argument call of one library's entry, on fresh outputs; returns
    the output (B3's forwards), (o, lse) (B2's) or (dq, dk, dv). B2's
    backward entries take ``stats`` = (o, the lse as that library takes it,
    delta of as many rows): dq fills delta, dk/dv reads it."""
    b, h, n, d = q.shape
    rows = -(-n // fa.STATS_ROWS) * fa.STATS_ROWS

    def call():
        if name == fb.KERNEL_DQ:
            o, lse, delta = stats
            outs = [torch.empty_like(q)]
            ptrs = [q, k, v, o, do, lse, None, outs[0], delta]
        elif name == fb.KERNEL_DKV:
            _, lse, delta = stats
            outs = [torch.empty_like(q), torch.empty_like(q)]
            ptrs = [q, k, v, do, lse, delta, *outs]
        elif name == fa.FUSED_KERNEL_BWD:
            outs = [torch.empty_like(q) for _ in range(3)]
            delta = torch.zeros(b, h, rows, device=q.device)
            ptrs = [q, k, v, do, stats, *outs, delta]
        elif name in B2_ENTRIES:
            outs = [torch.empty_like(q), torch.empty(b, h, n, device=q.device)]
            ptrs = [q, k, v, *outs]
        else:
            outs = [torch.empty_like(q)]
            ptrs = [q, k, v, *outs]
            if name == fa.FUSED_KERNEL_TRAIN:
                ptrs.append(torch.zeros(b, h, rows, 2, device=q.device))
        err = fn(*(x if x is None else x.data_ptr() for x in ptrs), b, n, h, d, 1, scale,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        return outs
    return call


def bound_ms(b, h, n, d, name) -> float:
    """The least time for the entry's work: q, k, v (and do) read, its
    outputs and statistics written, over the memory rate, against its
    products (two forward, five backward) over the bf16 peak."""
    act = b * h * n * d * 2
    moved, products = {fa.FUSED_KERNEL: (4 * act, 2),
                       fa.FUSED_KERNEL_TRAIN: (4 * act + b * h * n * 8, 2),
                       fa.FUSED_KERNEL_BWD: (7 * act + b * h * n * 8, 5),
                       fb.KERNEL: (4 * act + b * h * n * 4, 2),
                       fb.KERNEL_EXP2: (4 * act + b * h * n * 4, 2)}[name]
    ops = products * 2 * b * h * n * n * d
    return max(moved / HBM_BYTES_PER_S, ops / PEAK_BF16_OPS_PER_S) * 1e3


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def errors(name, got, want):
    """Each output's max |got - want| (forwards; B2's lse over max |want|)
    or max |got - want| over max |want| (gradients), and whether all are
    within their bar."""
    if name == fa.FUSED_KERNEL_BWD:
        errs = [_rel(g, w) for g, w in zip(got, want)]
        return errs, max(errs) <= GRAD_REL_TOL
    o, ref = got[0].float(), want[0].float()
    errs = [float((o - ref).abs().max())]
    ok = bool(((o - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all())
    if name in B2_ENTRIES:
        errs.append(_rel(got[1], want[1]))
        ok = ok and errs[1] <= LSE_REL_TOL
    return errs, ok


@contextlib.contextmanager
def routed(lib, module=fa, entries=ENTRIES):
    """Within the block, ``module``'s launches of ``entries`` call
    ``lib``'s (a library, or a dict of them by entry). A B2 backward
    library that takes the lse and delta unpadded gets them so:
    ``fb.stat_rows`` is routed too."""
    fns = {name: entry_fn(lib[name] if isinstance(lib, dict) else lib, name)
           for name in entries}
    base, rows = module._kernel_fn, fb.stat_rows
    module._kernel_fn = lambda entry: fns[entry] if entry in fns else base(entry)
    bwd = [lib[name] if isinstance(lib, dict) else lib
           for name in entries if name in B2_BWD_ENTRIES]
    if module is fb and bwd and not takes_padded_stats(bwd[0]):
        fb.stat_rows = lambda n, dtype: n
    try:
        yield
    finally:
        module._kernel_fn, fb.stat_rows = base, rows


def _timed_steps(step):
    """Warm-up, then (median host ms of STEPS calls of ``step`` ending in a
    synchronize, their outputs, peak GB)."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host_ms, outs = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        outs.append(step())
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(host_ms)), outs, torch.cuda.max_memory_allocated() / 1e9


def step_turns(card: str, libs: dict) -> dict:
    """The ViT-B/16 384-px training step, unfused and fused, with B3's
    entries on each library in turns (other, this, this, other): warm step
    ms, device busy ms a step and peak GB, and whether every loss was
    finite."""
    import chip_smoke  # the checkout's root, on sys.path under python -m

    rows = {}
    for leg, cfg in (("unfused", chip_smoke.VIT_B16_384),
                     ("fused", chip_smoke.VIT_B16_384_FUSED)):
        rows[leg] = _training_turns(card, libs, lambda: supervised_step(cfg),
                                    f"ViT-B/16 384 px {leg}", fa, ENTRIES,
                                    bodies_in(libs, "b3"))
    return rows


def supervised_step(cfg):
    """A no-argument training step of ``cfg`` (``chip_smoke.py``'s
    supervised state and batch)."""
    import chip_smoke

    state, train_step, _, batch = chip_smoke.build_supervised_training(torch, cfg)
    return lambda: train_step(state, batch)


def dino_step():
    """A no-argument DINO ViT-S/8 training step (``chip_smoke.py``'s state,
    batch and first-step schedule values)."""
    import chip_smoke

    state, train_step, batch = chip_smoke.build_training(torch)
    teacher_temp, teacher_momentum = chip_smoke.schedule_values()
    return lambda: train_step(state, batch, teacher_temp, teacher_momentum)


def _training_turns(card, libs, build, label, module, entries, want):
    """The training step that ``build()`` returns, with ``entries`` of
    ``module`` routed to each library in turns."""
    import chip_smoke

    step = build()
    turns = []
    for who in TURNS:
        with routed(libs[who], module, entries):
            warm_ms, outs, peak_gb = _timed_steps(step)
            losses = [float(out["loss"]) for out in outs]

            def three_steps():
                for _ in range(3):
                    step()

            _, busy_ms = chip_smoke.profile_window(
                torch, three_steps, f"3 {label} training steps, {who} library",
                rows=4, want=want[who])
        turns.append({"library": who, "warm_step_ms": warm_ms,
                      "device_busy_ms": busy_ms / 3, "peak_gb": peak_gb,
                      "finite": bool(np.isfinite(losses).all())})
        print(f"{card}: {label} training, {who} library: warm step {warm_ms:.3f} ms "
              f"median of {STEPS}, device busy {busy_ms / 3:.2f} ms a step, peak "
              f"{peak_gb:.2f} GB; losses "
              f"{'finite' if turns[-1]['finite'] else 'NOT FINITE'}", flush=True)
    del step
    torch.cuda.empty_cache()
    return turns


def _serving_turns(card, libs, server, x, label, module, entries, want, batches):
    """``server``'s batch ``x`` with ``entries`` of ``module`` routed to each
    library in turns; device busy from a profile of ``batches`` batches."""
    import chip_smoke

    turns = []
    for who in TURNS:
        with routed(libs[who], module, entries):
            warm_ms, outs, peak_gb = _timed_steps(lambda: server.forward_batch(x))

            def profiled():
                for _ in range(batches):
                    server.forward_batch(x)

            _, busy_ms = chip_smoke.profile_window(
                torch, profiled, f"{batches} {label}es, {who} library", rows=4,
                want=want[who])
        turns.append({"library": who, "warm_batch_ms": warm_ms,
                      "device_busy_ms": busy_ms / batches, "peak_gb": peak_gb,
                      "finite": bool(all(np.isfinite(out).all() for out in outs))})
        print(f"{card}: {label} of {len(x)}, {who} library: warm batch {warm_ms:.3f} "
              f"ms median of {STEPS}, device busy {busy_ms / batches:.3f} ms a batch, "
              f"peak {peak_gb:.2f} GB; outputs "
              f"{'finite' if turns[-1]['finite'] else 'NOT FINITE'}", flush=True)
    return turns


def b2_step_turns(card: str, libs: dict) -> dict:
    """The ViT-B/16 512-px training step (B2's forward, dq and dk/dv) and a
    served batch of 64 (its forward) with B2's entries on each checkout's
    libraries in turns (other, this, this, other): warm ms, device busy ms
    and peak GB; whether every loss and logit was finite."""
    import chip_smoke
    from vit_ssl_tpu_torch.serve import Server

    cfg = chip_smoke.VIT_B16_512
    want = bodies_in(libs, "b2")
    rows = {"training": _training_turns(card, libs, lambda: supervised_step(cfg),
                                        "ViT-B/16 512 px", fb, B2_ENTRIES + B2_BWD_ENTRIES,
                                        want)}
    want = {who: tuple(name for name in names if "fwd" in name) for who, names in want.items()}
    batch, img = cfg["training"]["batch_size"], cfg["data"]["img_size"]
    with tempfile.TemporaryDirectory() as tmp:
        pth = f"{tmp}/vit_b16_{img}.pth"
        model = chip_smoke.build_vit_model(torch, 5, cfg)
        torch.save({"model_state_dict": model.state_dict(), "config": cfg, "epoch": 0}, pth)
        del model
        server = Server(pth, batch_size=batch, device="cuda")
    x = np.random.default_rng(5).random((batch, img, img, 3), np.float32)
    rows["serving"] = _serving_turns(card, libs, server, x, "ViT-B/16 512-px served batch",
                                     fb, B2_ENTRIES, want, batches=3)
    return rows


def entry_turns(card, shape, entries, libs, plain, library):
    """Each entry of both libraries at ``shape``: held to ``plain``, timed
    in turns beside SDPA (``library``) and the bound."""
    b, h, n, d = shape
    rows = {}
    for name in entries:
        other = caller(entry_fn(libs["other"], name), name, *plain["inputs"])
        this = caller(entry_fn(libs["this"], name), name, *plain["inputs"])
        got_other, got_this = other(), this()
        torch.cuda.synchronize()
        errs_other, ok_other = errors(name, got_other, plain[name])
        errs_this, ok_this = errors(name, got_this, plain[name])
        same = all(torch.equal(a, c) for a, c in zip(got_other, got_this))
        turns = [cuda_ms(fn) for fn in (other, this, this, other)]
        sdpa = cuda_ms(library[name])
        rows[name] = {"other_ms": [turns[0], turns[3]], "this_ms": [turns[1], turns[2]],
                      "sdpa_ms": sdpa, "bound_ms": bound_ms(b, h, n, d, name),
                      "ratio": min(turns[1:3]) / min(turns[0], turns[3]),
                      "agree": ok_other and ok_this, "bit_equal": same,
                      "other_vs_plain": errs_other, "this_vs_plain": errs_this}
        kind = {fa.FUSED_KERNEL_BWD: "dq/dk/dv rel_err", fb.KERNEL: "o max_abs/lse rel_err",
                fb.KERNEL_EXP2: "o max_abs/lse rel_err"}.get(name, "max_abs")
        print(f"{card}: {name} at {shape} bf16: other {turns[0]:.4f} / {turns[3]:.4f} "
              f"ms, this {turns[1]:.4f} / {turns[2]:.4f} ms "
              f"({rows[name]['ratio']:.3f}x), SDPA {sdpa:.4f} ms, bound "
              f"{rows[name]['bound_ms']:.4f} ms; {kind} vs plain: other "
              + "/".join(f"{e:.3e}" for e in errs_other) + ", this "
              + "/".join(f"{e:.3e}" for e in errs_this)
              + f"; outputs {'bit-equal' if same else 'differ'} between the libraries; "
              + ("ok" if rows[name]["agree"] else "MISS"), flush=True)
    return rows


def b3_main(card, built):
    b, h, n, d = SHAPE
    scale = 1.0 / d ** 0.5
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    _, stats = fa.fused_attention_fwd_stats(q, k, v, scale)
    plain = {"inputs": (q, k, v, do, stats, scale),
             fa.FUSED_KERNEL: [fa.fused_attention_reference(q, k, v, scale)],
             fa.FUSED_KERNEL_BWD: fa.fused_attention_bwd_reference(q, k, v, do, scale)}
    plain[fa.FUSED_KERNEL_TRAIN] = plain[fa.FUSED_KERNEL]
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    library = {
        fa.FUSED_KERNEL: lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale),
        fa.FUSED_KERNEL_BWD: lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                                         retain_graph=True),
    }
    library[fa.FUSED_KERNEL_TRAIN] = library[fa.FUSED_KERNEL]
    libs = {who: by_name[fa.FUSED_LIBRARY] for who, by_name in built.items()}
    rows = entry_turns(card, SHAPE, ENTRIES, libs, plain, library)
    return {"shape": SHAPE, "entries": rows, "steps": step_turns(card, libs)}


def b1_entry_turns(card, libs):
    """B1's two forward entries of both libraries at each B1_SHAPES shape:
    held to the plain version, device and host times in turns, beside SDPA
    and the bound."""
    import chip_smoke

    rows = {}
    for b, n, h, d, bs, entries in B1_SHAPES:
        scale = 1.0 / d ** 0.5
        g = torch.Generator(device="cuda").manual_seed(0)
        xq, xk, xv = (torch.randn(b, n, h * d, generator=g, device="cuda").to(torch.bfloat16)
                      for _ in range(3))
        ref = fa.attention_nhd_reference(xq, xk, xv, h, scale, bs)
        ref_stats = fa.attention_nhd_stats_reference(xq, xk, h, scale, bs)
        heads = [x.view(b, n, h, d).transpose(1, 2) for x in (xq, xk, xv)]
        mask = None
        if bs:
            block = torch.arange(n, device="cuda") // bs
            mask = block[:, None] == block[None, :]
        for name in entries:
            calls = {who: chip_smoke.b1_bare(torch, fa, name, xq, xk, xv, h, scale, bs,
                                             entry_fn(lib, name))
                     for who, lib in libs.items()}
            got = {who: [x.clone() for x in call()] for who, call in calls.items()}
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(got["other"], got["this"]))
            errs, agree = {}, True
            for who, outs in got.items():
                o = outs[0].float()
                errs[who] = [float((o - ref.float()).abs().max())]
                agree = agree and bool(((o - ref.float()).abs()
                                        <= 1e-2 + 1e-2 * ref.float().abs()).all())
                if name == fa.KERNEL_TRAIN:
                    errs[who].append(_rel(outs[1][:, :, :n], ref_stats))
                    agree = agree and errs[who][1] <= chip_smoke.STATS_REL_TOL
            turns = [cuda_ms(calls[who]) for who in TURNS]
            hosts = [chip_smoke.host_us(calls[who]) for who in TURNS]
            wrapper = {fa.KERNEL: fa.attention_nhd_fwd,
                       fa.KERNEL_TRAIN: fa.attention_nhd_fwd_stats}[name]
            wrapped = []
            for who in TURNS:
                with routed(libs[who], fa, B1_ENTRIES):
                    wrapped.append(cuda_ms(lambda: wrapper(xq, xk, xv, h, scale, bs)))
            sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                *heads, attn_mask=mask, scale=scale))
            bound = (chip_smoke.attention_bound(b, n, h, d, "bfloat16", bs)
                     if name == fa.KERNEL else
                     chip_smoke.attention_train_bounds(b, n, h, d, "bfloat16", bs)["fwd"])
            key = f"{name} ({b}, {n}, {h}x{d}, bs {bs})"
            rows[key] = {"other_ms": [turns[0], turns[3]], "this_ms": [turns[1], turns[2]],
                         "other_host_us": [hosts[0], hosts[3]],
                         "this_host_us": [hosts[1], hosts[2]],
                         "other_wrapper_ms": [wrapped[0], wrapped[3]],
                         "this_wrapper_ms": [wrapped[1], wrapped[2]], "sdpa_ms": sdpa,
                         "bound_ms": bound[0], "bound_by": bound[1],
                         "ratio": min(turns[1:3]) / min(turns[0], turns[3]),
                         "agree": agree, "bit_equal": same, "other_vs_plain": errs["other"],
                         "this_vs_plain": errs["this"], "form": fa.attention_nhd_form(n)}
            print(f"{card}: {key} bf16 ({fa.attention_nhd_form(n)}): other "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, this {turns[1]:.4f} / "
                  f"{turns[2]:.4f} ms ({rows[key]['ratio']:.3f}x); through the wrapper, back "
                  f"to back: other {wrapped[0]:.4f} / {wrapped[3]:.4f} ms, this "
                  f"{wrapped[1]:.4f} / {wrapped[2]:.4f} ms; SDPA{' (mask)' if bs else ''} "
                  f"{sdpa:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); host a launch: "
                  f"other {hosts[0]:.2f} / {hosts[3]:.2f} us, this {hosts[1]:.2f} / "
                  f"{hosts[2]:.2f} us; o max_abs"
                  + ("/stats rel_err" if name == fa.KERNEL_TRAIN else "")
                  + " vs plain: other " + "/".join(f"{e:.3e}" for e in errs["other"])
                  + ", this " + "/".join(f"{e:.3e}" for e in errs["this"])
                  + f"; outputs {'bit-equal' if same else 'differ'} between the libraries"
                  + ("; ok" if agree else "; MISS"), flush=True)
        del xq, xk, xv, ref, heads
    return rows


def b1_step_turns(card: str, libs: dict) -> dict:
    """The DINO ViT-S/8 training step and a served batch of 128 with B1's
    forward entries on each library in turns (other, this, this, other):
    warm ms, device busy ms and peak GB; whether every loss and embedding
    was finite."""
    import chip_smoke
    from vit_ssl_tpu_torch.serve import Server

    want = bodies_in(libs, "b1")
    rows = {"training": _training_turns(card, libs, dino_step, "DINO ViT-S/8", fa,
                                        B1_ENTRIES, want)}
    with tempfile.TemporaryDirectory() as tmp:
        pth = f"{tmp}/dino_vit_s8.pth"
        chip_smoke.write_checkpoint(torch, chip_smoke.DINO_VIT_S8, pth)
        server = Server(pth, batch_size=chip_smoke.SERVE_BATCH, device="cuda")
    img = chip_smoke.DINO_VIT_S8["data"]["img_size"]
    x = np.random.default_rng(0).random((chip_smoke.SERVE_BATCH, img, img, 3), np.float32)
    rows["serving"] = _serving_turns(card, libs, server, x, "served DINO batch", fa,
                                     B1_ENTRIES, want, batches=5)
    return rows


def b1_main(card, built):
    libs = {who: by_name[fa.KERNEL] for who, by_name in built.items()}
    return {"entries": b1_entry_turns(card, libs), "steps": b1_step_turns(card, libs)}


def b2_bwd_turns(card, libs):
    """B2's two backward entries of both checkouts at (64, 12, 1025, 64),
    fed this checkout's o and lse: each library's dq, dk and dv against the
    plain version (``chip_smoke.b2_grad_errs``), timed in turns as C
    entries and through the wrappers, beside SDPA's whole backward and the
    bounds."""
    import chip_smoke

    b, h, n, d = B2_SHAPES[0]
    scale = 1.0 / d ** 0.5
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fb.blockwise_attention_fwd(q, k, v, scale)
    want = fb.blockwise_attention_bwd_reference(q, k, v, out, lse, do, scale)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    sdpa = chip_smoke.cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                                          retain_graph=True))
    bounds = chip_smoke.blockwise_bounds(b, h, n, d, "bfloat16")
    calls, deltas, errs, outs = {}, {}, {}, {}
    for who, by_entry in libs.items():
        lib = by_entry[fb.KERNEL_DQ]
        rows = fb.stat_rows(n, q.dtype) if takes_padded_stats(lib) else n
        stats = (out, fb.pad_rows(lse, rows, float("inf")),
                 torch.zeros(b, h, rows, device="cuda"))
        calls[who] = {name: caller(entry_fn(lib, name), name, q, k, v, do, stats, scale)
                      for name in B2_BWD_ENTRIES}
        dq = calls[who][fb.KERNEL_DQ]()[0]
        outs[who] = [dq, *calls[who][fb.KERNEL_DKV]()]
        errs[who] = chip_smoke.b2_grad_errs(q, k, v, do, scale, outs[who], want)
        with routed(by_entry, fb, B2_BWD_ENTRIES):
            deltas[who] = fb.blockwise_attention_bwd_dq(q, k, v, out, lse, do, scale)[1]
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(outs["other"], outs["this"]))
    result = {}
    for name, part in ((fb.KERNEL_DQ, "dq"), (fb.KERNEL_DKV, "dkv")):
        bare = [chip_smoke.cuda_ms(calls[who][name]) for who in TURNS]
        through = []
        for who in TURNS:
            with routed(libs[who], fb, B2_BWD_ENTRIES):
                if name == fb.KERNEL_DQ:
                    through.append(chip_smoke.cuda_ms(
                        lambda: fb.blockwise_attention_bwd_dq(q, k, v, out, lse, do, scale)))
                else:
                    through.append(chip_smoke.cuda_ms(
                        lambda: fb.blockwise_attention_bwd_dkv(q, k, v, do, lse, deltas[who],
                                                               scale)))
        result[name] = {"other_ms": [bare[0], bare[3]], "this_ms": [bare[1], bare[2]],
                        "other_wrapper_ms": [through[0], through[3]],
                        "this_wrapper_ms": [through[1], through[2]],
                        "ratio": min(bare[1:3]) / min(bare[0], bare[3]),
                        "sdpa_whole_backward_ms": sdpa, "bound_ms": bounds[part][0],
                        "bound_by": bounds[part][1]}
        print(f"{card}: {name} at {B2_SHAPES[0]} bf16, C entry: other {bare[0]:.4f} / "
              f"{bare[3]:.4f} ms, this {bare[1]:.4f} / {bare[2]:.4f} ms "
              f"({result[name]['ratio']:.3f}x); through the wrapper: other "
              f"{through[0]:.4f} / {through[3]:.4f} ms, this {through[1]:.4f} / "
              f"{through[2]:.4f} ms; SDPA's whole backward {sdpa:.4f} ms, bound "
              f"{bounds[part][0]:.4f} ms ({bounds[part][1]})", flush=True)
    pair = {who: [result[fb.KERNEL_DQ][f"{who}_ms"][i] + result[fb.KERNEL_DKV][f"{who}_ms"][i]
                  for i in range(2)] for who in ("other", "this")}
    agree = all(max(e) <= GRAD_REL_TOL for e in errs.values())
    print(f"{card}: the backward pair as C entries: other {pair['other'][0]:.4f} / "
          f"{pair['other'][1]:.4f} ms, this {pair['this'][0]:.4f} / {pair['this'][1]:.4f} "
          f"ms; dq/dk/dv rel_err vs plain: other "
          + "/".join(f"{e:.3e}" for e in errs["other"]) + ", this "
          + "/".join(f"{e:.3e}" for e in errs["this"])
          + f"; outputs {'bit-equal' if same else 'differ'} between the libraries; "
          + ("ok" if agree else "MISS"), flush=True)
    result.update({"pair_ms": pair, "errors": errs, "agree": agree, "bit_equal": same})
    return result


def b2_main(card, built):
    # per checkout, each of B2's entries' library
    libs = {who: {**{name: by_name[fb.FWD_LIBRARY] for name in B2_ENTRIES},
                  **{name: by_name[fb.BWD_LIBRARY] for name in B2_BWD_ENTRIES}}
            for who, by_name in built.items()}
    shapes = {}
    for shape in B2_SHAPES:
        b, h, n, d = shape
        scale = 1.0 / d ** 0.5
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(b, h, n, d, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        plain = {"inputs": (q, k, v, None, None, scale),
                 fb.KERNEL: fb.blockwise_attention_reference(q, k, v, scale,
                                                             fb.KERNEL_BLOCK_K),
                 fb.KERNEL_EXP2: fb.blockwise_attention_exp2_reference(q, k, v, scale,
                                                                       fb.KERNEL_BLOCK_K)}
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, scale=scale)
        rows = entry_turns(card, shape, B2_ENTRIES,
                           {who: by_name[fb.FWD_LIBRARY] for who, by_name in built.items()},
                           plain, {fb.KERNEL: sdpa, fb.KERNEL_EXP2: sdpa})
        ratios = {who: min(rows[fb.KERNEL_EXP2][f"{who}_ms"]) / min(rows[fb.KERNEL][f"{who}_ms"])
                  for who in ("other", "this")}
        print(f"{card}: exp2/exp at {shape}: other {ratios['other']:.3f}, this "
              f"{ratios['this']:.3f}", flush=True)
        shapes[str(shape)] = {"entries": rows, "exp2_over_exp": ratios}
        del q, k, v, plain
    return {"shapes": shapes, "backward": b2_bwd_turns(card, libs),
            "steps": b2_step_turns(card, libs)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of the other checkout")
    parser.add_argument("--kernel", choices=("b3", "b2", "b1"), default="b3",
                        help="b3: fused_attention's three entries and the 384-px step; "
                             "b2: blockwise_fwd and blockwise_fwd_exp2, the 512-px step "
                             "and served batch; b1: attention_nhd_fwd and "
                             "attention_nhd_fwd_stats, the DINO step and served batch")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("b3_turns: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    # as chip_smoke.py runs the plain versions and the steps: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    libraries, run = {"b3": ((fa.FUSED_LIBRARY,), b3_main),
                      "b2": ((fb.FWD_LIBRARY, fb.BWD_LIBRARY), b2_main),
                      "b1": ((fa.KERNEL,), b1_main)}[args.kernel]
    with tempfile.TemporaryDirectory() as tmp:
        built = {"other": {name: build_other(args.other.resolve(), Path(tmp), name)
                           for name in libraries},
                 "this": {name: kernels.load(name) for name in libraries}}
        print_registers(card, built)
        result = {"card": card, "kernel": args.kernel, **run(card, built)}
    print(json.dumps(result), flush=True)
    entries = ([s["entries"] for s in result["shapes"].values()] if args.kernel == "b2"
               else [result["entries"]])
    legs = [leg for leg in result["steps"].values()]
    backward_ok = result["backward"]["agree"] if args.kernel == "b2" else True
    return 0 if (all(r["agree"] for rows in entries for r in rows.values()) and backward_ok
                 and all(t["finite"] for leg in legs for t in leg)) else 1


if __name__ == "__main__":
    sys.exit(main())

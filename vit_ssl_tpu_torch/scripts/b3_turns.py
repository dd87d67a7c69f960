"""A kernel's bf16 entries against those of another checkout, in turns.

Builds one kernel library of another checkout (``--other``, for example a
parent commit unpacked with ``git archive``) beside this checkout's, both
with ``kernels.NVCC_FLAGS``, and times the library's C entries of both on
the same inputs with CUDA events, in turns (other, this, this, other),
beside SDPA on the same heads and the bound. Each library is held to the
plain version, and the two libraries' outputs are compared bit for bit.
The modes (``--kernel``):

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
  each library, back to back (as ``chip_smoke.py``'s ``ms``). Then
  ``csrc/attention_nhd_bwd.cu``'s ``attention_nhd_bwd`` (B1's backward) at
  the two training shapes, both libraries fed this checkout's statistics:
  dq, dk and dv within 2e-2 of max|plain|, compared bit for bit, timed as
  C entries and through the wrapper in turns, beside SDPA's backward
  (``chip_smoke.sdpa_backward_ms``) and the bound. Then the DINO ViT-S/8
  training step (all three B1 entries routed) and a served DINO batch of
  128 (both forwards routed), ``chip_smoke.py``'s, with each library in
  the same turns.
- ``p2``: ``vit_ssl_tpu_torch/csrc/masked_matmul.cu``, entries
  ``masked_mm_fwd`` and ``masked_mm_bwd`` (kernel P2) at the probe's
  T = 37120, 1536 -> 384 and ViT-B/16's T = 36928, 3072 -> 768: each
  library within 2e-2 of max|plain| per output, timed as C entries (device
  ms and host us a launch) and through the wrappers in turns, beside the
  ``where`` + ``F.linear`` pair and the bound. Then the dropout-epilogue
  probe's check and its ``epilogue`` leg with both entries routed to each
  library in turns, beside its ``xla`` leg, and the probe's verdict with
  each. Then B4's three entries (``fused_mlp_fwd.cu``,
  ``fused_mlp_bwd.cu``, built from each checkout: they share the product
  body that P2's operand masking extends) in bf16 and fp32, and P2's fp32
  entries, compared bit for bit between the libraries; with the SASS
  comparison below, which must find B4's Hopper kernels unchanged, and no
  Hopper kernel of either checkout that spills, serialises its wgmma or
  (B4's) takes more than 112 registers.

Each step or batch turn gives the warm time (host clock, median of 10),
device busy a step or batch (``chip_smoke.profile_window`` over 3, which
must show that library's kernels by name) and peak memory. Each mode first
prints the registers and spills (``-Xptxas -v``) of both libraries' bf16
bodies, and whether each Hopper kernel that both libraries hold has the
same SASS (``cuobjdump -sass``) in both. Card only; run from the root of a
checkout (``chip_smoke.py`` is imported from there):

    python -m vit_ssl_tpu_torch.scripts.b3_turns --other DIR [--kernel b2|b1|b4|p2]

Prints each time beside the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import difflib
import json
import re
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
from vit_ssl_tpu_torch.ops import fused_mlp as fm
from vit_ssl_tpu_torch.ops import masked_matmul as mm
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
# DINO ViT-S/8's B1 backwards, (batch, seq, heads, head_dim, block_size):
# the student globals, the packed locals
B1_BWD_SHAPES = [(256, 145, 6, 64, 0), (128, 148, 6, 64, 37)]
POINTERS = {fa.FUSED_KERNEL: 4, fa.FUSED_KERNEL_TRAIN: 5, fa.FUSED_KERNEL_BWD: 9,
            fb.KERNEL: 5, fb.KERNEL_EXP2: 5, fa.KERNEL: 4, fa.KERNEL_TRAIN: 5,
            fa.KERNEL_BWD: 9, fb.KERNEL_DQ: 9, fb.KERNEL_DKV: 8}
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
          "b1": ("attention_fwd_onepass_sm90_kernel", "attention_fwd_bf16_kernel"),
          # B4's wgmma/TMA kernels, and the mma.sync row and weight kernels
          # they replaced
          "b4": (*dict.fromkeys(b for bodies in fm.HOPPER_BODIES.values() for b in bodies),
                 "mlp_rows_bf16", "mlp_weights_bf16"),
          # P2's wgmma/TMA kernels, and the mma.sync product and weight
          # kernels they replaced
          "p2": (*(b for bodies in mm.HOPPER_BODIES.values() for b in bodies),
                 "masked_mm_bf16", "mlp_weights_bf16")}
B4_ENTRIES = (fm.KERNEL, fm.KERNEL_TRAIN, fm.KERNEL_BWD)
P2_ENTRIES = (mm.KERNEL, mm.KERNEL_BWD)
# the libraries whose Hopper kernels' SASS the b4 mode compares: B1's, B3's
# and B2's, which share sm90_common.cuh with B4's bodies
ATTENTION_LIBRARIES = (fa.KERNEL, fa.KERNEL_BWD, fa.FUSED_LIBRARY, fb.FWD_LIBRARY,
                       fb.BWD_LIBRARY)
# the float32 B4 cases and the P2 cases compared bit for bit between the
# libraries: (T, d_model, d_ff) and (T, d_ff, d_out)
B4_F32_CASES = [(5365, 384, 1536), (70, 768, 3072)]
P2_CASES = [(37120, 1536, 384), (5365, 1536, 384)]
# the p2 mode: P2's timed shapes, (T, d_ff, d_out): the probe's (DINO
# student globals) and ViT-B/16's FFN at 384 px; B4's bf16 cases compared
# bit for bit, (T, d_model, d_ff, keep-mask)
P2_TIMED = [(37120, 1536, 384), (36928, 3072, 768)]
B4_BF16_CASES = [(37120, 384, 1536, True), (18560, 384, 1536, False), (70, 768, 3072, True),
                 (12608, 1024, 4096, False)]
REGISTERS_TWO_BLOCKS = 112  # a thread's registers with two blocks of 288 an SM
# B1's bf16 backward kernels, by form: the mma.sync body that
# attention_bwd_sm90.cuh replaced, and its two forms
B1_BWD_BODIES = {"mma.sync": ("attention_bwd_dq_bf16_kernel", "attention_bwd_dkv_bf16_kernel"),
                 **{form: fa.BACKWARD_BODIES[form] for form in ("resident", "streamed")}}
STEPS = 10  # timed steps a turn, as chip_smoke.TIMED_STEPS
TURNS = ("other", "this", "this", "other")


def build_others(root: Path, out_dir: Path, libraries) -> dict:
    """``root``'s kernel libraries ``libraries``, compiled into ``out_dir``,
    one nvcc each, all at once; each compiler's log beside its library."""
    procs = {}
    for library in libraries:
        src = root / "vit_ssl_tpu_torch" / kernels.SOURCES[library]
        lib = out_dir / f"lib{library}_other.so"
        procs[library] = (lib, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for library, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            raise RuntimeError(f"the other checkout's {library} failed to build:\n{out}")
        built[library] = ctypes.CDLL(str(lib))
    return built


def print_registers(card: str, libs: dict) -> None:
    """``-Xptxas -v``'s lines of each library's bf16 bodies (Hopper and
    mma.sync: a kernel named ``*sm90*`` or ``*bf16*``), for both
    checkouts."""
    import chip_smoke

    for who, by_name in libs.items():
        for name, lib in by_name.items():
            log = Path(lib._name).with_suffix(".log")
            if who == "this":
                log = kernels.log_path(name)
            for line in chip_smoke.ptxas_lines(log.read_text(), kernels.nvcc_path()):
                kernel = line.split(": ")[0]
                if "sm90" in kernel or "bf16" in kernel:
                    print(f"{card}: {who} {name}: {line}", flush=True)


def sass_functions(path: str) -> dict:
    """``cuobjdump -sass`` of a library: each Hopper kernel (namespace
    ``sm90``) by its mangled name past that namespace -> its instructions
    (opcode and operands). nvcc names the anonymous namespace around
    ``sm90`` after the source file, so that part of every name is
    dropped."""
    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", path], check=True, capture_output=True,
                         text=True).stdout
    anon = re.compile(r"_ZN\d+_GLOBAL__N__\w+?4sm90")
    found = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        if "4sm90" in name and "sm90_kernel" in name:
            # "/*0040*/ OPCODE operands ; /* encoding */": the instruction
            found[name.strip().split("4sm90", 1)[1]] = [
                anon.sub("sm90", line.split("*/", 1)[1].split(";")[0].strip())
                for line in body.splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
    return found


def _loop_lines(code: list) -> list:
    """The instructions from a kernel's first wgmma to its last, register
    and predicate numbers and branch targets set aside."""
    marks = [i for i, x in enumerate(code) if "GMMA" in x]
    if not marks:
        return []
    lines = []
    for x in code[marks[0]:marks[-1] + 1]:
        x = re.sub(r"\b(U?R\d+|U?P\d|B\d)\b", "#", x).replace(".reuse", "")
        if re.match(r"(@!?#\s+)?(BRA|BSSY|CALL|JMP|BRX)", x):
            x = re.sub(r"0x[0-9a-f]+", "@", x)
        lines.append(x)
    return lines


def print_sass(card: str, libs: dict) -> dict:
    """For each library that both checkouts build, whether each Hopper
    kernel that both hold has the same SASS in both; where it does not,
    the two instruction counts and how many instructions differ from the
    first wgmma to the last once register numbers and branch targets are
    set aside (0: the main loop is the same, the prologue or epilogue
    differs). Returns, by library, the kernels both hold and those whose
    SASS differs."""
    found = {}
    for name in sorted(libs["this"].keys() & libs["other"].keys()):
        this, other = (sass_functions(libs[who][name]._name) for who in ("this", "other"))
        both = sorted(this.keys() & other.keys())
        same = [f for f in both if this[f] == other[f]]
        print(f"{card}: {name}: {len(same)} of {len(both)} Hopper kernels in both libraries "
              f"have the same SASS", flush=True)
        found[name] = {"both": len(both), "differ": [f for f in both if f not in same]}
        for f in both:
            if f in same:
                continue
            a, b = _loop_lines(other[f]), _loop_lines(this[f])
            diff = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in
                       difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
                       if tag != "equal")
            kernel, _, args = re.sub(r"^\d+", "", f).partition("I")
            args = ", ".join(re.findall(r"L[ib](\d+)E", args.split("Ev")[0]))
            print(f"  SASS differs: {kernel}<{args}>: {len(other[f])} instructions other, "
                  f"{len(this[f])} this; "
                  f"{diff} of {len(b)} differ from the first wgmma to the last", flush=True)
    return found


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
    block_size = [ctypes.c_int] if name in (*B1_ENTRIES, fa.KERNEL_BWD) else []
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


def has_b4_hopper(lib: ctypes.CDLL) -> bool:
    """Whether a B4 library holds the wgmma/TMA bodies (its forward entries
    then take the scratch h) or the mma.sync row kernel before them."""
    return re.search(rb"mlp_\w+_sm90_kernel", Path(lib._name).read_bytes()) is not None


def b4_entry(lib: ctypes.CDLL, name: str):
    """B4's C entry ``name`` of ``lib``, called as this checkout's wrapper
    calls it: a forward entry of a library without the Hopper bodies takes
    no scratch h, so the wrapper's (None: ``routed`` routes
    ``fm._scratch_h``) is dropped."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name)
    pointers = {fm.KERNEL: 7, fm.KERNEL_TRAIN: 8, fm.KERNEL_BWD: 14}[name]
    scratch = name != fm.KERNEL_BWD and has_b4_hopper(lib)
    fn.argtypes = [p] * (pointers + scratch) + [i] * 4 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    if scratch or name == fm.KERNEL_BWD:
        return fn
    return lambda *args: fn(*args[:pointers], *args[pointers + 1:])


def library_entry(lib: ctypes.CDLL, name: str):
    """Entry ``name`` of ``lib`` with the argtypes its wrapper passes."""
    if name in B4_ENTRIES:
        return b4_entry(lib, name)
    if name in P2_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * (8 if name == mm.KERNEL_BWD else 5)
                       + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn
    return entry_fn(lib, name)


@contextlib.contextmanager
def routed(lib, module=fa, entries=ENTRIES):
    """Within the block, ``module``'s launches of ``entries`` call
    ``lib``'s (a library, or a dict of them by entry). A B2 backward
    library that takes the lse and delta unpadded gets them so:
    ``fb.stat_rows`` is routed too; a B4 forward library without the Hopper
    bodies gets no scratch h: ``fm._scratch_h`` is routed too."""
    def of(name):
        return lib[name] if isinstance(lib, dict) else lib

    fns = {name: library_entry(of(name), name) for name in entries}
    base, rows, scratch = module._kernel_fn, fb.stat_rows, fm._scratch_h
    module._kernel_fn = lambda entry: fns[entry] if entry in fns else base(entry)
    bwd = [of(name) for name in entries if name in B2_BWD_ENTRIES]
    if module is fb and bwd and not takes_padded_stats(bwd[0]):
        fb.stat_rows = lambda n, dtype: n
    fwd = [of(name) for name in entries if name in (fm.KERNEL, fm.KERNEL_TRAIN)]
    if module is fm and fwd and not has_b4_hopper(fwd[0]):
        fm._scratch_h = lambda x, d_ff: None
    try:
        yield
    finally:
        module._kernel_fn, fb.stat_rows, fm._scratch_h = base, rows, scratch


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


def dino_step(cfg=None):
    """A no-argument DINO ViT-S/8 training step (``chip_smoke.py``'s state,
    batch and first-step schedule values; ``cfg``: its config,
    ``chip_smoke.DINO_VIT_S8`` by default)."""
    import chip_smoke

    state, train_step, batch = chip_smoke.build_training(torch, cfg or chip_smoke.DINO_VIT_S8)
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
                                             entry_fn(lib[name], name))
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


def b1_bwd_turns(card, libs):
    """B1's backward entry of both libraries at each B1_BWD_SHAPES shape,
    fed this checkout's statistics: dq, dk and dv against the plain
    version, compared bit for bit, timed in turns as C entries
    (``chip_smoke.b1_bare``; device ms, and host microseconds a launch: the
    tensor maps encoded, if any, and the two launches) and through the
    wrapper, beside SDPA's backward and the bound."""
    import chip_smoke

    rows = {}
    for b, n, h, d, bs in B1_BWD_SHAPES:
        scale = 1.0 / d ** 0.5
        g = torch.Generator(device="cuda").manual_seed(0)
        xq, xk, xv, do = (torch.randn(b, n, h * d, generator=g, device="cuda")
                          .to(torch.bfloat16) for _ in range(4))
        _, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, scale, bs)
        want = fa.attention_nhd_bwd_reference(xq, xk, xv, do, h, scale, bs)
        calls = {who: chip_smoke.b1_bare(torch, fa, fa.KERNEL_BWD, xq, xk, xv, h, scale, bs,
                                         entry_fn(lib[fa.KERNEL_BWD], fa.KERNEL_BWD),
                                         grad=(do, stats))
                 for who, lib in libs.items()}
        got = {who: [x.clone() for x in call()] for who, call in calls.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got["other"], got["this"]))
        errs = {who: [_rel(x, w) for x, w in zip(outs, want)] for who, outs in got.items()}
        agree = all(max(e) <= GRAD_REL_TOL for e in errs.values())
        bare = [cuda_ms(calls[who]) for who in TURNS]
        hosts = [chip_smoke.host_us(calls[who]) for who in TURNS]
        through = []
        for who in TURNS:
            with routed(libs[who], fa, (fa.KERNEL_BWD,)):
                through.append(cuda_ms(
                    lambda: fa.attention_nhd_bwd(xq, xk, xv, do, stats, h, scale, bs)))
        sdpa = chip_smoke.sdpa_backward_ms(torch, xq, xk, xv, do, h, scale, bs)
        bound = chip_smoke.attention_train_bounds(b, n, h, d, "bfloat16", bs)["bwd"]
        key = f"{fa.KERNEL_BWD} ({b}, {n}, {h}x{d}, bs {bs})"
        rows[key] = {"other_ms": [bare[0], bare[3]], "this_ms": [bare[1], bare[2]],
                     "other_host_us": [hosts[0], hosts[3]],
                     "this_host_us": [hosts[1], hosts[2]],
                     "other_wrapper_ms": [through[0], through[3]],
                     "this_wrapper_ms": [through[1], through[2]], **sdpa,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "ratio": min(bare[1:3]) / min(bare[0], bare[3]), "agree": agree,
                     "bit_equal": same, "other_vs_plain": errs["other"],
                     "this_vs_plain": errs["this"],
                     "form": fa.attention_nhd_bwd_form(n, bs, torch.bfloat16)}
        print(f"{card}: {key} bf16, C entry: other {bare[0]:.4f} / {bare[3]:.4f} ms, this "
              f"{bare[1]:.4f} / {bare[2]:.4f} ms ({rows[key]['ratio']:.3f}x); through the "
              f"wrapper: other {through[0]:.4f} / {through[3]:.4f} ms, this {through[1]:.4f}"
              f" / {through[2]:.4f} ms; SDPA{' (mask)' if bs else ''} "
              f"{sdpa['library_ms']:.4f} ms (its best reading), bound {bound[0]:.4f} ms "
              f"({bound[1]}); host a launch: other {hosts[0]:.2f} / {hosts[3]:.2f} us, this "
              f"{hosts[1]:.2f} / {hosts[2]:.2f} us; dq/dk/dv rel_err vs plain: other "
              + "/".join(f"{e:.3e}" for e in errs["other"]) + ", this "
              + "/".join(f"{e:.3e}" for e in errs["this"])
              + f"; outputs {'bit-equal' if same else 'differ'} between the libraries; "
              + ("ok" if agree else "MISS"), flush=True)
        del xq, xk, xv, do, stats, want, calls, got
    return rows


def b1_bodies(libs: dict) -> dict:
    """Per checkout, the B1 kernels a DINO step launches, by name: the
    one-pass forward, and the dq and dk/dv kernels of the backward form
    that a profiled call of that library's backward entry at DINO's globals
    runs (read off the card, not the library's binary, which holds every
    form: a copy built with another resident limit runs another)."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    b, n, h, d, bs = B1_BWD_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    xq, xk, xv, do = (torch.randn(b, n, h * d, generator=g, device="cuda").to(torch.bfloat16)
                      for _ in range(4))
    _, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, d ** -0.5, bs)
    found = {}
    for who, lib in libs.items():
        call = chip_smoke.b1_bare(torch, fa, fa.KERNEL_BWD, xq, xk, xv, h, d ** -0.5, bs,
                                  entry_fn(lib[fa.KERNEL_BWD], fa.KERNEL_BWD), grad=(do, stats))
        call()
        for _ in range(chip_smoke.PROFILE_SESSIONS):  # a session may lose its events
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages()]
            forms = [form for form, kernels_of in B1_BWD_BODIES.items()
                     if all(any(k in name for name in names) for k in kernels_of)]
            if forms:
                break
        else:
            raise RuntimeError(f"no profile of the {who} library's {fa.KERNEL_BWD} names "
                               f"the kernels of a form of {B1_BWD_BODIES}")
        found[who] = (fa.FORWARD_BODIES["one-pass"], *B1_BWD_BODIES[forms[0]])
    return found


def b1_step_turns(card: str, libs: dict) -> dict:
    """The DINO ViT-S/8 training step (B1's three entries routed) and a
    served batch of 128 (its two forwards) with each library in turns
    (other, this, this, other): warm ms, device busy ms and peak GB;
    whether every loss and embedding was finite."""
    import chip_smoke
    from vit_ssl_tpu_torch.serve import Server

    want = b1_bodies(libs)
    rows = {"training": _training_turns(card, libs, dino_step, "DINO ViT-S/8", fa,
                                        (*B1_ENTRIES, fa.KERNEL_BWD), want)}
    want = {who: names[:1] for who, names in want.items()}
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
    # per checkout, each of B1's entries' library
    libs = {who: {**{name: by_name[fa.KERNEL] for name in B1_ENTRIES},
                  fa.KERNEL_BWD: by_name[fa.KERNEL_BWD]}
            for who, by_name in built.items()}
    return {"entries": b1_entry_turns(card, libs), "backward": b1_bwd_turns(card, libs),
            "steps": b1_step_turns(card, libs)}


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


def b4_bare(lib, name, x, w1, b1, w2, b2, mask, pre, do, keep):
    """A no-argument launch of ``lib``'s B4 entry ``name`` (in x's dtype)
    on outputs and scratch allocated once, returning the outputs: (out,),
    (out, pre) or (dx, dw1, db1, dw2, db2)."""
    t, d = x.shape
    d_ff = w1.shape[0]
    fn = b4_entry(lib, name)

    def new(*shape, dtype=x.dtype):
        return torch.empty(*shape, device=x.device, dtype=dtype)

    if name == fm.KERNEL_BWD:
        floats = lib.fused_mlp_bwd_partial_floats
        floats.argtypes, floats.restype = [ctypes.c_int] * 2, ctypes.c_longlong
        outs = [new(t, d), new(d_ff, d), new(d_ff), new(d, d_ff), new(d)]
        scratch = [new(t, d_ff), new(t, d_ff), new(floats(d, d_ff), dtype=torch.float32)]
        ptrs = [x, pre, do, w1, w2, mask, *outs, *scratch]
    else:
        outs = [new(t, d)] + ([new(t, d_ff)] if name == fm.KERNEL_TRAIN else [])
        scratch = [fm._scratch_h(x, d_ff)]  # dropped for a library that takes none
        ptrs = [x, w1, b1, w2, b2, mask, *outs, *scratch]
    keep = keep if mask is not None else 1.0
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(*(None if y is None else y.data_ptr() for y in ptrs), t, d, d_ff,
                 int(x.dtype == torch.bfloat16), keep, stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        return outs
    return call


def b4_entry_turns(card, libs):
    """B4's bf16 entries of both libraries at each ``chip_smoke.MLP_TIMED``
    row: held to the plain version, timed in turns as C entries (device ms,
    host us a launch) and through the wrappers, beside the unfused chain
    and the bound."""
    import chip_smoke

    keep, rows = chip_smoke.KEEP_PROB, {}
    for part, t, with_mask, (d, d_ff) in chip_smoke.MLP_TIMED:
        x, w1, b1, w2, b2, mask, do = chip_smoke.mlp_inputs(torch, t, torch.bfloat16, seed=500,
                                                            dims=(d, d_ff))
        mask = mask if with_mask else None
        name = {"fwd": fm.KERNEL, "fwd_pre": fm.KERNEL_TRAIN, "bwd": fm.KERNEL_BWD}[part]
        _, pre = fm.fused_mlp_fwd(x, w1, b1, w2, b2, mask, keep, save_pre=True)
        if part == "bwd":
            plain = fm.fused_mlp_bwd_reference(x, pre, do, w1, w2, mask, keep)
            ins = [y.detach().requires_grad_() for y in (x, w1, b1, w2, b2)]
            chain_out = chip_smoke.unfused_ffn(torch, *ins, mask, keep)

            def wrapper():
                return fm.fused_mlp_bwd(x, pre, do, w1, w2, mask, keep)

            def chain():
                return torch.autograd.grad(chain_out, ins, do, retain_graph=True)
        else:
            save_pre = part == "fwd_pre"
            plain = fm.fused_mlp_reference(x, w1, b1, w2, b2, mask, keep, save_pre=save_pre)
            plain = plain if save_pre else (plain,)

            def wrapper():
                return fm.fused_mlp_fwd(x, w1, b1, w2, b2, mask, keep, save_pre=save_pre)

            def chain():
                return chip_smoke.unfused_ffn(torch, x, w1, b1, w2, b2, mask, keep)
        calls = {who: b4_bare(lib[name], name, x, w1, b1, w2, b2, mask, pre, do, keep)
                 for who, lib in libs.items()}
        got = {who: [y.clone() for y in call()] for who, call in calls.items()}
        torch.cuda.synchronize()
        errs = {who: [chip_smoke.rel_err(g, r) for g, r in zip(outs, plain)]
                for who, outs in got.items()}
        apart = [chip_smoke.rel_err(a, c) for a, c in zip(got["this"], got["other"])]
        agree = all(max(e) <= chip_smoke.MLP_REL_TOL["bfloat16"] for e in errs.values())
        bare = [cuda_ms(calls[who]) for who in TURNS]
        hosts = [chip_smoke.host_us(calls[who]) for who in TURNS]
        through = []
        for who in TURNS:
            with routed(libs[who], fm, B4_ENTRIES):
                through.append(cuda_ms(wrapper))
        chain_ms = cuda_ms(chain)
        bound = chip_smoke.mlp_bounds(t, d, d_ff, "bfloat16", with_mask,
                                      part == "fwd_pre")["bwd" if part == "bwd" else "fwd"]
        key = f"{name} T={t} {d}->{d_ff}{' keep-mask' if with_mask else ''}"
        rows[key] = {"other_ms": [bare[0], bare[3]], "this_ms": [bare[1], bare[2]],
                     "other_host_us": [hosts[0], hosts[3]],
                     "this_host_us": [hosts[1], hosts[2]],
                     "other_wrapper_ms": [through[0], through[3]],
                     "this_wrapper_ms": [through[1], through[2]],
                     "ratio": min(bare[1:3]) / min(bare[0], bare[3]),
                     "unfused_chain_ms": chain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                     "agree": agree, "other_vs_plain": errs["other"],
                     "this_vs_plain": errs["this"], "this_vs_other": apart}
        print(f"{card}: {key} bf16, C entry: other {bare[0]:.4f} / {bare[3]:.4f} ms, this "
              f"{bare[1]:.4f} / {bare[2]:.4f} ms ({rows[key]['ratio']:.3f}x); through the "
              f"wrapper: other {through[0]:.4f} / {through[3]:.4f} ms, this {through[1]:.4f} "
              f"/ {through[2]:.4f} ms; unfused chain {chain_ms:.4f} ms, bound {bound[0]:.4f} "
              f"ms ({bound[1]}); host a launch: other {hosts[0]:.2f} / {hosts[3]:.2f} us, "
              f"this {hosts[1]:.2f} / {hosts[2]:.2f} us; rel_err vs plain: other "
              + "/".join(f"{e:.3e}" for e in errs["other"]) + ", this "
              + "/".join(f"{e:.3e}" for e in errs["this"]) + "; this vs other "
              + "/".join(f"{e:.3e}" for e in apart) + ("; ok" if agree else "; MISS"),
              flush=True)
        del x, w1, b1, w2, b2, mask, do, pre, calls, got, plain
        torch.cuda.empty_cache()
    return rows


def unchanged_outputs(card, libs, p2_libs):
    """B4's float32 entries (the masked training forward and the backward)
    and P2's bf16 and float32 entries, each library on the same inputs:
    whether the two libraries' outputs are equal bit for bit."""
    import chip_smoke

    keep, same = chip_smoke.KEEP_PROB, {}
    for t, d, d_ff in B4_F32_CASES:
        x, w1, b1, w2, b2, mask, do = chip_smoke.mlp_inputs(torch, t, torch.float32, seed=7,
                                                            dims=(d, d_ff))
        pre = fm.fused_mlp_reference(x, w1, b1, w2, b2, mask, keep, save_pre=True)[1]
        for name in (fm.KERNEL_TRAIN, fm.KERNEL_BWD):
            got = {who: [y.clone() for y in b4_bare(lib[name], name, x, w1, b1, w2, b2,
                                                    mask, pre, do, keep)()]
                   for who, lib in libs.items()}
            same[f"{name} float32 T={t} {d}->{d_ff}"] = all(
                torch.equal(a, c) for a, c in zip(got["other"], got["this"]))
    for dtype in (torch.bfloat16, torch.float32):
        for t, d_ff, d_out in P2_CASES:
            h, mask, w2, b2, do = chip_smoke.masked_inputs(torch, t, d_ff, d_out, dtype, seed=8)
            got = {}
            for who, lib in p2_libs.items():
                with routed(lib, mm, P2_ENTRIES):
                    got[who] = [mm.masked_matmul_fwd(h, mask, w2, b2, keep),
                                *mm.masked_matmul_bwd(h, mask, do, w2, keep)]
            same[f"P2 {str(dtype).removeprefix('torch.')} T={t} {d_ff}->{d_out}"] = all(
                torch.equal(a, c) for a, c in zip(got["other"], got["this"]))
    torch.cuda.synchronize()
    for key, equal in same.items():
        print(f"{card}: {key}: outputs {'bit-equal' if equal else 'DIFFER'} between the "
              "libraries", flush=True)
    return same


def b4_main(card, built):
    import chip_smoke

    # per checkout, each of B4's entries' library
    libs = {who: {fm.KERNEL: by_name[fm.KERNEL], fm.KERNEL_TRAIN: by_name[fm.KERNEL],
                  fm.KERNEL_BWD: by_name[fm.KERNEL_BWD]} for who, by_name in built.items()}
    rows = b4_entry_turns(card, libs)
    same = unchanged_outputs(card, libs, {who: by_name[mm.LIBRARY]
                                          for who, by_name in built.items()})
    want = bodies_in(libs, "b4")
    steps = {
        "vit_b16_384_fused": _training_turns(
            card, libs, lambda: supervised_step(chip_smoke.VIT_B16_384_FUSED),
            "ViT-B/16 384 px fused", fm, B4_ENTRIES, want),
        "dino_fused": _training_turns(
            card, libs, lambda: dino_step(chip_smoke.fused_config()), "DINO ViT-S/8 fused", fm,
            B4_ENTRIES, want)}
    return {"entries": rows, "bit_equal": same, "steps": steps}


def p2_bare(lib, name, h, mask, w2, b2, do, keep):
    """A no-argument launch of ``lib``'s P2 entry ``name`` (in h's dtype) on
    outputs and scratch allocated once, returning the outputs: (o,) or
    (dh, dw2, db2)."""
    t, d_ff = h.shape
    d_out = w2.shape[0]
    fn = library_entry(lib, name)
    if name == mm.KERNEL_BWD:
        floats = lib.masked_mm_bwd_partial_floats
        floats.argtypes, floats.restype = [ctypes.c_int] * 2, ctypes.c_longlong
        outs = [torch.empty_like(h), torch.empty_like(w2), torch.empty_like(b2)]
        part = torch.empty(floats(d_ff, d_out), device=h.device, dtype=torch.float32)
        ptrs = [h, mask, do, w2, *outs, part]
    else:
        outs = [torch.empty(t, d_out, device=h.device, dtype=h.dtype)]
        ptrs = [h, mask, w2, b2, *outs]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(*(y.data_ptr() for y in ptrs), t, d_ff, d_out,
                 int(h.dtype == torch.bfloat16), keep, stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        return outs
    return call


def p2_entry_turns(card, libs):
    """P2's bf16 entries of both libraries at each P2_TIMED shape: held to
    the plain version, timed in turns as C entries (device ms, host us a
    launch) and through the wrapper, beside the ``where`` + ``F.linear``
    pair (the backward: its autograd backward) and the bound."""
    import chip_smoke

    keep, rows = chip_smoke.KEEP_PROB, {}
    for t, d_ff, d_out in P2_TIMED:
        h, mask, w2, b2, do = chip_smoke.masked_inputs(torch, t, d_ff, d_out, torch.bfloat16,
                                                       seed=700)
        ins = [y.detach().requires_grad_() for y in (h, w2, b2)]

        def pair(h, w2, b2):
            return torch.nn.functional.linear(
                torch.where(mask, h / keep, h.new_zeros(())), w2, b2)

        pair_out = pair(*ins)
        bounds = chip_smoke.masked_bounds(t, d_ff, d_out, "bfloat16")
        for name in P2_ENTRIES:
            if name == mm.KERNEL:
                plain = [mm.masked_matmul_reference(h, mask, w2, b2, keep)]

                def wrapper():
                    return mm.masked_matmul_fwd(h, mask, w2, b2, keep)

                def library():
                    return pair(h, w2, b2)
            else:
                plain = mm.masked_matmul_bwd_reference(h, mask, do, w2, keep)

                def wrapper():
                    return mm.masked_matmul_bwd(h, mask, do, w2, keep)

                def library():
                    return torch.autograd.grad(pair_out, ins, do, retain_graph=True)
            bound = bounds["fwd" if name == mm.KERNEL else "bwd"]
            calls = {who: p2_bare(lib, name, h, mask, w2, b2, do, keep)
                     for who, lib in libs.items()}
            got = {who: [y.clone() for y in call()] for who, call in calls.items()}
            torch.cuda.synchronize()
            errs = {who: [chip_smoke.rel_err(g, r) for g, r in zip(outs, plain)]
                    for who, outs in got.items()}
            apart = [chip_smoke.rel_err(a, c) for a, c in zip(got["this"], got["other"])]
            agree = all(max(e) <= chip_smoke.MLP_REL_TOL["bfloat16"] for e in errs.values())
            bare = [cuda_ms(calls[who]) for who in TURNS]
            hosts = [chip_smoke.host_us(calls[who]) for who in TURNS]
            through = []
            for who in TURNS:
                with routed(libs[who], mm, P2_ENTRIES):
                    through.append(cuda_ms(wrapper))
            library_ms = cuda_ms(library)
            key = f"{name} T={t} {d_ff}->{d_out}"
            rows[key] = {"other_ms": [bare[0], bare[3]], "this_ms": [bare[1], bare[2]],
                         "other_host_us": [hosts[0], hosts[3]],
                         "this_host_us": [hosts[1], hosts[2]],
                         "other_wrapper_ms": [through[0], through[3]],
                         "this_wrapper_ms": [through[1], through[2]],
                         "ratio": min(bare[1:3]) / min(bare[0], bare[3]),
                         "pair_ms": library_ms, "bound_ms": bound[0], "bound_by": bound[1],
                         "agree": agree, "other_vs_plain": errs["other"],
                         "this_vs_plain": errs["this"], "this_vs_other": apart}
            print(f"{card}: {key} bf16, C entry: other {bare[0]:.4f} / {bare[3]:.4f} ms, this "
                  f"{bare[1]:.4f} / {bare[2]:.4f} ms ({rows[key]['ratio']:.3f}x); through the "
                  f"wrapper: other {through[0]:.4f} / {through[3]:.4f} ms, this "
                  f"{through[1]:.4f} / {through[2]:.4f} ms; where + F.linear {library_ms:.4f} "
                  f"ms, bound {bound[0]:.4f} ms ({bound[1]}); host a launch: other "
                  f"{hosts[0]:.2f} / {hosts[3]:.2f} us, this {hosts[1]:.2f} / {hosts[2]:.2f} "
                  f"us; rel_err vs plain: other " + "/".join(f"{e:.3e}" for e in errs["other"])
                  + ", this " + "/".join(f"{e:.3e}" for e in errs["this"]) + "; this vs other "
                  + "/".join(f"{e:.3e}" for e in apart) + ("; ok" if agree else "; MISS"),
                  flush=True)
        del h, mask, w2, b2, do, ins, pair_out, calls, got, plain
        torch.cuda.empty_cache()
    return rows


def p2_probe_turns(card, libs):
    """The dropout-epilogue probe's ``epilogue`` leg (an FFN step with P2's
    forward and backward) with P2's entries routed to each library in turns,
    beside its ``xla`` leg before and after: the probe's check under each
    library, ms a step (CUDA events, the probe's ITERS steps), device busy
    from a profile of one step (which must name that library's P2
    kernels), and the probe's verdict with each library's time."""
    import chip_smoke
    from vit_ssl_tpu_torch.scripts import dropout_epilogue_probe as probe

    x, params = probe.make_inputs()
    generator = torch.Generator(device="cuda").manual_seed(7)
    want = bodies_in(libs, "p2")
    checks = {}
    for who in ("other", "this"):
        with routed(libs[who], mm, P2_ENTRIES):
            checks[who] = probe.check(x, params, generator)
        print(f"{card}: the probe's check, {who} library: o max_abs_err "
              f"{checks[who][0]:.3e}, gradients {checks[who][1]:.3e} (within its "
              f"tolerances)", flush=True)
    steps = {leg: probe.make_step(leg, params, x, generator) for leg in ("xla", "epilogue")}
    xla = [cuda_ms(steps["xla"], iters=probe.ITERS)]
    turns = []
    for who in TURNS:
        with routed(libs[who], mm, P2_ENTRIES):
            ms = cuda_ms(steps["epilogue"], iters=probe.ITERS)
            _, busy_ms = chip_smoke.profile_window(
                torch, steps["epilogue"], f"the probe's epilogue leg, {who} library", rows=6,
                want=want[who])
            finite = bool(torch.isfinite(steps["epilogue"]()).item())
        turns.append({"library": who, "ms": ms, "device_busy_ms": busy_ms, "finite": finite})
        print(f"{card}: the probe's epilogue leg, {who} library: {ms:.3f} ms a step, device "
              f"busy {busy_ms:.3f} ms; {'finite' if finite else 'NOT FINITE'}", flush=True)
    xla.append(cuda_ms(steps["xla"], iters=probe.ITERS))
    verdicts = {who: probe.verdict({"xla": min(xla), "epilogue": min(
        turn["ms"] for turn in turns if turn["library"] == who)}) for who in ("other", "this")}
    print(f"{card}: the probe's xla leg {xla[0]:.3f} / {xla[1]:.3f} ms a step; verdict with "
          f"the other library: {verdicts['other']}; with this: {verdicts['this']}", flush=True)
    return {"check": checks, "xla_ms": xla, "epilogue": turns, "verdict": verdicts}


def b4_unchanged(card, libs, p2_libs):
    """B4's three entries, bf16 at B4_BF16_CASES and float32 at
    B4_F32_CASES, and P2's float32 entries at P2_CASES, each library on the
    same inputs: whether the two libraries' outputs are equal bit for bit
    (P2's bf16 bodies changed their sums' order, so its bf16 outputs are
    held to the plain version instead, in p2_entry_turns)."""
    import chip_smoke

    keep, same = chip_smoke.KEEP_PROB, {}
    cases = ([(torch.bfloat16, *case) for case in B4_BF16_CASES]
             + [(torch.float32, *case, True) for case in B4_F32_CASES])
    for dtype, t, d, d_ff, with_mask in cases:
        x, w1, b1, w2, b2, mask, do = chip_smoke.mlp_inputs(torch, t, dtype, seed=7,
                                                            dims=(d, d_ff))
        mask = mask if with_mask else None
        pre = fm.fused_mlp_reference(x, w1, b1, w2, b2, mask, keep, save_pre=True)[1]
        for name in B4_ENTRIES:
            got = {who: [y.clone() for y in b4_bare(lib[name], name, x, w1, b1, w2, b2,
                                                    mask, pre, do, keep)()]
                   for who, lib in libs.items()}
            same[f"{name} {str(dtype).removeprefix('torch.')} T={t} {d}->{d_ff}"
                 f"{' keep-mask' if with_mask else ''}"] = all(
                torch.equal(a, c) for a, c in zip(got["other"], got["this"]))
        del x, w1, b1, w2, b2, mask, do, pre, got
    for t, d_ff, d_out in P2_CASES:
        h, mask, w2, b2, do = chip_smoke.masked_inputs(torch, t, d_ff, d_out, torch.float32,
                                                       seed=8)
        got = {who: [y.clone() for name in P2_ENTRIES
                     for y in p2_bare(lib, name, h, mask, w2, b2, do, keep)()]
               for who, lib in p2_libs.items()}
        same[f"P2 float32 T={t} {d_ff}->{d_out}"] = all(
            torch.equal(a, c) for a, c in zip(got["other"], got["this"]))
    torch.cuda.synchronize()
    for key, equal in same.items():
        print(f"{card}: {key}: outputs {'bit-equal' if equal else 'DIFFER'} between the "
              "libraries", flush=True)
    return same


def hopper_checks(card, built) -> dict:
    """From both checkouts' ``-Xptxas -v`` logs: every Hopper kernel that
    spills or has its wgmma serialised (C7514, C7515, C7520), and every B4
    kernel above REGISTERS_TWO_BLOCKS registers (two blocks an SM)."""
    import chip_smoke

    faults, over = [], []
    b4 = [body for bodies in fm.HOPPER_BODIES.values() for body in bodies]
    for who, by_name in built.items():
        for name, lib in by_name.items():
            log = kernels.log_path(name) if who == "this" else Path(lib._name).with_suffix(".log")
            lines = list(chip_smoke.ptxas_lines(log.read_text(), kernels.nvcc_path()))
            faults += [f"{who} {name}: {line}" for line in chip_smoke.hopper_faults(lines)]
            over += [f"{who} {name}: {kernel}: {row['registers']} registers"
                     for kernel, row in chip_smoke.registers_and_spills(lines, b4).items()
                     if row.get("registers", 0) > REGISTERS_TWO_BLOCKS]
    print(f"{card}: Hopper kernels that spill or serialise their wgmma: {faults or 'none'}; "
          f"B4 kernels above {REGISTERS_TWO_BLOCKS} registers: {over or 'none'}", flush=True)
    return {"faults": faults, "b4_over_registers": over}


def p2_main(card, built):
    libs = {who: by_name[mm.LIBRARY] for who, by_name in built.items()}
    b4_libs = {who: {fm.KERNEL: by_name[fm.KERNEL], fm.KERNEL_TRAIN: by_name[fm.KERNEL],
                     fm.KERNEL_BWD: by_name[fm.KERNEL_BWD]} for who, by_name in built.items()}
    checks = hopper_checks(card, built)
    rows = p2_entry_turns(card, libs)
    probe = p2_probe_turns(card, libs)
    same = b4_unchanged(card, b4_libs, libs)
    return {"entries": rows, "probe": probe, "bit_equal": same, "ptxas": checks,
            "steps": {"probe_epilogue": probe["epilogue"]}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of the other checkout")
    parser.add_argument("--kernel", choices=("b3", "b2", "b1", "b4", "p2"), default="b3",
                        help="b3: fused_attention's three entries and the 384-px step; "
                             "b2: B2's forwards and backward, the 512-px step and served "
                             "batch; b1: B1's two forwards and its backward, the DINO step "
                             "and served batch; b4: the fused MLP's three entries, its "
                             "fp32 and P2's outputs bit for bit, the fused ViT-B/16 "
                             "384-px and DINO steps; p2: P2's two entries and the "
                             "probe's epilogue leg, B4's outputs bit for bit and its "
                             "Hopper kernels' SASS")
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
                      "b1": ((fa.KERNEL, fa.KERNEL_BWD), b1_main),
                      "b4": ((fm.KERNEL, fm.KERNEL_BWD, mm.LIBRARY, *ATTENTION_LIBRARIES),
                             b4_main),
                      "p2": ((mm.LIBRARY, fm.KERNEL, fm.KERNEL_BWD), p2_main)}[args.kernel]
    with tempfile.TemporaryDirectory() as tmp:
        kernels.build(libraries)
        built = {"other": build_others(args.other.resolve(), Path(tmp), libraries),
                 "this": {name: kernels.load(name) for name in libraries}}
        shown = (fm.KERNEL, fm.KERNEL_BWD) if args.kernel == "b4" else libraries
        print_registers(card, {who: {name: lib for name, lib in by_name.items()
                                     if name in shown} for who, by_name in built.items()})
        sass = print_sass(card, built)
        result = {"card": card, "kernel": args.kernel, "sass": sass, **run(card, built)}
    print(json.dumps(result), flush=True)
    entries = ([s["entries"] for s in result["shapes"].values()] if args.kernel == "b2"
               else [result["entries"]])
    legs = [leg for leg in result["steps"].values()]
    backward_ok = {"b2": lambda: result["backward"]["agree"],
                   "b1": lambda: all(r["agree"] for r in result["backward"].values()),
                   "b4": lambda: all(result["bit_equal"].values()),
                   "p2": lambda: (all(result["bit_equal"].values())
                                  and not any(result["ptxas"].values())
                                  and not any(sass[name]["differ"]
                                              for name in (fm.KERNEL, fm.KERNEL_BWD))),
                   "b3": lambda: True}[args.kernel]()
    return 0 if (all(r["agree"] for rows in entries for r in rows.values()) and backward_ok
                 and all(t["finite"] for leg in legs for t in leg)) else 1


if __name__ == "__main__":
    sys.exit(main())

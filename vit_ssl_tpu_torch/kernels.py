"""Build, load and count the port's hand-written CUDA kernels.

Each kernel library is one ``csrc/<name>.cu`` with a plain C interface
(it may include shared ``csrc/*.cuh`` headers). It is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>.so`` at first use (or by
:func:`build` for several at once, one ``nvcc`` each, all started
together) and loaded with :mod:`ctypes`; a library older than its source
or any header it includes is rebuilt. Nothing is built or
loaded when this module is imported, so the CPU tests import it freely.

``launches`` counts, per C entry point, the launches the wrappers made. Each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that a path really went through the kernels.

Beside them, the host libraries (:data:`HOST_SOURCES`: C++ for the CPU)
are built with the host C++ compiler (``c++``, else ``g++``) into
``_build/lib<name>.so`` at first use, by :func:`load_host`; they are no part
of :data:`SOURCES` or :func:`build`. :data:`HOST_IMAGE` is the image path's
one library: the PNG (over its inflate), JPEG and WebP decoders, OpenCV's
image arithmetic and the whole-batch decode, whose entries the others' are,
each source compiled once. The TIFF and zstd decoders are libraries of their
own. They link the C++ standard library only and are called through
:mod:`ctypes`, which releases the GIL. ``host_calls`` counts, per C entry,
the calls the host wrappers made, as ``launches`` does for the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple, Union

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# kernel name -> source, relative to the package
SOURCES: Dict[str, str] = {
    "attention_nhd_fwd": "csrc/attention_nhd_fwd.cu",
    "attention_nhd_bwd": "csrc/attention_nhd_bwd.cu",
    "fused_attention": "csrc/fused_attention.cu",
    "fused_mlp_fwd": "csrc/fused_mlp_fwd.cu",
    "fused_mlp_bwd": "csrc/fused_mlp_bwd.cu",
    "flash_blockwise_fwd": "csrc/flash_blockwise_fwd.cu",
    "flash_blockwise_bwd": "csrc/flash_blockwise_bwd.cu",
    "masked_matmul": "csrc/masked_matmul.cu",
}

# the image path's host library: every source compiled once, each to an
# object, then linked into one library (C entry names unique across them)
HOST_IMAGE = "host_image"

# host library name -> its C++ source, or sources, relative to the package
HOST_SOURCES: Dict[str, Union[str, Tuple[str, ...]]] = {
    HOST_IMAGE: ("csrc/png_decode.cpp", "csrc/inflate.cpp", "csrc/image_ops.cpp",
                 "csrc/jpeg_decode.cpp", "csrc/webp_decode.cpp", "csrc/batch_decode.cpp"),
    "zstd_decode": "csrc/zstd_decode.cpp",
    "tiff_decode": "csrc/tiff_decode.cpp",
}

# ISO C++17: no GNU extensions, so floating-point contraction stays off and
# the host image arithmetic rounds as the numpy versions do (no -ffast-math)
HOST_FLAGS = ["-std=c++17", "-O2", "-fPIC"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
]

launches: collections.Counter = collections.Counter()
host_calls: collections.Counter = collections.Counter()
_host_calls_lock = threading.Lock()


def count_host_call(entry: str) -> None:
    """Add one to ``host_calls[entry]``: a host wrapper calls this where it
    calls the C entry, from any of the loader's threads."""
    with _host_calls_lock:
        host_calls[entry] += 1

_loaded: Dict[str, ctypes.CDLL] = {}


def refuse_dtensor(kernel: str, **tensors) -> None:
    """Raise ``TypeError`` naming ``kernel`` and the argument when an input
    is a ``torch.distributed`` ``DTensor``: the kernels take raw pointers
    to whole local tensors, and a sharded ``DTensor``'s pointer is one
    rank's chunk. The port's fsdp hands them the gathered parameters
    (``parallel/fsdp.py``); a ``DTensor`` here is a fault upstream."""
    for name, x in tensors.items():
        if x is not None and type(x).__name__ == "DTensor":
            raise TypeError(
                f"{kernel}: {name} is a DTensor (placements "
                f"{getattr(x, 'placements', '?')}); the hand-written kernels take "
                "whole local tensors by pointer: gather it (full_tensor()) first")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built on the machine with the card"
        )
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.log"


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def host_sources(name: str) -> List[Path]:
    """The host library's C++ sources."""
    sources = HOST_SOURCES[name]
    return [PACKAGE_DIR / s for s in ((sources,) if isinstance(sources, str) else sources)]


def source_files(name: str) -> List[Path]:
    """The library's sources and every local header they include, directly
    or through another header (``#include "..."``, resolved beside the
    file)."""
    files = []
    todo = host_sources(name) if name in HOST_SOURCES else [PACKAGE_DIR / SOURCES[name]]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo.extend(path.parent / inc for inc in _INCLUDE.findall(path.read_text()))
    return files


def _stale(name: str) -> bool:
    """The library (a kernel's or a host one) is missing or older than its
    source or any header."""
    lib = library_path(name)
    return not lib.exists() or any(lib.stat().st_mtime < f.stat().st_mtime
                                   for f in source_files(name))


def build(names: Iterable[str] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are missing or older
    than their source, one ``nvcc`` process each, all running at once.

    Returns each compiled kernel's build seconds. Raises with the compiler's
    output if any build fails. The compiler's log (``-Xptxas -v``) is kept
    in ``_build/lib<name>.log``."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(PACKAGE_DIR / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    seconds, failures = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        log_path(name).write_text(out)
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, library_path(name))  # atomic: concurrent loaders see whole files
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def host_compiler() -> str:
    """The host C++ compiler: ``c++``, else ``g++``, on PATH."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found is not None:
            return found
    raise RuntimeError(
        "no host C++ compiler (c++ or g++) on PATH: the host libraries "
        f"{sorted(HOST_SOURCES)} are built from csrc/ at first use")


def build_host(name: str) -> float:
    """Compile the host library ``name`` when it is missing or older than
    any of its sources; returns the build's seconds (0 when it was current).
    Each source is compiled to an object, all at once, one compiler each,
    then the objects are linked. Built to a name of this process's own and
    moved into place, so processes that build at once each see a whole file.
    Raises with the compiler's output if the build fails; the log (each
    command and its output) is kept in ``_build/lib<name>.log``."""
    if not _stale(name):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"lib{name}.{os.getpid()}"
    tmp = BUILD_DIR / f"{stem}.so"
    compiler, sources = host_compiler(), host_sources(name)
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    steps = [[compiler, *HOST_FLAGS, "-c", "-o", str(obj), str(src)]
             for obj, src in zip(objects, sources)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in steps]
    outputs = []
    for cmd, proc in zip(steps, procs):
        out, _ = proc.communicate()
        outputs.append((cmd, proc.returncode, out))
    if all(rc == 0 for _, rc, _ in outputs):
        link = [compiler, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        outputs.append((link, proc.returncode, proc.stdout))
    seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink(missing_ok=True)
    log = BUILD_DIR / f"{stem}.log"
    log.write_text("".join(f"$ {' '.join(cmd)}\n{out}" for cmd, _, out in outputs))
    os.replace(log, log_path(name))  # whole, as the library
    failed = [(cmd, rc, out) for cmd, rc, out in outputs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, out = failed[0]
        raise RuntimeError(f"host library build failed ({' '.join(cmd)}, exit {rc}):\n{out}")
    os.replace(tmp, library_path(name))
    return seconds


_host_lock = threading.Lock()


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``name``, built first if needed (once, whichever
    thread asks first)."""
    lib = _loaded.get(name)
    if lib is None:
        with _host_lock:
            lib = _loaded.get(name)
            if lib is None:
                build_host(name)
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib

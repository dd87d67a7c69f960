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
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

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

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
]

launches: collections.Counter = collections.Counter()

_loaded: Dict[str, ctypes.CDLL] = {}


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


def source_files(name: str) -> List[Path]:
    """The kernel's source and every local header it includes, directly or
    through another header (``#include "..."``, resolved beside the file)."""
    files, todo = [], [PACKAGE_DIR / SOURCES[name]]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo.extend(path.parent / inc for inc in _INCLUDE.findall(path.read_text()))
    return files


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any header."""
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

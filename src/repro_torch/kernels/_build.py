"""Builds the CUDA kernels in ``csrc/`` with ``nvcc`` and loads them with
``ctypes``.

Each source has a plain C interface (pointers and the stream as
``void*``) and compiles on its own into a shared library under
``build/torch_kernels/`` at the root of the checkout, named by a hash of
the source, so a rebuilt source never loads a stale library. The build
happens at a kernel's first launch, never at import; ``build_all`` starts
one ``nvcc`` per source, all at once, and is what ``chip_smoke.py`` calls
to build up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = {"streamed_matmul": "streamed_matmul.cu",
           "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> {"seconds": wall time of its nvcc, "log": nvcc's -Xptxas -v text}
BUILD_LOG: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / SOURCES[name]).read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library of ``names`` (all by default), one
    ``nvcc`` per source running in parallel. Raises with the compiler's
    output when one fails."""
    names = list(SOURCES if names is None else names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    errors = []
    for n, (p, tmp, t0) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]} "
                          f"(exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str, argtypes) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing. Its
    entry point ``fm_<name>`` gets ``argtypes`` and returns a CUDA error
    code."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, f"fm_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(name: str, err: int) -> None:
    """Raise if a kernel's entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")

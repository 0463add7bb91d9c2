"""Build of the port's CUDA sources: nvcc into shared libraries with a plain C
interface, loaded with ctypes.

Each source compiles on first use into `build/torch_kernels/` at the root of
the checkout, under a name that carries a hash of the source and the flags,
so an edited source builds anew. Nothing builds when a module is imported:
a machine without `nvcc` can import every module and run the plain versions.
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

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libraries: dict = {}
# source stem → {"seconds": build wall time, "ptxas": compiler report}
build_log: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on "
                           "first use on a machine with the CUDA toolkit")
    return nvcc


def _target(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:12]}.so"


def build(sources) -> None:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together; raise with the compiler's output if any
    fails."""
    todo = [(Path(s), _target(Path(s))) for s in sources]
    todo = [(s, so) for s, so in todo if not so.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((src, so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{out}")
            continue
        os.replace(tmp, so)
        build_log[src.stem] = {"seconds": time.perf_counter() - t0,
                               "ptxas": out}
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: Path) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    source = Path(source)
    with _lock:
        lib = _libraries.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_target(source)))
            _libraries[source] = lib
        return lib

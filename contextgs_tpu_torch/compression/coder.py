"""Range coder bindings (port of `contextgs_tpu/compression/coder.py`).

The coder is host C++, the port's own copy of the JAX package's source
(`csrc/range_coder.cpp` beside this module), so both packages write the same
bytes for the same rows and symbols. CDF rows arrive as float CDF values and
are quantized here to 16-bit integer rows with a bin of at least one unit per
symbol (the normalization torchac applies), so that encode and decode are
exactly invertible whatever the float noise.

The shared library is built with the host C++ compiler at first use, never
at import, into `build/torch_kernels/` beside the CUDA kernels, under a name
keyed by a hash of the source, the compiler and the flags. A machine with no
compiler cannot code: the build raises, and there is no fallback coder.
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

import numpy as np

from contextgs_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "range_coder.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
# compiler path and version, library path and build seconds (None when the
# library was already built), filled by `library()`
build_info: dict = {}


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError(
        "no host C++ compiler found ($CXX, g++, c++ or clang++): the range "
        f"coder builds from {SOURCE} at first use")


def _build() -> Path:
    cxx = _compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join((cxx, version) + CXX_FLAGS).encode())
    target = BUILD_DIR / f"librange_coder_{digest.hexdigest()[:12]}.so"
    seconds = None
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
        seconds = time.perf_counter() - t0
    build_info.update(compiler=cxx, version=version, library=str(target),
                      seconds=seconds)
    return target


def library() -> ctypes.CDLL:
    """The range coder's library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            for name, args in (
                    ("rc_encode", [u16p, i64, i64, i32p, u8p, i64]),
                    ("rc_decode", [u16p, i64, i64, u8p, i64, i32p]),
                    ("rc_encode_shared", [u16p, i64, i64, i32p, u8p, i64]),
                    ("rc_decode_shared", [u16p, i64, i64, u8p, i64, i32p])):
                fn = getattr(lib, name)
                fn.restype = i64
                fn.argtypes = args
            _lib = lib
        return _lib


def quantize_cdf(cdf_float: np.ndarray) -> np.ndarray:
    """Float CDF rows [..., S+1] (0..1, nondecreasing) → uint16 rows with
    every bin at least one unit wide (torchac's normalization)."""
    cdf = np.asarray(cdf_float, dtype=np.float64)
    s = cdf.shape[-1] - 1
    scaled = cdf * (2.0 ** 16 - s)
    q = np.round(scaled).astype(np.int64) + np.arange(s + 1, dtype=np.int64)
    q = np.maximum.accumulate(q, axis=-1)          # enforce monotonic
    q[..., 0] = 0
    q[..., -1] = 1 << 16
    # re-enforce ≥1-wide bins after clipping the ends
    for _ in range(2):
        diff = np.diff(q, axis=-1)
        if (diff >= 1).all():
            break
        q[..., 1:] = np.maximum(q[..., 1:], q[..., :-1] + 1)
        q[..., -1] = 1 << 16
        q[..., :-1] = np.minimum(q[..., :-1],
                                 (1 << 16) - np.arange(s, 0, -1))
    if not (np.diff(q, axis=-1) >= 1).all():
        raise ValueError("degenerate CDF row")
    # the final 65536 is stored modulo 2^16 (uint16); the C++ side widens it
    return (q & 0xFFFF).astype(np.uint16)


def _encoded(fn, *args, n: int) -> bytes:
    cap = n * 8 + 64
    out = np.empty(cap, np.uint8)
    written = fn(*args, out, cap)
    if written < 0:
        raise ValueError("range encoder failed (invalid symbol or overflow)")
    return out[:written].tobytes()


def encode(cdf_rows: np.ndarray, symbols: np.ndarray) -> bytes:
    """cdf_rows [N, S+1] uint16 (from quantize_cdf), symbols [N] int."""
    cdf_rows = np.ascontiguousarray(cdf_rows, np.uint16)
    symbols = np.ascontiguousarray(symbols, np.int32)
    n, sp1 = cdf_rows.shape
    if symbols.shape != (n,):
        raise ValueError(f"{symbols.shape[0]} symbols for {n} CDF rows")
    if n == 0:
        return b""
    return _encoded(library().rc_encode, cdf_rows, n, sp1, symbols, n=n)


def decode(cdf_rows: np.ndarray, data: bytes) -> np.ndarray:
    cdf_rows = np.ascontiguousarray(cdf_rows, np.uint16)
    n, sp1 = cdf_rows.shape
    if n == 0:
        return np.zeros(0, np.int32)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int32)
    if library().rc_decode(cdf_rows, n, sp1, np.ascontiguousarray(buf),
                           len(buf), out) != 0:
        raise ValueError("range decoder failed")
    return out


def encode_shared(cdf_row: np.ndarray, symbols: np.ndarray) -> bytes:
    """One CDF row for all symbols (mask / per-channel factorized streams)."""
    cdf_row = np.ascontiguousarray(cdf_row, np.uint16)
    symbols = np.ascontiguousarray(symbols, np.int32)
    n = symbols.shape[0]
    if n == 0:
        return b""
    return _encoded(library().rc_encode_shared, cdf_row, cdf_row.shape[0], n,
                    symbols, n=n)


def decode_shared(cdf_row: np.ndarray, n: int, data: bytes) -> np.ndarray:
    cdf_row = np.ascontiguousarray(cdf_row, np.uint16)
    if n == 0:
        return np.zeros(0, np.int32)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int32)
    if library().rc_decode_shared(cdf_row, cdf_row.shape[0], n,
                                  np.ascontiguousarray(buf), len(buf),
                                  out) != 0:
        raise ValueError("range decoder failed")
    return out

"""ctypes binding for the native host data-feed engine — twin of
``paddle_tpu/io/native_feed.py``.

Reference analog: the pybind layer over data_feed.cc/data_set.cc
(pybind/data_set_py.cc).  The port keeps its own copy of the JAX
package's ``csrc/datafeed.cc`` (``io/csrc/datafeed.cc``) and builds it at
first use with the host's C++ compiler (``$CXX``, else ``g++``) into
``io/build/`` (listed in ``.gitignore``), named by a hash of the source
and the flags, as ``ops/_build.py`` builds the CUDA kernels; nothing is
built at import.  Where the JAX package quietly degrades to numpy when
its library is missing, the port raises at first use with the compiler's
message: every entry below runs the native code.
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
from typing import Dict, Optional

import numpy as np

__all__ = ["CXX_FLAGS", "load_library", "available", "shuffle_indices",
           "gather_rows", "scatter_axpy", "build_log"]

_IO_DIR = Path(__file__).resolve().parent
_SRC = _IO_DIR / "csrc" / "datafeed.cc"
_BUILD_DIR = _IO_DIR / "build"

# csrc/Makefile's CXXFLAGS and LDFLAGS for libptpu_datafeed.so
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-lpthread"]

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the build did: {"seconds", "cached", "path"} (read by chip_smoke.py)
build_log: Dict[str, object] = {}

_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError(
            "no C++ compiler ($CXX, g++, c++): paddle_tpu_torch's native "
            "data feed (io/csrc/datafeed.cc) is built at first use and has "
            "no numpy fallback")
    return cxx


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ptpu_shuffle_indices.argtypes = [_i64p, ctypes.c_int64,
                                         ctypes.c_uint64]
    lib.ptpu_shuffle_indices.restype = None
    lib.ptpu_gather_f32.argtypes = [_f32p, _i64p, ctypes.c_int64,
                                    ctypes.c_int64, _f32p]
    lib.ptpu_gather_f32.restype = None
    lib.ptpu_gather_u8_to_f32.argtypes = [_u8p, _i64p, ctypes.c_int64,
                                          ctypes.c_int64, _f32p,
                                          ctypes.c_float]
    lib.ptpu_gather_u8_to_f32.restype = None
    lib.ptpu_gather_i64.argtypes = [_i64p, _i64p, ctypes.c_int64,
                                    ctypes.c_int64, _i64p]
    lib.ptpu_gather_i64.restype = None
    lib.ptpu_scatter_axpy.argtypes = [_f32p, ctypes.c_int64, _i64p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      _f32p, ctypes.c_float]
    lib.ptpu_scatter_axpy.restype = None
    lib.ptpu_version.argtypes = []
    lib.ptpu_version.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached per process.
    Raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(_SRC.read_bytes())
        h.update(" ".join(CXX_FLAGS).encode())
        out = _BUILD_DIR / f"libptpu_datafeed_{h.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        cached = out.exists()
        if not cached:
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the native data feed failed "
                    f"({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)     # atomic: concurrent builds agree
        _lib = _bind(ctypes.CDLL(str(out)))
        build_log.update(seconds=time.perf_counter() - t0, cached=cached,
                         path=str(out))
        return _lib


def available() -> bool:
    """True once the library is built and loaded (building it if
    needed; a failed build raises)."""
    return load_library() is not None


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """Deterministic permutation of [0, n): the native Fisher-Yates over
    xorshift64* seeded with ``seed``."""
    lib = load_library()
    idx = np.arange(n, dtype=np.int64)
    lib.ptpu_shuffle_indices(idx.ctypes.data_as(_i64p), n,
                             ctypes.c_uint64(seed))
    return idx


def gather_rows(src: np.ndarray, rows: np.ndarray,
                out: Optional[np.ndarray] = None,
                u8_scale: Optional[float] = None) -> np.ndarray:
    """Batch assembly: out[r] = src[rows[r]] (u8 rows cast to f32 times
    ``u8_scale`` when it is given).  f32, int64 and u8 sources run the
    native gathers; other dtypes index with numpy, as the reference."""
    lib = load_library()
    rows = np.ascontiguousarray(rows, np.int64)
    n = rows.shape[0]
    row_shape = src.shape[1:]
    row_elems = int(np.prod(row_shape)) if row_shape else 1
    if len(rows) and (int(rows.min()) < 0 or int(rows.max()) >= len(src)):
        raise ValueError(f"gather_rows: a row index is outside "
                         f"[0, {len(src)})")
    src = np.ascontiguousarray(src)
    if src.dtype == np.uint8 and u8_scale is not None:
        if out is None:
            out = np.empty((n,) + row_shape, np.float32)
        lib.ptpu_gather_u8_to_f32(src.ctypes.data_as(_u8p),
                                  rows.ctypes.data_as(_i64p), n, row_elems,
                                  out.ctypes.data_as(_f32p),
                                  ctypes.c_float(u8_scale))
        return out
    if src.dtype == np.float32:
        if out is None:
            out = np.empty((n,) + row_shape, np.float32)
        lib.ptpu_gather_f32(src.ctypes.data_as(_f32p),
                            rows.ctypes.data_as(_i64p), n, row_elems,
                            out.ctypes.data_as(_f32p))
        return out
    if src.dtype == np.int64:
        if out is None:
            out = np.empty((n,) + row_shape, np.int64)
        lib.ptpu_gather_i64(src.ctypes.data_as(_i64p),
                            rows.ctypes.data_as(_i64p), n, row_elems,
                            out.ctypes.data_as(_i64p))
        return out
    batch = src[rows]
    if u8_scale is not None:
        batch = batch.astype(np.float32) * u8_scale
    if out is not None:
        out[...] = batch
        return out
    return batch


def scatter_axpy(values: np.ndarray, slots: np.ndarray, grads: np.ndarray,
                 alpha: float) -> bool:
    """Lock-free ``values[slots[i]] += alpha * grads[i]`` in the native
    engine with the GIL released (ctypes drops it for the call): the
    hogwild push.  Negative slots are skipped.  Returns True (the JAX
    package's return says whether its engine was there)."""
    lib = load_library()
    # hard validation (not asserts): a shape mismatch here would be
    # silent native heap corruption, not a python error
    if values.dtype != np.float32 or not values.flags.c_contiguous:
        raise ValueError("scatter_axpy: values must be C-contiguous f32")
    grads = np.ascontiguousarray(grads, np.float32)
    slots = np.ascontiguousarray(slots, np.int64)
    dim = values.shape[1] if values.ndim > 1 else 1
    if grads.reshape(-1).shape[0] != len(slots) * dim:
        raise ValueError(
            f"scatter_axpy: grads size {grads.size} != "
            f"len(slots) {len(slots)} x row dim {dim}")
    n_rows = values.shape[0] if values.ndim > 1 else values.shape[0] // dim
    if len(slots) and int(slots.max(initial=-1)) >= n_rows:
        raise ValueError(
            f"scatter_axpy: slot {int(slots.max())} out of range "
            f"({n_rows} rows)")
    lib.ptpu_scatter_axpy(values.ctypes.data_as(_f32p), dim,
                          slots.ctypes.data_as(_i64p), len(slots), dim,
                          grads.ctypes.data_as(_f32p), ctypes.c_float(alpha))
    return True

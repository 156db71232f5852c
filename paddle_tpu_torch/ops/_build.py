"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library under ``ops/build/`` (listed in ``.gitignore``), named by
a hash of the source, the headers beside it (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one loads
in milliseconds.  The build runs at first use — the
first call of a kernel wrapper on a CUDA tensor — never at import time.
Without ``nvcc`` it raises: there is no fallback to the plain PyTorch
version for a CUDA tensor.

``torch.utils.cpp_extension`` is deliberately not used: a source that
includes PyTorch's headers takes minutes to compile, a plain C one
seconds.  :func:`load_libraries` starts one ``nvcc`` per source at once,
so the set builds in the time of its slowest member.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

__all__ = ["NVCC_FLAGS", "KERNEL_SOURCES", "load_library", "load_libraries",
           "build_log", "nvcc_path"]

# every kernel source of the port, by library name (csrc/<name>.cu)
KERNEL_SOURCES = ("paged_attention", "paged_attention_stats", "paged_decode",
                  "quantized_matmul", "flash_attention", "scale_shift")

_OPS_DIR = Path(__file__).resolve().parent
_SRC_DIR = _OPS_DIR / "csrc"
_BUILD_DIR = _OPS_DIR / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds", "cached", "path", "ptxas"}: what each build did,
# read by chip_smoke.py to report build time and register use
build_log: Dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler, or a RuntimeError naming what is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of paddle_tpu_torch are built from source at first "
        "use and have no fallback on a CUDA tensor")


def _compile(name: str, src: Path, out: Path) -> List[str]:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)             # atomic: concurrent builds agree
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "ptxas" in ln or "spill" in ln]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.
    Builds of different sources may run concurrently."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = _SRC_DIR / f"{name}.cu"
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(_SRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()
        out = _BUILD_DIR / f"lib{name}_{digest[:16]}.so"
        t0 = time.perf_counter()
        cached = out.exists()
        ptxas: List[str] = []
        if not cached:
            ptxas = _compile(name, src, out)
        lib = ctypes.CDLL(str(out))
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "cached": cached, "path": str(out),
                           "ptxas": ptxas}
        _LIBS[name] = lib
        return lib


def load_libraries(names=KERNEL_SOURCES) -> Dict[str, ctypes.CDLL]:
    """Build and load several sources, one ``nvcc`` each, all started
    together; raises the first build error."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        libs = list(pool.map(load_library, names))
    return dict(zip(names, libs))

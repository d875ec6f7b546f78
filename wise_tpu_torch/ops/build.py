"""Build and bind the port's CUDA kernels.

At first use the sources in ``wise_tpu_torch/csrc/*.cu`` compile with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
cached under ``build/kernels/`` at the root of the checkout and keyed by a
hash of the sources and flags. The library is loaded with ``ctypes``: every
pointer and the stream pass as ``c_void_p``; every entry point returns the
``cudaError_t`` of its launches, and :func:`check` raises on a non-zero one.

There is no fallback: a CUDA machine without ``nvcc`` raises.
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

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry point -> argument types (csrc/block_kernels.cu)
SIGNATURES = {
    "wt_attn_block": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P],
    "wt_mlp_block": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _P],
    "wt_attn_block_pooled": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                             _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
#: seconds nvcc took in this process (0.0 while only cached builds were used)
build_seconds = 0.0


def find_nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from wise_tpu_torch/csrc at first use and have no fallback"
    )


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"wise_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the cached library matches the sources."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")

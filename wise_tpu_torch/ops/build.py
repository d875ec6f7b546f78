"""Build and bind the port's CUDA kernels.

At first use the sources in ``wise_tpu_torch/csrc/*.cu`` compile with
``nvcc`` for ``sm_90a``, one process per source, all started together, and
link into one shared library with a plain C interface, cached under
``build/kernels/`` at the root of the checkout and keyed by a hash of the
sources (headers included) and flags. The library is loaded with ``ctypes``:
every pointer and the stream pass as ``c_void_p``; every entry point returns
the ``cudaError_t`` of its launches, and :func:`check` raises on a non-zero
one. :class:`LaunchCounter` counts the launches each wrapper makes.

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
    "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point -> argument types (csrc/block_kernels.cu, postln_kernels.cu,
#: swin_kernels.cu, topk_kernels.cu)
SIGNATURES = {
    "wt_attn_block": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P],
    "wt_attn_block_res": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P],
    "wt_mlp_block": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _P],
    "wt_mlp_block_res": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _P],
    "wt_mlp_fc": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "wt_mlp_fc_res": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "wt_mlp_proj": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    "wt_attn_block_pooled": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                             _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "wt_attention_pooled": [_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                            _P],
    "wt_short_attention": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                           _F, _P],
    "wt_attn_block_partial": [_P, _I] + [_P] * 9 + [_I] * 7 + [_P],
    "wt_attn_block_pooled_partial": [_P, _I] + [_P] * 6 + [_I] + [_P] * 6
                                    + [_I] * 7 + [_P],
    "wt_mlp_proj_partial": [_P, _P, _P, _I, _I, _I, _P],
    "wt_ln_matmul": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "wt_residual_matmul": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    "wt_embed_attn_block": [_P] * 12 + [_I] + [_P] * 5 + [_I] * 6 + [_P],
    "wt_postln_attn_block": [_P] * 12 + [_I] * 4 + [_P],
    "wt_postln_mlp_block": [_P] * 10 + [_I] * 4 + [_P],
    "wt_postln_fc": [_P] * 4 + [_I] * 4 + [_P],
    "wt_postln_proj": [_P] * 8 + [_I] * 3 + [_P],
    "wt_swin_fused_max_width": [],
    "wt_window_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                            _I, _I, _I, _I, _P, _P],
    "wt_swin_block": [_P, _P, _I] + [_P] * 8 + [_I] + [_P] * 12 + [_I] * 5
                     + [_P, _P],
    "wt_topk_threshold": [_P, _P, _I] + [_P] * 5 + [_I] * 8 + [_P, _P],
    "wt_topk_gemm": [_P, _I, _I, _P, _I, _P, _P],
    "wt_topk_gemm_f32": [_P, _I, _I, _P, _I, _I, _P, _P],
    "wt_topk_select": [_P] + [_I] * 7 + [_P, _P, _I, _I, _P, _P],
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


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the cached library matches the sources."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{so.stem}.{os.getpid()}"
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)])
        tmp = BUILD_DIR / f"{tag}.tmp"
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print(log)
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


def refuse_grad(name: str, tensors, instead: str) -> None:
    """Raise where a kernel wrapper is called on the card under autograd with
    an input that requires a gradient: the kernel writes through raw
    pointers, so its output would carry no graph and a backward through it
    would stop there without a word. ``instead`` says what differentiates."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires a gradient, and the kernel's output "
            f"would be cut from the autograd graph; {instead}")


class LaunchCounter:
    """Kernel launches since the last :meth:`reset`, per wrapper (``counts``)
    and per (wrapper, *shape) (``by_shape``). Request threads may launch
    concurrently, so updates take a lock; both dicts keep their identity."""

    def __init__(self, *names: str):
        self.counts = dict.fromkeys(names, 0)
        self.by_shape: dict = {}
        self._lock = threading.Lock()

    def add(self, name: str, *shape: int) -> None:
        with self._lock:
            self.counts[name] += 1
            key = (name, *shape)
            self.by_shape[key] = self.by_shape.get(key, 0) + 1

    def reset(self) -> None:
        with self._lock:
            for name in self.counts:
                self.counts[name] = 0
            self.by_shape.clear()

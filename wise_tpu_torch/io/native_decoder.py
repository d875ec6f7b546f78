"""ctypes bindings for the native FFmpeg decoder (wise_tpu_torch/native).

The shared library is built from ``native/decoder.cpp`` at first use into
``build/native/`` at the root of the checkout (the directory the CUDA
kernels build into, never the source tree), under a name keyed by a hash of
the source; callers fall back to the OpenCV/wave backends in decode.py when
the toolchain or FFmpeg's headers are missing.

Copy of ``wise_tpu/io/native_decoder.py``, with a build directory of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "decoder.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LDLIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lswresample")

_lib = None
_load_attempted = False


def library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libwisedecoder_{digest}.so"


def _try_build(out: Path) -> bool:
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O2", "-fPIC", "-std=c++17",
             "-shared", "-o", str(tmp), str(_SOURCE), *_LDLIBS],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)  # atomic: a concurrent process never loads half
        return True
    except Exception as e:  # pragma: no cover - toolchain missing
        logger.warning(f"native decoder build failed: {e}")
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    path = library_path()
    if not path.exists() and not _try_build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:  # pragma: no cover
        logger.warning(f"native decoder load failed: {e}")
        return None
    lib.wise_decoder_open.restype = ctypes.c_void_p
    lib.wise_decoder_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
    ]
    lib.wise_decoder_close.argtypes = [ctypes.c_void_p]
    lib.wise_decoder_info.restype = ctypes.c_int
    lib.wise_decoder_info.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(t)
        for t in (
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        )
    ]
    lib.wise_decoder_read_video.restype = ctypes.c_int
    lib.wise_decoder_read_video.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.wise_decoder_read_audio.restype = ctypes.c_int
    lib.wise_decoder_read_audio.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


class NativeDecoder:
    """RAII wrapper over the C API. mode: 0 video, 1 audio, 2 probe."""

    def __init__(self, path, mode: int, fps: float = 0.0, sample_rate: int = 0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native decoder unavailable")
        self._lib = lib
        self._h = lib.wise_decoder_open(
            str(path).encode(), int(mode), float(fps), int(sample_rate)
        )
        if not self._h:
            raise IOError(f"failed to open {path} (mode={mode})")

    def info(self):
        vals = (
            ctypes.c_double(), ctypes.c_int(), ctypes.c_int(), ctypes.c_double(),
            ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
            ctypes.c_int(),
        )
        self._lib.wise_decoder_info(self._h, *[ctypes.byref(v) for v in vals])
        return {
            "duration": vals[0].value,
            "width": vals[1].value,
            "height": vals[2].value,
            "fps": vals[3].value,
            "num_frames": vals[4].value,
            "has_video": bool(vals[5].value),
            "has_audio": bool(vals[6].value),
            "sample_rate": vals[7].value,
            "channels": vals[8].value,
        }

    def read_video(self, max_frames: int, width: int, height: int):
        """Returns (frames (n,H,W,3) uint8, pts (n,)) or (None, None) at EOF."""
        buf = np.empty((max_frames, height, width, 3), dtype=np.uint8)
        pts = np.empty(max_frames, dtype=np.float64)
        n = self._lib.wise_decoder_read_video(
            self._h,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            max_frames,
        )
        if n < 0:
            raise IOError(f"video decode error ({n})")
        if n == 0:
            return None, None
        return buf[:n], pts[:n]

    def read_audio(self, max_samples: int):
        """Returns (samples (n,) float32, pts_start) or (None, None) at EOF."""
        buf = np.empty(max_samples, dtype=np.float32)
        pts0 = ctypes.c_double()
        n = self._lib.wise_decoder_read_audio(
            self._h,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(pts0),
            max_samples,
        )
        if n < 0:
            raise IOError(f"audio decode error ({n})")
        if n == 0:
            return None, None
        return buf[:n], pts0.value

    def close(self):
        if getattr(self, "_h", None):
            self._lib.wise_decoder_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""FeatureExtractor interface.

Same method surface as the reference ABC (ox-vgg/WISE/src/feature/
feature_extractor.py:6-59) but framework-native: inputs/outputs are numpy
arrays (NHWC uint8/float images, float32 waveforms); all extract_* methods
return L2-normalised float32 ``np.ndarray`` of shape (N, dim). Device work
(preprocessing + encoder forward) happens inside the concrete extractor, on
the card. ``DeviceArray`` is the unrealised result of a dispatch-only embed.

Copy of ``wise_tpu/models/feature_extractor.py``, with DeviceArray added.
"""

from __future__ import annotations

from typing import List

import numpy as np


class FeatureExtractor:
    #: embedding dimensionality; set by concrete classes after model init
    output_dim: int = -1
    #: (H, W) expected by preprocess_image, where applicable
    input_size = None
    #: modality capabilities (pipelines validate these up front)
    supports_image: bool = True
    supports_text: bool = True
    supports_audio: bool = True

    def __init__(self):
        raise NotImplementedError

    # -- image / video frames ---------------------------------------------
    def preprocess_image(self, images) -> np.ndarray:
        """images: list of HWC uint8 arrays (any size) or an (N,H,W,C) array.
        Returns model-ready (N,H,W,C) float array."""
        raise NotImplementedError

    def extract_image_features(self, images: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- text ---------------------------------------------------------------
    def preprocess_text(self, text: str) -> str:
        return text

    def extract_text_features(self, text_query: List[str]) -> np.ndarray:
        raise NotImplementedError

    # -- audio --------------------------------------------------------------
    def preprocess_audio(self, audio) -> np.ndarray:
        """audio: (C, T) or (T,) float waveform(s) at the extractor's expected
        sampling rate. Returns model-ready batch."""
        raise NotImplementedError

    def extract_audio_features(self, preprocessed_audio: np.ndarray) -> np.ndarray:
        raise NotImplementedError


def l2_normalize(x: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    norm = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(norm, eps)


class BucketPolicy:
    """Pick padded batch sizes so the device sees few shapes. Prefers reusing an
    already-compiled bucket over compiling a smaller one (tail batches ride
    the big batch's executable instead of triggering fresh compiles — remote
    compiles can cost minutes)."""

    def __init__(self, buckets=(1, 8, 32, 128, 256, 512)):
        self.buckets = tuple(sorted(buckets))
        self.compiled = set()

    def pick(self, n: int) -> int:
        compiled_fit = [b for b in self.compiled if b >= n]
        if compiled_fit:
            return min(compiled_fit)
        for b in self.buckets:
            if b >= n:
                self.compiled.add(b)
                return b
        b = -(-n // self.buckets[-1]) * self.buckets[-1]
        self.compiled.add(b)
        return b


class DeviceArray:
    """Rows of a device tensor that realise on the host only when numpy asks
    (``np.asarray``). The serving coalescer (api/engine.py) slices
    a dispatched batch per request and realises each slice outside its
    lock, so the forwards of successive batches queue on the card while
    earlier readbacks wait."""

    def __init__(self, tensor):
        self.tensor = tensor

    def __getitem__(self, idx):
        return DeviceArray(self.tensor[idx])

    def __array__(self, dtype=None, copy=None):
        arr = self.tensor.detach().float().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)

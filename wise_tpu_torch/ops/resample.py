"""Linear waveform resampling as a gather + lerp (wise_tpu/ops/resample.py).

The sample positions are the JAX package's to the last bit: its float32
``jnp.linspace(0, n_in - 1, n_out)``, as XLA compiles it, is position
i = ``i * float32((n_in - 1) / (n_out - 1))`` in float32, and the port forms
the same products in numpy float32, so ``floor(pos)`` and the interpolation
weights agree with the reference (positions rounded any other way, in
float64 or as ``float32(i / (n_out - 1)) * (n_in - 1)``, differ in the last
bit at about half the samples and shift some ``floor(pos)`` by one).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _taps(n_in: int, n_out: int, device: torch.device):
    """(i0, i1, frac) of each output sample, on ``device``."""
    if n_out == 1:
        pos = np.zeros(1, np.float32)
    else:
        delta = np.float32(n_in - 1) / np.float32(n_out - 1)
        pos = np.append(np.arange(n_out - 1, dtype=np.float32) * delta,
                        np.float32(n_in - 1)).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = (pos - i0.astype(np.float32)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (i0, i1, frac))


def resample_linear(wav: torch.Tensor, n_out: int) -> torch.Tensor:
    """wav (B, T) -> (B, n_out) by linear interpolation over [0, T-1]."""
    i0, i1, frac = _taps(wav.shape[1], n_out, wav.device)
    frac = frac.to(wav.dtype)
    return wav[:, i0] * (1.0 - frac) + wav[:, i1] * frac

"""Log-mel spectrogram with the DFT as two GEMMs (wise_tpu/ops/mel.py).

librosa conventions as CLAP/HTSAT use them: centre (reflect) padding, a
periodic hann window folded into the cos/sin DFT bases, the power spectrum,
a Slaney mel filterbank with Slaney normalisation, and
``10 * log10(max(mel, 1e-10))``. Framing is a strided view of the padded
waveform (no gather); the DFT and the mel projection are f32 matrix
products. The filterbank and basis helpers are numpy, copied from the
reference module (which imports jax at its top).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel,
        min_log_hz * np.exp(logstep * (m - min_log_mel)),
        freqs,
    )


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: Optional[str] = "slaney") -> np.ndarray:
    """(n_mels, n_fft//2+1) float32, librosa-compatible triangular filters."""
    fmax = fmax if fmax is not None else sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def dft_bases(n_fft: int) -> tuple:
    """Real/imag DFT bases for the positive-frequency half, with the hann
    window folded in: (n_fft, n_bins) each."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)
    k = np.arange(n_bins)
    ang = -2.0 * np.pi * np.outer(t, k) / n_fft
    window = np.hanning(n_fft + 1)[:-1]  # periodic hann, matches librosa
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


@functools.lru_cache(maxsize=8)
def _bases(sr, n_fft, n_mels, fmin, fmax, htk, device):
    """(cos (n_fft, n_bins), sin, filterbank^T (n_bins, n_mels)) on device."""
    cos_b, sin_b = dft_bases(n_fft)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cos_b, sin_b, fb.T))


def log_mel_spectrogram(waveform: torch.Tensor, sr: int = 44100,
                        n_fft: int = 1024, hop_length: int = 320,
                        n_mels: int = 64, fmin: float = 50.0,
                        fmax: float = 14000.0,
                        htk: bool = False) -> torch.Tensor:
    """waveform (B, T) float32 -> (B, frames, n_mels) float32 log-mel,
    frames = T // hop_length + 1 (centre-padded, librosa framing)."""
    if waveform.dim() == 1:
        waveform = waveform[None]
    pad = n_fft // 2
    x = F.pad(waveform.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop_length)  # (B, T // hop + 1, n_fft)
    cos_b, sin_b, fb_t = _bases(sr, n_fft, n_mels, float(fmin), float(fmax),
                                htk, waveform.device)
    re = frames @ cos_b
    im = frames @ sin_b
    mel = (re * re + im * im) @ fb_t
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))

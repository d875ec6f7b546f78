"""CLAP feature extractor on the port's towers
(wise_tpu/models/clap/extractor.py).

Same id scheme (``microsoft/clap/<version>/<variant>``, version 2023 or
2022), same checkpoint search (``*.npz``, ``*.pth``, ``*.pt`` under
``$WISE_CHECKPOINT_DIR/clap/<version>/<variant>/``; the port reads msclap
``.pth``/``.pt`` and raises for a flax ``.npz``), same caption vocabulary
staging by tower family (GPT2 ``vocab.json`` + ``merges.txt`` for 2023,
BERT ``vocab.txt`` for 2022) with the hash-tokenizer fallback, same batch
buckets and
L2-normalised float32 outputs. Without a checkpoint the towers take seeded
random weights, with a warning. Waveforms arrive at the pipeline's 48 kHz
and move to the device as float32; the resample to the model's 44.1 kHz,
the tiling to its fixed duration, the log-mel and both towers run there.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ...ops.mel import log_mel_spectrogram
from ...ops.resample import resample_linear
from ...utils.device import default_device
from ..feature_extractor import BucketPolicy, DeviceArray, FeatureExtractor
from .config import production_clap_config
from .convert import load_checkpoint
from .model import CLAP, init_random_
from .tokenizer import get_caption_tokenizer

logger = logging.getLogger(__name__)

PIPELINE_SAMPLE_RATE = 48_000


def _checkpoint_dir(version: str, variant: str) -> Path:
    root = os.environ.get(
        "WISE_CHECKPOINT_DIR",
        str(Path.home() / ".cache" / "wise_tpu" / "checkpoints"),
    )
    return Path(root) / "clap" / version / variant


def _find_checkpoint(d: Path) -> Optional[Path]:
    if not d.exists():
        return None
    for pat in ("*.npz", "*.pth", "*.pt"):
        hits = sorted(d.glob(pat))
        if hits:
            return hits[0]
    return None


class ClapExtractor(FeatureExtractor):
    supports_image = False

    def __init__(self, id: str, device=None):
        tok = id.split("/")
        if len(tok) != 4 or not id.startswith("microsoft/clap/"):
            raise ValueError(f"invalid clap extractor id {id}")
        self.id = id
        self.version, self.variant = tok[2], tok[3]
        self.device = torch.device(device) if device else default_device()
        self.config = c = production_clap_config(self.version)
        self.output_dim = c.joint_dim
        self.target_samples = int(c.sample_rate * c.duration)

        model = CLAP(c)
        ckpt_dir = _checkpoint_dir(self.version, self.variant)
        ckpt = _find_checkpoint(ckpt_dir)
        if ckpt is not None:
            logger.info(f"loading CLAP checkpoint {ckpt}")
            model.load_state_dict(load_checkpoint(ckpt, c))
        else:
            logger.warning(
                f"no checkpoint for {id} under {ckpt_dir}; using random "
                "weights (pipeline runs, retrieval quality needs real weights)"
            )
            init_random_(model, seed=0)
        self.model = model.to(self.device).eval().requires_grad_(False)
        # the caption tower's own tokenizer (2023: GPT2 byte-level BPE from
        # vocab.json + merges.txt; 2022: BERT WordPiece from vocab.txt), else
        # the deterministic hash tokenizer
        self.tokenizer = get_caption_tokenizer(
            ckpt_dir if ckpt_dir.exists() else None,
            vocab_size=c.vocab_size, context_length=c.context_length,
            kind=c.text_encoder_type)
        self._audio_buckets = BucketPolicy((1, 4, 16, 64))
        self._text_buckets = BucketPolicy((1, 4, 16, 64))

    # ------------------------------------------------------------------
    def preprocess_audio(self, audio) -> np.ndarray:
        """audio: (T,) or (B, T) float waveform(s) at 48 kHz -> (B, T)."""
        a = np.asarray(audio, dtype=np.float32)
        return a[None] if a.ndim == 1 else a

    def log_mel(self, wav):
        """(B, T) float32 device tensor at 48 kHz -> (B, frames, n_mels)
        f32: resample to the model rate, tile or crop to its duration,
        log-mel."""
        c = self.config
        n_out = int(round(wav.shape[1] * c.sample_rate / PIPELINE_SAMPLE_RATE))
        x = resample_linear(wav, n_out)
        if n_out < self.target_samples:
            x = x.repeat(1, -(-self.target_samples // n_out))
        return log_mel_spectrogram(
            x[:, :self.target_samples], sr=c.sample_rate, n_fft=c.n_fft,
            hop_length=c.hop_length, n_mels=c.n_mels, fmin=c.fmin,
            fmax=c.fmax)

    def encode_waveforms(self, wav):
        """(B, T) float32 device tensor at 48 kHz -> (B, joint_dim) f32:
        log-mel, audio tower, projection, L2 normalisation."""
        return self.model.encode_audio(self.log_mel(wav))

    @torch.inference_mode()
    def extract_audio_features_dispatch(self, preprocessed_audio):
        """Device half of ``extract_audio_features``: the (n, D) embedding
        stays on the device until numpy reads it."""
        a = self.preprocess_audio(preprocessed_audio)
        n = a.shape[0]
        m = self._audio_buckets.pick(n)
        if m != n:
            a = np.concatenate([a, np.zeros((m - n, a.shape[1]), np.float32)])
        x = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return DeviceArray(self.encode_waveforms(x)[:n])

    def extract_audio_features(self, preprocessed_audio) -> np.ndarray:
        return np.asarray(
            self.extract_audio_features_dispatch(preprocessed_audio),
            dtype=np.float32)

    @torch.inference_mode()
    def extract_text_features_dispatch(self, text_query: List[str]):
        enc = self.tokenizer(list(text_query))
        if isinstance(enc, tuple):
            # GPT2: lengths from the attention mask (pad id 0 is '!', a real
            # token, so counting nonzeros would miscount)
            tokens, lengths = enc
        else:
            tokens = enc
            lengths = (tokens != 0).sum(axis=1).astype(np.int32)
        n = tokens.shape[0]
        m = self._text_buckets.pick(n)
        if m != n:
            tokens = np.concatenate(
                [tokens, np.zeros((m - n, tokens.shape[1]), tokens.dtype)])
            lengths = np.concatenate([lengths, np.ones(m - n, np.int32)])
        t = torch.from_numpy(tokens.astype(np.int64)).to(self.device)
        ln = torch.from_numpy(np.asarray(lengths, np.int64)).to(self.device)
        return DeviceArray(self.model.encode_text(t, ln)[:n])

    def extract_text_features(self, text_query: List[str]) -> np.ndarray:
        return np.asarray(self.extract_text_features_dispatch(text_query),
                          dtype=np.float32)

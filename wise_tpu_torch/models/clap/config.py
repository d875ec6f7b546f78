"""CLAP configurations, without JAX.

The fields of wise_tpu/models/clap/model.py ``CLAPConfig`` for the msclap
2023 towers (HTSAT audio, GPT2 caption) with ``dtype`` as a name
("float32" or "bfloat16"), and the port's kernel switches. The 2022 towers
(CNN14 audio, BERT caption) wait for their port (ROADMAP Queue A item 10).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CLAPConfig:
    joint_dim: int = 1024
    # audio (HTSAT-base shapes)
    sample_rate: int = 44100
    duration: float = 7.0
    n_fft: int = 1024
    hop_length: int = 320
    n_mels: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    spec_frames: int = 1024      # mel frames after pad/crop
    freq_ratio: int = 4          # time chunks stacked along frequency
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    #: tower families, as the reference names them (its msclap converter
    #: reads both); class constants: the port has the 2023 pair only
    audio_encoder_type = "htsat"
    text_encoder_type = "gpt2"
    # text (GPT2-small shapes)
    vocab_size: int = 50257
    context_length: int = 77
    text_width: int = 768
    text_heads: int = 12
    text_layers: int = 12
    #: GPT2 checkpoints use torch's 'gelu_new' (tanh approximation)
    text_act: str = "gelu_tanh"
    dtype: str = "float32"
    #: the caption tower's last layer computes only each caption's pooled
    #: row (its last real token)
    pool_last_block: bool = False
    #: run the blocks through the CUDA kernels (ops/swin_block.py,
    #: ops/swin_attention.py, ops/block.py); off, the same blocks run their
    #: plain PyTorch versions
    fused_block: bool = False
    #: HTSAT blocks as one whole-block op on window-layout activations in the
    #: bf16 stream (the JAX package's WISE_FUSED_SWIN_BLOCK path); off, the
    #: block keeps an f32 stream around a window-attention op
    fused_swin_block: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.dtype]


CLAP_CONFIGS = {"2023": CLAPConfig()}


def get_clap_config(version: str) -> CLAPConfig:
    if version in CLAP_CONFIGS:
        return CLAP_CONFIGS[version]
    if version == "2022":
        raise NotImplementedError(
            "CLAP 2022 (CNN14 audio + BERT caption towers) is not ported to "
            "PyTorch yet (ROADMAP Queue A item 10)")
    raise ValueError(
        f"unknown CLAP version {version}; the port knows "
        f"{sorted(CLAP_CONFIGS)}")


def production_clap_config(version: str) -> CLAPConfig:
    """The extractor's inference config, read from the same environment
    variables as wise_tpu's: bf16 activations by default
    (WISE_CLAP_DTYPE=float32 to override), the pooled caption layer
    (WISE_POOL_LAST=0) and the whole-block HTSAT path
    (WISE_FUSED_SWIN_BLOCK=0 for the window-attention path); and, as for the
    port's CLIP, WISE_FUSED_BLOCK=0 to run every block's plain version. The
    kernel paths need bf16, as the JAX package's do."""
    cfg = get_clap_config(version)
    bf16 = os.environ.get("WISE_CLAP_DTYPE", "bfloat16") == "bfloat16"
    return dataclasses.replace(
        cfg,
        dtype="bfloat16" if bf16 else "float32",
        pool_last_block=os.environ.get("WISE_POOL_LAST", "1") != "0",
        fused_block=bf16 and os.environ.get("WISE_FUSED_BLOCK", "1") != "0",
        fused_swin_block=bf16 and os.environ.get("WISE_FUSED_SWIN_BLOCK",
                                                 "1") != "0",
    )

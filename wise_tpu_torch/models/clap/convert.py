"""msclap checkpoint -> the port's CLAP state_dict (best-effort).

Sub-mappings are torch-parity-verified in tests:
- GPT2 caption tower (Conv1D fused qkv; tests/test_clap_torch_parity.py)
- Swin blocks + patch merging (tests/test_swin_torch_parity.py)
- Projection heads (linear1/linear2/layer_norm naming as in msclap)

Caveats, surfaced as warnings at load time until validated against a real
msclap checkpoint (ROADMAP item 2):
- the reference HTSAT applies BatchNorm over mel bins (bn0) and a
  time->frequency reshape before patch embedding; our encoder uses a fixed
  affine — converted audio embeddings are therefore approximate;
- HTSAT's token-semantic (tscam) head is not part of the CLAP latent path
  and is ignored;
- key prefixes are auto-detected (msclap wraps towers as
  ``caption_encoder.base.*`` / ``audio_encoder.base.*``).

The 2022 towers convert exactly (no warning): BERT's per-layer
``{query, key, value}`` stay three Dense layers (``from_flax_params`` merges
only the XLM-R tower's ``self.{query, key, value}``), CNN14's convolution
kernels keep the flax HWIO layout and every BatchNorm folds into its affine
pair.

The converters return the reference's parameter tree as numpy arrays;
``from_flax_params`` (models/clip/convert.py) carries it onto the port's
state_dict, and ``load_msclap_state_dict`` / ``load_checkpoint`` end in it.

Copy of ``wise_tpu/models/clap/convert.py``, with the two loaders added.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..clip.convert import from_flax_params

logger = logging.getLogger(__name__)


def _detect_prefix(sd: Dict, suffix: str) -> str:
    """Find the key prefix P such that P+suffix exists (e.g. suffix
    'wte.weight' -> 'caption_encoder.base.')."""
    for k in sd:
        if k.endswith(suffix):
            return k[: -len(suffix)]
    raise KeyError(f"no key ending with {suffix!r} in checkpoint")


def _dense(sd, prefix, transpose=True):
    w = np.asarray(sd[prefix + ".weight"], dtype=np.float32)
    return {
        "kernel": w.T if transpose else w,
        "bias": np.asarray(sd[prefix + ".bias"], dtype=np.float32),
    }


def _ln(sd, prefix):
    return {
        "scale": np.asarray(sd[prefix + ".weight"], dtype=np.float32),
        "bias": np.asarray(sd[prefix + ".bias"], dtype=np.float32),
    }


def _projection(sd, prefix):
    return {
        "linear1": _dense(sd, prefix + ".linear1"),
        "linear2": _dense(sd, prefix + ".linear2"),
        "layer_norm": _ln(sd, prefix + ".layer_norm"),
    }


def convert_caption_tower(sd: Dict, config) -> Dict:
    """GPT2 (msclap caption_encoder.base) -> CaptionEncoder params.

    The real checkpoint's ``wpe`` is the full GPT2 position table
    (1024, width) while the tower only reads ``context_length`` rows —
    slice, don't reject. ``wte`` may likewise carry more rows than
    ``config.vocab_size`` (tokenizers that append a pad token); extra
    rows are unreachable by real token ids, so slicing is exact."""
    p = _detect_prefix(sd, "wte.weight")
    wte = np.asarray(sd[p + "wte.weight"], np.float32)
    wpe = np.asarray(sd[p + "wpe.weight"], np.float32)
    if wte.shape[0] < config.vocab_size:
        raise ValueError(
            f"checkpoint wte has {wte.shape[0]} rows < configured "
            f"vocab_size {config.vocab_size}"
        )
    if wpe.shape[0] < config.context_length:
        raise ValueError(
            f"checkpoint wpe has {wpe.shape[0]} rows < configured "
            f"context_length {config.context_length}"
        )
    params = {
        "token_embedding": wte[: config.vocab_size],
        "positional_embedding": wpe[: config.context_length],
        "ln_f": _ln(sd, p + "ln_f"),
        "transformer": {},
    }
    for i in range(config.text_layers):
        b = f"{p}h.{i}"
        params["transformer"][f"resblocks_{i}"] = {
            "ln_1": _ln(sd, b + ".ln_1"),
            "ln_2": _ln(sd, b + ".ln_2"),
            "attn": {
                # GPT2 Conv1D weight is (in, out) == flax Dense kernel
                "in_proj": _dense(sd, b + ".attn.c_attn", transpose=False),
                "out_proj": _dense(sd, b + ".attn.c_proj", transpose=False),
            },
            "mlp_fc": _dense(sd, b + ".mlp.c_fc", transpose=False),
            "mlp_proj": _dense(sd, b + ".mlp.c_proj", transpose=False),
        }
    return params


def convert_bert_caption_tower(sd: Dict, config) -> Dict:
    """HF bert-base-uncased (msclap-2022 caption_encoder.base) ->
    BertCaptionEncoder params. The pooler head (``pooler.dense.*``) is
    deliberately dropped: msclap pools the raw last hidden state at
    [CLS] (TextEncoder.forward takes ``base(**x)[0][:, 0, :]``), so the
    pooler weights never execute."""
    p = _detect_prefix(sd, "embeddings.word_embeddings.weight")
    emb = p + "embeddings."
    word = np.asarray(sd[emb + "word_embeddings.weight"], np.float32)
    pos = np.asarray(sd[emb + "position_embeddings.weight"], np.float32)
    typ = np.asarray(sd[emb + "token_type_embeddings.weight"], np.float32)
    if word.shape[0] < config.vocab_size:
        raise ValueError(
            f"checkpoint word embeddings have {word.shape[0]} rows < "
            f"configured vocab_size {config.vocab_size}"
        )
    params = {
        "word_embeddings": word[: config.vocab_size],
        "position_embeddings": pos[: config.text_max_positions],
        "token_type_embeddings": typ[: config.text_type_vocab],
        "emb_ln": _ln(sd, emb + "LayerNorm"),
    }
    for i in range(config.text_layers):
        b = f"{p}encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "query": _dense(sd, b + ".attention.self.query"),
            "key": _dense(sd, b + ".attention.self.key"),
            "value": _dense(sd, b + ".attention.self.value"),
            "attn_out": _dense(sd, b + ".attention.output.dense"),
            "attn_ln": _ln(sd, b + ".attention.output.LayerNorm"),
            "intermediate": _dense(sd, b + ".intermediate.dense"),
            "output": _dense(sd, b + ".output.dense"),
            "out_ln": _ln(sd, b + ".output.LayerNorm"),
        }
    return params


def _fold_bn(sd, prefix, eps=1e-5):
    """Inference-mode BatchNorm -> (scale, bias) affine pair."""
    mean = np.asarray(sd[prefix + ".running_mean"], np.float32)
    var = np.asarray(sd[prefix + ".running_var"], np.float32)
    gamma = np.asarray(sd[prefix + ".weight"], np.float32)
    beta = np.asarray(sd[prefix + ".bias"], np.float32)
    scale = gamma / np.sqrt(var + eps)
    return scale, beta - mean * scale


def convert_cnn14_audio_tower(sd: Dict, config) -> Dict:
    """PANNs Cnn14 (msclap-2022 audio_encoder.base) -> Cnn14Encoder
    params. Every BatchNorm (bn0 over mel bins and the per-conv bn1/bn2)
    folds exactly into the affine pairs the Flax tower declares, so the
    conversion is exact (no HTSAT-style best-effort caveat). The STFT/
    mel-filterbank buffers (``spectrogram_extractor``/``logmel_extractor``)
    and the AudioSet classification head (``fc_audioset``) never execute
    in the CLAP latent path and are dropped."""
    p = _detect_prefix(sd, "conv_block1.conv1.weight")
    bn0_scale, bn0_bias = _fold_bn(sd, p + "bn0")
    params: Dict = {"bn0_scale": bn0_scale, "bn0_bias": bn0_bias}
    for i in range(len(config.cnn14_channels)):
        blk = f"conv_block{i + 1}"
        for j in (1, 2):
            w = np.asarray(sd[f"{p}{blk}.conv{j}.weight"], np.float32)
            params[f"{blk}_conv{j}"] = {
                # torch conv (out, in, kh, kw) -> flax (kh, kw, in, out)
                "kernel": np.transpose(w, (2, 3, 1, 0))
            }
            s, t = _fold_bn(sd, f"{p}{blk}.bn{j}")
            params[f"{blk}_bn{j}_scale"] = s
            params[f"{blk}_bn{j}_bias"] = t
    params["fc1"] = _dense(sd, p + "fc1")
    return params


def convert_audio_tower(sd: Dict, config) -> Dict:
    """HTSAT Swin core (msclap audio_encoder.base) -> HTSATEncoder params.
    Maps patch embed, Swin blocks, and patch-merging; bn0/tscam are skipped
    (see module docstring)."""
    p = _detect_prefix(sd, "patch_embed.proj.weight")
    conv_w = np.asarray(sd[p + "patch_embed.proj.weight"], np.float32)
    # fold bn0 (BatchNorm over mel bins, inference mode) into the per-bin
    # affine: y = (x - mean) / sqrt(var + eps) * gamma + beta
    if p + "bn0.running_mean" in sd:
        mean = np.asarray(sd[p + "bn0.running_mean"], np.float32)
        var = np.asarray(sd[p + "bn0.running_var"], np.float32)
        gamma = np.asarray(sd[p + "bn0.weight"], np.float32)
        beta = np.asarray(sd[p + "bn0.bias"], np.float32)
        inv = gamma / np.sqrt(var + 1e-5)
        bn0_scale, bn0_bias = inv, beta - mean * inv
    else:
        bn0_scale = np.full((config.n_mels,), 1.0 / 40.0, np.float32)
        bn0_bias = np.ones((config.n_mels,), np.float32)
    params = {
        "bn0_scale": bn0_scale,
        "bn0_bias": bn0_bias,
        "patch_embed": {
            # torch conv (out, in, kh, kw) -> flax (kh, kw, in, out)
            "kernel": np.transpose(conv_w, (2, 3, 1, 0)),
            "bias": np.asarray(sd[p + "patch_embed.proj.bias"], np.float32),
        },
        "patch_norm": _ln(sd, p + "patch_embed.norm"),
        "norm": _ln(sd, p + "norm"),
    }
    for stage, depth in enumerate(config.depths):
        for blk in range(depth):
            b = f"{p}layers.{stage}.blocks.{blk}"
            params[f"stage{stage}_block{blk}"] = {
                "norm1": _ln(sd, b + ".norm1"),
                "norm2": _ln(sd, b + ".norm2"),
                "attn": {
                    "qkv": _dense(sd, b + ".attn.qkv"),
                    "proj": _dense(sd, b + ".attn.proj"),
                    "relative_position_bias_table": np.asarray(
                        sd[b + ".attn.relative_position_bias_table"],
                        np.float32,
                    ),
                },
                "mlp_fc1": _dense(sd, b + ".mlp.fc1"),
                "mlp_fc2": _dense(sd, b + ".mlp.fc2"),
            }
        if stage < len(config.depths) - 1:
            d = f"{p}layers.{stage}.downsample"
            params[f"merge{stage}"] = {
                "norm": _ln(sd, d + ".norm"),
                "reduction": {
                    "kernel": np.asarray(
                        sd[d + ".reduction.weight"], np.float32
                    ).T
                },
            }
    return params


def convert_msclap_state_dict(sd: Dict, config) -> Dict:
    """Full msclap CLAP state dict -> the reference's CLAP params tree. Tower
    families dispatch on the config (2023: GPT2 + HTSAT; 2022: BERT +
    CNN14 — msclap config_2022.yml)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    if config.audio_encoder_type == "htsat":
        logger.warning(
            "msclap conversion is best-effort: HTSAT bn0/reshape "
            "differences make audio embeddings approximate until "
            "validated against the reference implementation "
            "(ROADMAP item 2)"
        )
    cap_proj_prefix = _detect_prefix(sd, "linear1.weight")
    # disambiguate caption vs audio projection by substring
    cap_proj = next(
        (k[: -len("linear1.weight")] for k in sd
         if k.endswith("linear1.weight") and "caption" in k),
        cap_proj_prefix,
    )
    aud_proj = next(
        (k[: -len("linear1.weight")] for k in sd
         if k.endswith("linear1.weight") and "audio" in k),
        None,
    )
    caption = (
        convert_bert_caption_tower(sd, config)
        if config.text_encoder_type == "bert"
        else convert_caption_tower(sd, config)
    )
    audio = (
        convert_cnn14_audio_tower(sd, config)
        if config.audio_encoder_type == "cnn14"
        else convert_audio_tower(sd, config)
    )
    params = {
        "caption_encoder": caption,
        "audio_encoder": audio,
        "caption_projection": _projection(sd, cap_proj.rstrip(".")),
        "logit_scale": np.asarray(
            sd.get("logit_scale", np.log(1 / 0.07)), np.float32
        ),
    }
    if aud_proj:
        params["audio_projection"] = _projection(sd, aud_proj.rstrip("."))
    else:
        raise KeyError("audio projection keys not found in checkpoint")
    return params


def load_msclap_state_dict(sd, config) -> Dict[str, torch.Tensor]:
    """msclap state dict (tensors or arrays, msclap key names) -> the
    port's state_dict."""
    sd = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    return from_flax_params(convert_msclap_state_dict(sd, config))


def load_checkpoint(path, config) -> Dict[str, torch.Tensor]:
    path = Path(path)
    if path.suffix not in (".pth", ".pt"):
        raise NotImplementedError(
            f"{path}: a flax-serialized CLAP checkpoint needs flax to read; "
            "the port reads msclap .pth/.pt checkpoints (ROADMAP Queue A "
            "item 9, open part)")
    raw = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    return load_msclap_state_dict(raw, config)

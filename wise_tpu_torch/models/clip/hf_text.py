"""XLM-RoBERTa text tower in PyTorch (wise_tpu/models/clip/hf_text.py).

The reference's default video/image extractor is
``mlfoundations/open_clip/xlm-roberta-large-ViT-H-14/frozen_laion5b_s13b_b90k``,
whose text side is a HuggingFace XLM-RoBERTa encoder with mean pooling and a
bias-free projection (open_clip HFTextEncoder): post-LN BERT-style blocks,
learned positions with the RoBERTa offset convention, attention masking over
padding, mean pooling, projection to the joint space.

The parameter tree is the reference's (``word_embeddings``,
``position_embeddings``, ``emb_ln``, ``layer_{i}/{attn_out, attn_ln,
intermediate, output, out_ln}``, ``proj`` or ``proj_fc`` + ``proj_out``) with
one difference: a layer's separate ``self/{query, key, value}`` projections
are stored as one ``qkv`` Dense (D, 3D), the layout the attention kernel
takes. ``convert.from_flax_params`` concatenates them once, when a tree is
loaded. For serving, matrices, Dense biases and the two embedding tables are
stored in the compute dtype (the tables are summed in f32, as the reference
sums them); LayerNorm parameters and the projection head stay f32. For
training, ``param_dtype=torch.float32`` stores every matrix, bias and table
in f32 and casts at each use, as models/clip/model.py's ``Dense`` does
(``CLIP(config, param_dtype=torch.float32)`` passes it down).

With ``fused_block`` set (and bf16) every layer calls the post-LN training
entries (ops/postln_block.py ``*_train``): with no gradient required they
are the kernel wrappers, which launch the CUDA kernels on CUDA tensors and
compute their plain versions on CPU tensors; under a gradient they add a
backward that differentiates the plain block, as the reference's layer calls
its ``_train`` wrappers (wise_tpu/models/clip/hf_text.py:135-144). A shape
the kernels do not take raises on the card. Otherwise a layer is the
wrappers' plain versions (in f32 the reference's plain-ops layer to
rounding; in bf16 they round where the kernels do, not where the
reference's XLA layer does). Outside the layers everything is plain torch,
differentiated by autograd, as the reference leaves it to XLA.

One deviation from the reference's converter (ROADMAP Queue C 6):
``convert_hf_text_state_dict`` adds row 0 of
``embeddings.token_type_embeddings.weight``, which HuggingFace's RoBERTa adds
to every token, to the position table when the key is present; the
reference drops it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ...ops import postln_block as P
from .model import Dense, LayerNorm


@dataclasses.dataclass(frozen=True)
class HFTextConfig:
    vocab_size: int = 250002
    width: int = 1024
    layers: int = 24
    heads: int = 16
    intermediate: int = 4096
    max_positions: int = 514
    pad_token_id: int = 1
    embed_dim: int = 1024       # joint space
    #: open_clip HFTextEncoder projection head: "linear" (one bias-free
    #: matrix) or "mlp" (Linear -> GELU -> Linear, both bias-free, hidden
    #: width (width + embed_dim) // 2). The published
    #: xlm-roberta-large-ViT-H-14 checkpoint uses "mlp".
    proj_type: str = "linear"
    dtype: str = "float32"
    #: run the layers through the post-LN kernel wrappers (bf16 only)
    fused_block: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.dtype]


def hf_text_config(c) -> HFTextConfig:
    """The text tower's config of a CLIPConfig with
    ``text_tower="hf_xlm_roberta"``: intermediate = 4 x width, the kernel
    switch shared with the vision tower."""
    return HFTextConfig(
        vocab_size=c.vocab_size, width=c.text_width, layers=c.text_layers,
        heads=c.text_heads, intermediate=4 * c.text_width,
        embed_dim=c.embed_dim, proj_type=c.hf_proj_type, dtype=c.dtype,
        fused_block=c.fused_block)


class BertLayer(nn.Module):
    """One post-LN block. ``km`` is the per-example additive f32 key mask
    (B, 1, SP): 0 at real tokens, -inf at padding."""

    def __init__(self, c: HFTextConfig, param_dtype=None):
        super().__init__()
        dt = c.torch_dtype
        self.heads = c.heads
        self.fused_block = c.fused_block and dt == torch.bfloat16
        self.qkv = Dense(c.width, 3 * c.width, dt, param_dtype=param_dtype)
        self.attn_out = Dense(c.width, c.width, dt, param_dtype=param_dtype)
        self.attn_ln = LayerNorm(c.width)
        self.intermediate = Dense(c.width, c.intermediate, dt,
                                  param_dtype=param_dtype)
        self.output = Dense(c.intermediate, c.width, dt,
                            param_dtype=param_dtype)
        self.out_ln = LayerNorm(c.width)

    def forward(self, x, km):
        fused = self.fused_block
        attn = (P.fused_postln_attn_block_train if fused
                else P.plain_postln_attn_block)
        x = attn(x, km, self.attn_ln.scale, self.attn_ln.bias,
                 *self.qkv.weights(), *self.attn_out.weights(), self.heads)
        mlp = (P.fused_postln_mlp_block_train if fused
               else P.plain_postln_mlp_block)
        return mlp(x, self.out_ln.scale, self.out_ln.bias,
                   *self.intermediate.weights(), *self.output.weights(),
                   "gelu")


class XLMRobertaTextTower(nn.Module):
    """``param_dtype`` stores the matrices, biases and tables in another
    dtype than the compute dtype: float32 for training, None (the compute
    dtype) for serving."""

    def __init__(self, c: HFTextConfig, param_dtype=None):
        super().__init__()
        if c.proj_type not in ("linear", "mlp"):
            raise ValueError(f"unknown proj_type {c.proj_type!r}")
        self.config = c
        pdt = param_dtype or c.torch_dtype
        self.word_embeddings = nn.Parameter(
            torch.zeros(c.vocab_size, c.width, dtype=pdt))
        self.position_embeddings = nn.Parameter(
            torch.zeros(c.max_positions, c.width, dtype=pdt))
        self.emb_ln = LayerNorm(c.width)
        for i in range(c.layers):
            self.add_module(f"layer_{i}", BertLayer(c, param_dtype))
        if c.proj_type == "mlp":
            hidden = (c.width + c.embed_dim) // 2
            self.proj_fc = nn.Parameter(torch.zeros(c.width, hidden))
            self.proj_out = nn.Parameter(torch.zeros(hidden, c.embed_dim))
        else:
            self.proj = nn.Parameter(torch.zeros(c.width, c.embed_dim))

    def forward(self, tokens):
        """tokens (B, L) int, ``pad_token_id`` marks padding ->
        (B, embed_dim) f32."""
        c = self.config
        pad_mask = tokens != c.pad_token_id          # (B, L)
        # RoBERTa: positions count non-pad tokens, offset by pad_token_id + 1
        positions = pad_mask.cumsum(dim=1) * pad_mask + c.pad_token_id
        x = (self.word_embeddings[tokens].float()
             + self.position_embeddings[positions].float())
        x = self.emb_ln(x).to(c.torch_dtype)

        km = torch.zeros(pad_mask.shape, dtype=torch.float32,
                         device=tokens.device)
        km = km.masked_fill(~pad_mask, -math.inf)[:, None, :]
        for i in range(c.layers):
            x = getattr(self, f"layer_{i}")(x, km)

        # mean pooling over non-pad tokens (open_clip mean_pooler), in f32
        denom = pad_mask.sum(dim=1, keepdim=True).clamp(min=1)
        pooled = (x.float() * pad_mask[..., None]).sum(dim=1) / denom
        if c.proj_type == "mlp":
            # nn.Sequential(Linear, GELU, Linear), bias-free, exact-erf GELU
            return torch.nn.functional.gelu(pooled @ self.proj_fc) \
                @ self.proj_out
        return pooled @ self.proj


def convert_hf_text_state_dict(sd, config: HFTextConfig):
    """open_clip HF tower keys (prefix 'text.') -> the reference's params
    tree for XLMRobertaTextTower (numpy arrays; ``from_flax_params`` carries
    it onto the port's state_dict)."""

    def g(key):
        return np.asarray(sd[key], dtype=np.float32)

    def dense(prefix):
        return {"kernel": g(prefix + ".weight").T, "bias": g(prefix + ".bias")}

    def ln(prefix):
        return {"scale": g(prefix + ".weight"), "bias": g(prefix + ".bias")}

    base = "text.transformer"
    positions = g(f"{base}.embeddings.position_embeddings.weight")
    token_type = f"{base}.embeddings.token_type_embeddings.weight"
    if token_type in sd:
        # HF's RoBERTa adds token type 0's row to every token; the towers
        # take no token types, so it folds into every position's row
        positions = positions + g(token_type)[0]
    params = {
        "word_embeddings": g(f"{base}.embeddings.word_embeddings.weight"),
        "position_embeddings": positions,
        "emb_ln": ln(f"{base}.embeddings.LayerNorm"),
    }
    # projection head naming depends on open_clip's proj type: "mlp" saves
    # the Sequential's members as text.proj.0 / text.proj.2 (bias-free),
    # "linear" as text.proj (raw matrix) or text.proj.weight
    if "text.proj.0.weight" in sd:
        if config.proj_type != "mlp":
            raise KeyError(
                "checkpoint has an MLP text projection (text.proj.0.*) but "
                "config.proj_type is %r — use hf_proj_type='mlp'"
                % config.proj_type
            )
        params["proj_fc"] = g("text.proj.0.weight").T
        params["proj_out"] = g("text.proj.2.weight").T
    else:
        if config.proj_type == "mlp":
            raise KeyError(
                "config.proj_type is 'mlp' but the checkpoint has a "
                "linear text projection (no text.proj.0.*) — drop "
                "hf_proj_type='mlp' (the reverse mismatch raises above; "
                "without this check it would surface later as a missing "
                "'proj_fc' parameter when the state dict is loaded)"
            )
        params["proj"] = g(
            "text.proj" if "text.proj" in sd else "text.proj.weight"
        ).T
    for i in range(config.layers):
        lp = f"{base}.encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "self": {
                "query": dense(f"{lp}.attention.self.query"),
                "key": dense(f"{lp}.attention.self.key"),
                "value": dense(f"{lp}.attention.self.value"),
            },
            "attn_out": dense(f"{lp}.attention.output.dense"),
            "attn_ln": ln(f"{lp}.attention.output.LayerNorm"),
            "intermediate": dense(f"{lp}.intermediate.dense"),
            "output": dense(f"{lp}.output.dense"),
            "out_ln": ln(f"{lp}.output.LayerNorm"),
        }
    return params

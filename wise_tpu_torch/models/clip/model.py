"""CLIP image and text towers in PyTorch (wise_tpu/models/clip/model.py).

OpenCLIP's architecture with the reference's parameter tree: a module's
state_dict key is the flax path joined by dots (``resblocks_3`` becomes
``resblocks.3``), and every matrix keeps the flax x @ W layout, which is the
layout the block kernels take. Matrices, Dense biases and embeddings are
stored in the compute dtype (the reference casts them at every use, which
rounds the same way); LayerNorm parameters stay f32.

Numerics follow the reference's production path: f32 LayerNorms, bf16
GEMMs, an f32 vision residual stream after ``ln_pre`` (bf16 with
``bf16_stream``), a bf16 text stream, the last layer computed only at the
pooled row (cls / EOT argmax), the last layer's MLP as plain (B, D) ops.
Residual blocks go through ops/block.py. With ``fused_block`` set (and
bf16 GEMMs) every block calls the kernel wrappers, which launch the CUDA
kernels on CUDA tensors and compute their plain versions on CPU tensors.
The kernels take head_dim 64 or 80 and at most 272 tokens
(``ops.block.supports_fused_block``), which covers ViT-B/32, B/16, L/14 and
H/14 at 224 px and their text towers; any other tower raises on the card
unless ``fused_block`` is off. The MLP takes ``fused_mlp_block`` up to width
768 and the ``fused_mlp_split`` pair above (``ops.block.mlp_choice``).

With ``fused_block`` off and ``fused_attention`` set (bf16), a block's
attention middle alone is a kernel (ops/attention.py
``fused_short_attention``, between a plain in- and out-projection); its MLP
and the pooled last layer are plain, as in the reference. With both off every
block is plain PyTorch. ``text_tower="hf_xlm_roberta"`` swaps the text side
for the XLM-RoBERTa tower (hf_text.py) on the post-LN kernels.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops import attention as A
from ...ops import block as K
from .config import CLIPConfig


class LayerNorm(nn.Module):
    """flax LayerNorm(dtype=float32): f32 parameters, f32 output."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return K.layer_norm_f32(x, self.scale, self.bias)


class Dense(nn.Module):
    """flax Dense: kernel (in, out), bias (out,) unless ``bias=False``, in
    the compute dtype."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(din, dout, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(dout, dtype=dtype)) if bias
                     else None)

    def forward(self, x):
        y = x.to(self.kernel.dtype) @ self.kernel
        return y if self.bias is None else y + self.bias


class Attention(nn.Module):
    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.in_proj = Dense(width, 3 * width, dtype)
        self.out_proj = Dense(width, width, dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, act: str, dtype: torch.dtype,
                 fused_block: bool, fused_attention: bool = False):
        super().__init__()
        self.width, self.heads, self.act, self.dtype = width, heads, act, dtype
        self.fused_block = fused_block and dtype == torch.bfloat16
        #: the attention middle alone as a kernel, where the block kernels
        #: are off
        self.fused_attention = (fused_attention and dtype == torch.bfloat16
                                and not self.fused_block)
        self.ln_1 = LayerNorm(width)
        self.attn = Attention(width, dtype)
        self.ln_2 = LayerNorm(width)
        self.mlp_fc = Dense(width, 4 * width, dtype)
        self.mlp_proj = Dense(4 * width, width, dtype)

    def _attn_params(self):
        a = self.attn
        return (self.ln_1.scale, self.ln_1.bias, a.in_proj.kernel,
                a.in_proj.bias, a.out_proj.kernel, a.out_proj.bias)

    def _attention_middle(self, x, n_valid: int, causal: bool):
        """x + out_proj(fused_short_attention(in_proj(LN(x)))): the
        projections are plain GEMMs, as the reference leaves them to XLA."""
        y = self.ln_1(x).to(self.dtype)
        q, k, v = self.attn.in_proj(y).split(self.width, dim=-1)
        att = A.fused_short_attention(q, k, v, self.heads, n_valid, causal)
        return x + self.attn.out_proj(att).to(x.dtype)

    def forward(self, x, n_valid: int, causal: bool = False):
        fused = self.fused_block
        if self.fused_attention:
            x = self._attention_middle(x, n_valid, causal)
            return K.plain_mlp_block(
                x, self.ln_2.scale, self.ln_2.bias, self.mlp_fc.kernel,
                self.mlp_fc.bias, self.mlp_proj.kernel, self.mlp_proj.bias,
                act=self.act)
        attn = K.fused_attn_block if fused else K.plain_attn_block
        if not fused:
            mlp = K.plain_mlp_block
        elif K.mlp_choice(self.width) == "split":
            mlp = K.fused_mlp_split
        else:
            mlp = K.fused_mlp_block
        x = attn(x, *self._attn_params(), heads=self.heads, n_valid=n_valid,
                 causal=causal)
        return mlp(x, self.ln_2.scale, self.ln_2.bias, self.mlp_fc.kernel,
                   self.mlp_fc.bias, self.mlp_proj.kernel, self.mlp_proj.bias,
                   act=self.act)

    def pooled(self, x, n_valid: int, causal: bool = False,
               pool_row: int | None = None, rows=None):
        """The last layer at one row per example, (B, D): ``rows`` (B,)
        int32 per example (text EOT), else the static ``pool_row``."""
        fused = self.fused_block
        if rows is not None:
            fn = (K.fused_attn_block_pooled_dyn if fused
                  else K.plain_attn_block_pooled_dyn)
            x0 = fn(x, rows, *self._attn_params(), heads=self.heads,
                    n_valid=n_valid, causal=causal)
        else:
            fn = (K.fused_attn_block_pooled if fused
                  else K.plain_attn_block_pooled)
            x0 = fn(x, *self._attn_params(), heads=self.heads,
                    n_valid=n_valid, pool_row=pool_row, causal=causal)
        h = K.activation(self.mlp_fc(self.ln_2(x0)).float(), self.act)
        return x0 + self.mlp_proj(h.to(self.dtype))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, act: str,
                 dtype: torch.dtype, fused_block: bool,
                 fused_attention: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, act, dtype, fused_block,
                                   fused_attention)
            for _ in range(layers)
        )

    def forward(self, x, n_valid: int, causal: bool = False,
                pool_row: int | None = None, pool_rows=None):
        """(B, S, D) -> (B, S, D); with ``pool_row`` / ``pool_rows`` the last
        layer runs pooled and the result is (B, D)."""
        last = len(self.resblocks) - 1
        for i, blk in enumerate(self.resblocks):
            if i == last and (pool_row is not None or pool_rows is not None):
                return blk.pooled(x, n_valid, causal, pool_row, pool_rows)
            x = blk(x, n_valid, causal)
        return x


class PatchEmbed(nn.Module):
    """The patch convolution's kernel in flax HWIO layout (p, p, 3, D),
    applied as patchify + one GEMM."""

    def __init__(self, patch: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.zeros(patch, patch, 3, width, dtype=dtype))

    def forward(self, images):
        p, width = self.kernel.shape[0], self.kernel.shape[-1]
        b, h, w, _ = images.shape
        gh, gw = h // p, w // p
        x = images.to(self.kernel.dtype).reshape(b, gh, p, gw, p, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
        return x @ self.kernel.reshape(p * p * 3, width)


class VisionTransformer(nn.Module):
    def __init__(self, c: CLIPConfig):
        super().__init__()
        if c.vision_pool != "cls":
            raise NotImplementedError(
                "MAP-pooled vision towers: ROADMAP Queue A item 8")
        self.config = c
        dt, w = c.torch_dtype, c.vision_width
        n_tok = (c.image_size // c.patch_size) ** 2 + 1
        self.conv1 = PatchEmbed(c.patch_size, w, dt)
        self.class_embedding = nn.Parameter(torch.zeros(w, dtype=dt))
        self.positional_embedding = nn.Parameter(
            torch.zeros(n_tok, w, dtype=dt))
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, c.vision_layers, c.vision_heads,
                                       c.act_name, dt, c.fused_block,
                                       c.fused_attention)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.zeros(w, c.embed_dim, dtype=dt))

    def forward(self, images):
        """images (B, H, W, 3) float, normalised -> (B, embed_dim) f32."""
        c = self.config
        x = self.conv1(images)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        if c.bf16_stream:
            x = x.to(c.torch_dtype)
        if c.pool_last_block:
            x = self.transformer(x, x.shape[1], pool_row=0)
        else:
            x = self.transformer(x, x.shape[1])[:, 0]
        x = self.ln_post(x)
        return (x.to(c.torch_dtype) @ self.proj).float()


class TextTransformer(nn.Module):
    def __init__(self, c: CLIPConfig):
        super().__init__()
        if c.text_tower != "clip" or c.text_pool != "argmax":
            raise NotImplementedError(
                "last-pooled text towers: ROADMAP Queue A item 8")
        self.config = c
        dt, w = c.torch_dtype, c.text_width
        self.token_embedding = nn.Parameter(
            torch.zeros(c.vocab_size, w, dtype=dt))
        self.positional_embedding = nn.Parameter(
            torch.zeros(c.context_length, w, dtype=dt))
        self.transformer = Transformer(w, c.text_layers, c.text_heads,
                                       c.act_name, dt, c.fused_block,
                                       c.fused_attention)
        self.ln_final = LayerNorm(w)
        self.text_projection = nn.Parameter(
            torch.zeros(w, c.embed_dim, dtype=dt))

    def forward(self, tokens):
        """tokens (B, context_length) int -> (B, embed_dim) f32, pooled at
        the argmax token (EOT has the highest id, as in open_clip)."""
        c = self.config
        x = self.token_embedding[tokens] + self.positional_embedding
        eot = tokens.argmax(dim=-1)
        n = x.shape[1]
        if c.pool_last_block:
            pooled = self.ln_final(self.transformer(
                x, n, causal=c.text_causal, pool_rows=eot.to(torch.int32)))
        else:
            x = self.ln_final(self.transformer(x, n, causal=c.text_causal))
            pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return (pooled.to(c.torch_dtype) @ self.text_projection).float()


def _l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIP(nn.Module):
    def __init__(self, config: CLIPConfig):
        super().__init__()
        self.config = config
        self.visual = VisionTransformer(config)
        if config.text_tower == "hf_xlm_roberta":
            from .hf_text import XLMRobertaTextTower, hf_text_config

            self.text = XLMRobertaTextTower(hf_text_config(config))
        else:
            self.text = TextTransformer(config)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, images, normalize: bool = True):
        feats = self.visual(images)
        return _l2_normalize(feats) if normalize else feats

    def encode_text(self, tokens, normalize: bool = True):
        feats = self.text(tokens)
        return _l2_normalize(feats) if normalize else feats


@torch.no_grad()
def init_random_(model: CLIP, seed: int = 0) -> CLIP:
    """Seeded random weights, drawn on the CPU from torch.Generator(seed) in
    the reference's initialiser families: lecun-normal kernels, N(0, 0.02)
    embeddings and projections (the CLIP text positions N(0, 0.01)), zero
    biases, unit LayerNorm scales; the XLM-R tower's names fall into the
    same families. One parameter is drawn at a time, so the host never
    holds more than the largest table in f32."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale" or name == "logit_scale":
            continue  # LayerNorm scales stay 1, logit_scale log(1 / 0.07)
        if leaf == "bias":
            p.zero_()
            continue
        if leaf == "kernel":
            std = 1.0 / math.sqrt(math.prod(p.shape[:-1]))
        elif name == "text.positional_embedding":
            std = 0.01
        else:
            std = 0.02
        p.copy_(torch.randn(p.shape, generator=g) * std)
    return model

"""CLIP image and text towers in PyTorch (wise_tpu/models/clip/model.py).

OpenCLIP's architecture with the reference's parameter tree: a module's
state_dict key is the flax path joined by dots (``resblocks_3`` becomes
``resblocks.3``), and every matrix keeps the flax x @ W layout, which is the
layout the block kernels take. For serving, matrices, Dense biases and
embeddings are stored in the compute dtype (the reference casts them at
every use, which rounds the same way); LayerNorm parameters stay f32. For
training, ``CLIP(config, param_dtype=torch.float32)`` stores every parameter
in f32 and casts at each use, as the reference does: an AdamW update at a
fine-tuning learning rate is smaller than half a bf16 ulp of most weights and
would be lost whole in a bf16 parameter. The gradient flows back through the
cast into the f32 master.

Numerics follow the reference's production path: f32 LayerNorms, bf16
GEMMs, an f32 vision residual stream after ``ln_pre`` (bf16 with
``bf16_stream``), a bf16 text stream, the last layer computed only at the
pooled row (cls, EOT argmax, or SigLIP's last token), the last layer's MLP
as plain (B, D) ops. A SigLIP vision tower (``vision_pool="map"``) has no
class token and no ``ln_pre``: its stream stays in the compute dtype, every
layer runs whole, and ``MAPHead`` pools the tokens after ``ln_post``; its
text tower attends both ways (``text_causal=False``) and adds
``text_projection_bias``.
Residual blocks go through ops/block.py. With ``fused_block`` set (and
bf16 GEMMs) every block calls the kernel wrappers, which launch the CUDA
kernels on CUDA tensors and compute their plain versions on CPU tensors.
The kernels take head_dim 64, 80, 88 or 104 and at most 640 tokens
(``ops.block.supports_fused_block``), which covers every tower of the
registry: ViT-B/32, B/16, L/14, H/14, g/14 (88) and bigG/14 (104) at 224
px, ViT-L/14 at 336 px (577 tokens), SigLIP at 256 and 384 px (256 and 576)
and their text towers; any
other tower raises on the card unless ``fused_block`` is off. The SigLIP
text tower runs the kernels too (non-causal, pooled at row 63): the
reference keeps it on plain XLA only because its TPU padding would move that
row, and the port pads nothing. A shape the monolithic block does not take
and ``ops.block.supports_fused_block_padded`` does takes the padded-head
block; that gate's table is empty, so no tower does unless a caller fills
it. The MLP takes ``fused_mlp_block`` up to width
768 and the ``fused_mlp_split`` pair above (``ops.block.mlp_choice``).

With ``fused_block`` off and ``fused_attention`` set (bf16), a block's
attention middle alone is a kernel (ops/attention.py
``fused_short_attention``, between a plain in- and out-projection); its MLP
and the pooled last layer are plain, as in the reference. With both off every
block is plain PyTorch. ``text_tower="hf_xlm_roberta"`` swaps the text side
for the XLM-RoBERTa tower (hf_text.py) on the post-LN kernels.

Under autograd the blocks go through the ``*_train`` functions of
ops/block.py: with no gradient required they launch what serving launches;
with one, the saved-activation kernels and plain-PyTorch backwards. The
attention middle goes through ops/attention.py ``fused_attention_trainable``
and the XLM-R tower's layers through ops/postln_block.py's ``*_train``
entries: the same kernels forward, and a backward that differentiates the
plain version at the saved inputs. ``config.remat`` recomputes each block in
the backward (``torch.utils.checkpoint``).

Under tensor parallelism (``tp``, a parallel/distributed.py TensorParallel
of more than one rank) a CLIP tower's blocks hold the rank's H/mp heads and
F/mp MLP columns, as parallel/train.py ``shard_clip_params`` lays them out:
``attn.in_proj.kernel`` (D, 3E), ``attn.out_proj.kernel`` (E, D),
``mlp_fc.kernel`` (D, F/mp), ``mlp_proj.kernel`` (F/mp, D); every other leaf,
the column-split layers' biases included, is whole, as the reference
replicates it. The blocks run the head-split forms of ops/block.py (the
kernel chains with ``fused_block``, the attention middle over H/mp heads with
``fused_attention``, the plain forms otherwise), the pooled layer's MLP and
SigLIP's ``MAPHead`` column / row parallel. The XLM-R tower stays whole. With
one rank the path is the unsplit one.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    """flax Dense: kernel (in, out), bias (out,) unless ``bias=False``,
    stored in ``param_dtype`` (the compute dtype unless given) and used in
    the compute dtype."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype,
                 bias: bool = True, param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.kernel = nn.Parameter(torch.zeros(din, dout, dtype=pdt))
        self.bias = (nn.Parameter(torch.zeros(dout, dtype=pdt)) if bias
                     else None)

    def weights(self):
        """(kernel, bias) in the compute dtype."""
        return self.kernel.to(self.dtype), self.bias.to(self.dtype)

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def _split_dense(din: int, dout: int, part: int, dtype, param_dtype):
    """A Dense whose kernel holds ``part`` of its ``dout`` columns and whose
    bias is whole (the reference shards only 2-D leaves)."""
    layer = Dense(din, part, dtype, bias=False, param_dtype=param_dtype)
    layer.bias = nn.Parameter(torch.zeros(dout, dtype=param_dtype or dtype))
    return layer


class Attention(nn.Module):
    """in_proj (D, 3D) and out_proj (D, D); with ``tp`` split, in_proj's
    kernel (D, 3E) and out_proj's (E, D), E = D / mp."""

    def __init__(self, width: int, dtype: torch.dtype, param_dtype=None,
                 tp=None):
        super().__init__()
        split = tp is not None and tp.size > 1
        e = width // tp.size if split else width
        self.in_proj = (_split_dense(width, 3 * width, 3 * e, dtype,
                                     param_dtype) if split
                        else Dense(width, 3 * width, dtype,
                                   param_dtype=param_dtype))
        self.out_proj = Dense(e, width, dtype, param_dtype=param_dtype)


def _check_split(width: int, heads: int, hidden: int, tp) -> bool:
    """Whether ``tp`` splits a block of this shape; raises with the shapes
    where the heads or the MLP's columns do not divide."""
    if tp is None or tp.size == 1:
        return False
    if heads % tp.size or hidden % tp.size:
        raise ValueError(f"a block of {heads} heads (width {width}) and MLP "
                         f"width {hidden} does not split over mp = "
                         f"{tp.size}: both must divide")
    return True


def _mlp_split(x0, ln, fc, proj, cols, act: str, dtype, tp):
    """x0 + proj(act(fc(ln(x0)))) on (B, D) rows with fc split by column and
    proj by row over ``tp``'s ranks (``cols`` the rank's fc columns): the
    pooled layer's MLP and MAPHead's, plain ops as in the reference."""
    y = K.mp_in(ln(x0).to(dtype), tp)
    h = K.activation((K.col_matmul(y, fc.kernel.to(dtype))
                      + tp.take(fc.bias, cols).to(dtype)).float(), act)
    return x0 + K.mp_dense(K.split_out(h.to(dtype), proj.kernel.to(dtype)),
                           proj.bias, tp, dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, act: str, dtype: torch.dtype,
                 fused_block: bool, fused_attention: bool = False,
                 param_dtype=None, tp=None):
        super().__init__()
        self.width, self.heads, self.act, self.dtype = width, heads, act, dtype
        self.fused_block = fused_block and dtype == torch.bfloat16
        #: the attention middle alone as a kernel, where the block kernels
        #: are off
        self.fused_attention = (fused_attention and dtype == torch.bfloat16
                                and not self.fused_block)
        hidden = 4 * width
        #: the 'mp' group whose ranks split the block, None unsplit
        self.tp = tp if _check_split(width, heads, hidden, tp) else None
        f = hidden // tp.size if self.tp else hidden
        self.ln_1 = LayerNorm(width)
        self.attn = Attention(width, dtype, param_dtype, self.tp)
        self.ln_2 = LayerNorm(width)
        self.mlp_fc = (_split_dense(width, hidden, f, dtype, param_dtype)
                       if self.tp else Dense(width, hidden, dtype,
                                             param_dtype=param_dtype))
        self.mlp_proj = Dense(f, width, dtype, param_dtype=param_dtype)
        if self.tp:
            # the rank's columns of in_proj's and mlp_fc's whole biases
            self.register_buffer("qkv_cols", self.tp.qkv_columns(width),
                                 persistent=False)
            cols = self.tp.columns(hidden)
            self.register_buffer("fc_cols", torch.arange(cols.start,
                                                         cols.stop),
                                 persistent=False)

    def _attn_params(self):
        a = self.attn
        return (self.ln_1.scale, self.ln_1.bias, *a.in_proj.weights(),
                *a.out_proj.weights())

    def _mlp_params(self):
        return (self.ln_2.scale, self.ln_2.bias, *self.mlp_fc.weights(),
                *self.mlp_proj.weights())

    def _split_attn_params(self):
        """The rank's attention weights: (ln_s, ln_b, wqkv (D, 3E), bqkv
        (3E,), wo (E, D), bo (D,)), in the compute dtype."""
        a, dt = self.attn, self.dtype
        return (self.ln_1.scale, self.ln_1.bias, a.in_proj.kernel.to(dt),
                self.tp.take(a.in_proj.bias, self.qkv_cols).to(dt),
                *a.out_proj.weights())

    def _split_mlp_params(self):
        dt = self.dtype
        return (self.ln_2.scale, self.ln_2.bias, self.mlp_fc.kernel.to(dt),
                self.tp.take(self.mlp_fc.bias, self.fc_cols).to(dt),
                *self.mlp_proj.weights())

    def _split_forward(self, x, n_valid: int, causal: bool):
        """The block on the rank's heads and columns, closed over the
        ranks."""
        tp, heads = self.tp, self.heads // self.tp.size
        attn = self._split_attn_params()
        if self.fused_attention:
            _, _, wqkv, bqkv, wo, bo = attn
            y = K.mp_in(self.ln_1(x).to(self.dtype), tp)
            q, k, v = (K.col_matmul(y, wqkv) + bqkv).split(wo.shape[0],
                                                           dim=-1)
            att = A.fused_attention_trainable(q, k, v, heads, n_valid, causal)
            x = x + K.mp_dense(K.split_out(att, wo), bo, tp,
                               self.dtype).to(x.dtype)
            return K.plain_mlp_block_mp(x, *self._split_mlp_params(),
                                        act=self.act, tp=tp)
        if self.fused_block:
            x = K.fused_attn_block_mp_train(x, *attn, heads=heads,
                                            n_valid=n_valid, causal=causal,
                                            tp=tp)
            return K.fused_mlp_mp_train(x, *self._split_mlp_params(),
                                        act=self.act, tp=tp)
        x = K.plain_attn_block_mp(x, *attn, heads=heads, n_valid=n_valid,
                                  causal=causal, tp=tp)
        return K.plain_mlp_block_mp(x, *self._split_mlp_params(),
                                    act=self.act, tp=tp)

    def _attention_middle(self, x, n_valid: int, causal: bool):
        """x + out_proj(fused_short_attention(in_proj(LN(x)))) through its
        training entry: the projections are plain GEMMs, as the reference
        leaves them to XLA."""
        y = self.ln_1(x).to(self.dtype)
        q, k, v = self.attn.in_proj(y).split(self.width, dim=-1)
        att = A.fused_attention_trainable(q, k, v, self.heads, n_valid,
                                          causal)
        return x + self.attn.out_proj(att).to(x.dtype)

    def _fused_attn(self, seq: int):
        """The attention block's wrapper for a block tower: the monolithic
        block, unless it does not take the shape and the padded-head block
        does (the reference's precedence, wise_tpu/models/clip/model.py:
        346-355). The padded gate's table is empty, so only a caller that
        fills it reaches the padded block."""
        if (not K.supports_fused_block(seq, self.width, self.heads)
                and K.supports_fused_block_padded(seq, self.width,
                                                  self.heads)):
            return K.fused_attn_block_padded_train
        return K.fused_attn_block_train

    def forward(self, x, n_valid: int, causal: bool = False):
        if self.tp:
            return self._split_forward(x, n_valid, causal)
        fused = self.fused_block
        if self.fused_attention:
            x = self._attention_middle(x, n_valid, causal)
            return K.plain_mlp_block(x, *self._mlp_params(), act=self.act)
        attn = self._fused_attn(x.shape[1]) if fused else K.plain_attn_block
        if not fused:
            mlp = K.plain_mlp_block
        elif K.mlp_choice(self.width) == "split":
            mlp = K.fused_mlp_split_train
        else:
            mlp = K.fused_mlp_block_train
        x = attn(x, *self._attn_params(), heads=self.heads, n_valid=n_valid,
                 causal=causal)
        return mlp(x, *self._mlp_params(), act=self.act)

    def pooled(self, x, n_valid: int, causal: bool = False,
               pool_row: int | None = None, rows=None):
        """The last layer at one row per example, (B, D): ``rows`` (B,)
        int32 per example (text EOT), else the static ``pool_row``."""
        fused = self.fused_block
        if self.tp:
            fn = (K.fused_attn_block_pooled_mp_train if fused
                  else K.plain_attn_block_pooled_mp)
            x0 = fn(x, rows, *self._split_attn_params(),
                    heads=self.heads // self.tp.size, n_valid=n_valid,
                    pool_row=0 if pool_row is None else pool_row,
                    causal=causal, tp=self.tp)
            return _mlp_split(x0, self.ln_2, self.mlp_fc, self.mlp_proj,
                              self.fc_cols, self.act, self.dtype, self.tp)
        if rows is not None:
            fn = (K.fused_attn_block_pooled_dyn_train if fused
                  else K.plain_attn_block_pooled_dyn)
            x0 = fn(x, rows, *self._attn_params(), heads=self.heads,
                    n_valid=n_valid, causal=causal)
        else:
            fn = (K.fused_attn_block_pooled_train if fused
                  else K.plain_attn_block_pooled)
            x0 = fn(x, *self._attn_params(), heads=self.heads,
                    n_valid=n_valid, pool_row=pool_row, causal=causal)
        h = K.activation(self.mlp_fc(self.ln_2(x0)).float(), self.act)
        return x0 + self.mlp_proj(h.to(self.dtype))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, act: str,
                 dtype: torch.dtype, fused_block: bool,
                 fused_attention: bool = False, remat: bool = False,
                 param_dtype=None, tp=None):
        super().__init__()
        #: recompute each block in the backward instead of keeping its
        #: activations (the reference's nn.remat around a block)
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, act, dtype, fused_block,
                                   fused_attention, param_dtype, tp)
            for _ in range(layers)
        )

    def forward(self, x, n_valid: int, causal: bool = False,
                pool_row: int | None = None, pool_rows=None):
        """(B, S, D) -> (B, S, D); with ``pool_row`` / ``pool_rows`` the last
        layer runs pooled and the result is (B, D)."""
        remat = self.remat and torch.is_grad_enabled()

        def run(fn, *args):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        last = len(self.resblocks) - 1
        for i, blk in enumerate(self.resblocks):
            if i == last and (pool_row is not None or pool_rows is not None):
                return run(blk.pooled, x, n_valid, causal, pool_row,
                           pool_rows)
            x = run(blk, x, n_valid, causal)
        return x


class PatchEmbed(nn.Module):
    """The patch convolution's kernel in flax HWIO layout (p, p, 3, D), and
    its bias where ``bias`` (SigLIP's), applied as patchify + one GEMM."""

    def __init__(self, patch: int, width: int, dtype: torch.dtype,
                 param_dtype=None, bias: bool = False):
        super().__init__()
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.kernel = nn.Parameter(
            torch.zeros(patch, patch, 3, width, dtype=pdt))
        self.bias = (nn.Parameter(torch.zeros(width, dtype=pdt)) if bias
                     else None)

    def forward(self, images):
        p, width = self.kernel.shape[0], self.kernel.shape[-1]
        b, h, w, _ = images.shape
        gh, gw = h // p, w // p
        x = images.to(self.dtype).reshape(b, gh, p, gw, p, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
        x = x @ self.kernel.to(self.dtype).reshape(p * p * 3, width)
        return x if self.bias is None else x + self.bias.to(self.dtype)


class MAPHead(nn.Module):
    """SigLIP's attention-pool head (wise_tpu/models/clip/model.py MAPHead):
    a learned probe attends over every token, then an MLP with a pre-LN
    residual. Plain PyTorch, as the reference computes it in XLA: the
    einsums in the compute dtype, the softmax in f32 and cast back, f32
    LayerNorm. The probe's query is one row, (1, D), shared by the batch."""

    def __init__(self, width: int, heads: int, act: str, dtype: torch.dtype,
                 param_dtype=None, tp=None):
        super().__init__()
        self.width, self.heads, self.act, self.dtype = width, heads, act, dtype
        hidden = 4 * width
        # under ``tp`` out_proj splits by row, mlp_fc by column and
        # mlp_proj by row (the reference's rule); q_proj and kv_proj match
        # none of its patterns and stay whole
        self.tp = tp if _check_split(width, heads, hidden, tp) else None
        e, f = ((width // tp.size, hidden // tp.size) if self.tp
                else (width, hidden))
        self.probe = nn.Parameter(
            torch.zeros(1, width, dtype=param_dtype or dtype))
        self.q_proj = Dense(width, width, dtype, param_dtype=param_dtype)
        self.kv_proj = Dense(width, 2 * width, dtype, param_dtype=param_dtype)
        self.out_proj = Dense(e, width, dtype, param_dtype=param_dtype)
        self.norm = LayerNorm(width)
        self.mlp_fc = (_split_dense(width, hidden, f, dtype, param_dtype)
                       if self.tp else Dense(width, hidden, dtype,
                                             param_dtype=param_dtype))
        self.mlp_proj = Dense(f, width, dtype, param_dtype=param_dtype)
        if self.tp:
            cols = self.tp.columns(hidden)
            self.register_buffer("fc_cols", torch.arange(cols.start,
                                                         cols.stop),
                                 persistent=False)

    def forward(self, tokens):
        """tokens (B, S, D) -> (B, D) in the compute dtype."""
        b, s, d = tokens.shape
        hd = d // self.heads
        q = self.q_proj(self.probe.to(self.dtype)).reshape(self.heads, hd)
        k, v = self.kv_proj(tokens).split(d, dim=-1)
        logits = torch.einsum("hd,bkhd->bhk", q,
                              k.reshape(b, s, self.heads, hd))
        p = torch.softmax(logits.float() / math.sqrt(hd), dim=-1)
        out = torch.einsum("bhk,bkhd->bhd", p.to(self.dtype),
                           v.reshape(b, s, self.heads, hd)).reshape(b, d)
        if self.tp:
            tp, dt = self.tp, self.dtype
            part = K.split_out(tp.copy(out)[:, tp.columns(d)],
                               self.out_proj.kernel.to(dt))
            out = K.mp_dense(part, self.out_proj.bias, tp, dt)
            return _mlp_split(out, self.norm, self.mlp_fc, self.mlp_proj,
                              self.fc_cols, self.act, dt, tp)
        out = self.out_proj(out)
        h = K.activation(self.mlp_fc(self.norm(out)).float(), self.act)
        return out + self.mlp_proj(h.to(self.dtype))


class VisionTransformer(nn.Module):
    """The class-token tower (``vision_pool="cls"``: ``ln_pre``, the last
    layer pooled at row 0) or SigLIP's (``"map"``: a biased patch embed, no
    class token or ``ln_pre``, every layer whole, ``ln_post`` over every
    token, then ``attn_pool``)."""

    def __init__(self, c: CLIPConfig, param_dtype=None, tp=None):
        super().__init__()
        if c.vision_pool not in ("cls", "map"):
            raise ValueError(f"unknown vision_pool {c.vision_pool!r}")
        self.config = c
        dt, w = c.torch_dtype, c.vision_width
        pdt = param_dtype or dt
        cls = c.vision_pool == "cls"
        n_tok = (c.image_size // c.patch_size) ** 2 + int(cls)
        self.conv1 = PatchEmbed(c.patch_size, w, dt, param_dtype,
                                bias=not cls)
        if cls:
            self.class_embedding = nn.Parameter(torch.zeros(w, dtype=pdt))
        self.positional_embedding = nn.Parameter(
            torch.zeros(n_tok, w, dtype=pdt))
        if cls:
            self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, c.vision_layers, c.vision_heads,
                                       c.act_name, dt, c.fused_block,
                                       c.fused_attention, c.remat,
                                       param_dtype, tp)
        self.ln_post = LayerNorm(w)
        if not cls:
            self.attn_pool = MAPHead(w, c.vision_heads, c.act_name, dt,
                                     param_dtype, tp)
        self.proj = nn.Parameter(torch.zeros(w, c.embed_dim, dtype=pdt))

    def embed(self, images):
        """images (B, H, W, 3) float, normalised -> the residual stream the
        transformer takes, (B, S, D)."""
        c = self.config
        dt = c.torch_dtype
        x = self.conv1(images)
        if c.vision_pool == "map":
            return x + self.positional_embedding.to(dt)
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x)
        return x.to(c.torch_dtype) if c.bf16_stream else x

    def head(self, x):
        """The transformer's output, (B, S, D) or the class row (B, D) ->
        (B, embed_dim) f32."""
        dt = self.config.torch_dtype
        if self.config.vision_pool == "map":
            x = self.attn_pool(self.ln_post(x).to(dt))
            return (x @ self.proj.to(dt)).float()
        x = self.ln_post(x[:, 0] if x.dim() == 3 else x)
        return (x.to(dt) @ self.proj.to(dt)).float()

    def forward(self, images):
        """images (B, H, W, 3) float, normalised -> (B, embed_dim) f32."""
        x = self.embed(images)
        if self.config.vision_pool == "cls" and self.config.pool_last_block:
            return self.head(self.transformer(x, x.shape[1], pool_row=0))
        return self.head(self.transformer(x, x.shape[1]))


class TextTransformer(nn.Module):
    """The causal tower pooled at the EOT argmax (``text_pool="argmax"``) or
    SigLIP's (``"last"``: pooled at the static row context_length - 1,
    bidirectional with ``text_causal=False``, a biased head with
    ``text_proj_bias``)."""

    def __init__(self, c: CLIPConfig, param_dtype=None, tp=None):
        super().__init__()
        if c.text_tower != "clip" or c.text_pool not in ("argmax", "last"):
            raise ValueError(f"not a CLIP text tower: text_tower "
                             f"{c.text_tower!r}, text_pool {c.text_pool!r}")
        self.config = c
        dt, w = c.torch_dtype, c.text_width
        pdt = param_dtype or dt
        self.token_embedding = nn.Parameter(
            torch.zeros(c.vocab_size, w, dtype=pdt))
        self.positional_embedding = nn.Parameter(
            torch.zeros(c.context_length, w, dtype=pdt))
        self.transformer = Transformer(w, c.text_layers, c.text_heads,
                                       c.act_name, dt, c.fused_block,
                                       c.fused_attention, c.remat,
                                       param_dtype, tp)
        self.ln_final = LayerNorm(w)
        self.text_projection = nn.Parameter(
            torch.zeros(w, c.embed_dim, dtype=pdt))
        if c.text_proj_bias:
            self.text_projection_bias = nn.Parameter(
                torch.zeros(c.embed_dim, dtype=pdt))

    def embed(self, tokens):
        """tokens (B, context_length) int -> (the residual stream the
        transformer takes, (B, S, D); the pooled row of each example, the
        argmax token (EOT has the highest id, as in open_clip), or None for
        the last). Ids outside the vocabulary raise: the reference's gather
        clamps them without a word, and an index error from the card names
        nothing."""
        c = self.config
        dt = c.torch_dtype
        lo, hi = (int(v) for v in torch.stack(torch.aminmax(tokens)).tolist())
        if lo < 0 or hi >= c.vocab_size:
            raise ValueError(
                f"token ids span [{lo}, {hi}], outside the vocabulary "
                f"[0, {c.vocab_size})")
        x = (self.token_embedding[tokens].to(dt)
             + self.positional_embedding.to(dt))
        return x, None if c.text_pool == "last" else tokens.argmax(dim=-1)

    def head(self, x, eot):
        """The transformer's output, (B, S, D) or the pooled rows (B, D),
        and ``embed``'s rows -> (B, embed_dim) f32."""
        dt = self.config.torch_dtype
        x = self.ln_final(x)
        if x.dim() == 3:
            x = (x[:, -1] if eot is None
                 else x[torch.arange(x.shape[0], device=x.device), eot])
        out = x.to(dt) @ self.text_projection.to(dt)
        if self.config.text_proj_bias:
            out = out + self.text_projection_bias.to(dt)
        return out.float()

    def forward(self, tokens):
        """tokens (B, context_length) int -> (B, embed_dim) f32, pooled at
        the argmax token or at the last."""
        c = self.config
        x, eot = self.embed(tokens)
        n = x.shape[1]
        if c.pool_last_block:
            return self.head(self.transformer(
                x, n, causal=c.text_causal,
                pool_row=n - 1 if eot is None else None,
                pool_rows=None if eot is None else eot.to(torch.int32)), eot)
        return self.head(self.transformer(x, n, causal=c.text_causal), eot)


def _l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIP(nn.Module):
    """``param_dtype`` stores the matrices, biases and embeddings in another
    dtype than the compute dtype: float32 for training (the module
    docstring says why); None, the compute dtype, for serving. ``tp``: the
    'mp' group whose ranks split the CLIP towers' blocks (the XLM-R tower
    stays whole)."""

    def __init__(self, config: CLIPConfig,
                 param_dtype: torch.dtype | None = None, tp=None):
        super().__init__()
        self.config = config
        self.visual = VisionTransformer(config, param_dtype, tp)
        if config.text_tower == "hf_xlm_roberta":
            from .hf_text import XLMRobertaTextTower, hf_text_config

            self.text = XLMRobertaTextTower(hf_text_config(config),
                                            param_dtype)
        else:
            self.text = TextTransformer(config, param_dtype, tp)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, images, normalize: bool = True):
        feats = self.visual(images)
        return _l2_normalize(feats) if normalize else feats

    def encode_text(self, tokens, normalize: bool = True):
        feats = self.text(tokens)
        return _l2_normalize(feats) if normalize else feats

    def forward(self, images, tokens):
        """(normalised image features, normalised text features,
        exp(logit_scale)): what the contrastive loss takes."""
        return (self.encode_image(images), self.encode_text(tokens),
                self.logit_scale.exp())


@torch.no_grad()
def init_random_(model: CLIP, seed: int = 0) -> CLIP:
    """Seeded random weights, drawn from torch.Generator(seed) on the
    device the parameters lie on (the CPU, unless the model was built on a
    card) in the reference's initialiser families: lecun-normal kernels,
    N(0, 0.02) embeddings, projections and SigLIP's probe (the CLIP text
    positions N(0, 0.01)), zero biases (the SigLIP patch embed's and text
    head's too), unit LayerNorm scales; the XLM-R tower's names fall into
    the same families. One parameter is drawn at a time, so the host never
    holds more than the largest table in f32. A card's generator draws
    other numbers than the CPU's from the same seed."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale" or name == "logit_scale":
            continue  # LayerNorm scales stay 1, logit_scale log(1 / 0.07)
        if leaf in ("bias", "text_projection_bias"):
            p.zero_()
            continue
        if leaf == "kernel":
            std = 1.0 / math.sqrt(math.prod(p.shape[:-1]))
        elif name == "text.positional_embedding":
            std = 0.01
        else:
            std = 0.02
        p.copy_(torch.randn(p.shape, generator=g, device=device) * std)
    return model

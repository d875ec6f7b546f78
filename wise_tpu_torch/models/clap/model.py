"""CLAP in PyTorch (wise_tpu/models/clap/model.py): msclap 2023's HTSAT
audio tower and GPT2 caption tower, msclap 2022's CNN14 audio tower and BERT
caption tower, and msclap's projection heads.

The parameter tree is the reference's: a state_dict key is the flax path
joined by dots (``stage0_block1.attn.qkv.kernel``, the caption tower's
``transformer.resblocks.3...``), matrices keep the flax x @ W layout and the
patch convolution its HWIO kernel, applied as patchify + one GEMM (a 4x4
stride-4 convolution is exactly that). Matrices, Dense biases and
embeddings are stored in the compute dtype; LayerNorm parameters, the
relative-position bias tables and the bn0 affine stay f32.

Numerics follow the reference. In bf16 with ``fused_swin_block`` (the
production path) every HTSAT block runs as one whole-block op in the bf16
stream (ops/swin_block.py) on spatial rows, the shift's roll and the window
partition read through the block's token map (built once, at init);
otherwise the block keeps an f32 stream around a window-attention op
(ops/swin_attention.py), with roll, window partition and reverse as layout
ops around it.
The GPT2 caption tower is the port's CLIP ``Transformer`` (gelu_tanh,
causal, the last layer computed only at each caption's last real token).

The 2022 towers run plain PyTorch ops, as the reference runs them on XLA:
CNN14's 3x3 convolutions (``torch.nn.functional.conv2d``, kernels kept in
flax's HWIO layout) and BERT's products, with the reference's f32 points
(the folded-BN affines, LayerNorm, softmax, the pooling reductions). One
deliberate deviation, ROADMAP Queue C 1: CNN14's sixth block does not pool,
as in upstream PANNs and msclap (the reference pools it 2x2).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops import block as K
from ...ops import swin_attention as SA
from ...ops import swin_block as SB
from ..clip.model import Dense, LayerNorm, Transformer
from .config import CLAPConfig


def window_partition(x, w: int):
    """(B, H, W, C) -> (B * nH * nW, w * w, C), contiguous."""
    b, h, wid, c = x.shape
    x = x.reshape(b, h // w, w, wid // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(windows, w: int, h: int, wid: int):
    b = windows.shape[0] // ((h // w) * (wid // w))
    x = windows.reshape(b, h // w, wid // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wid, -1)


def relative_position_index(w: int) -> np.ndarray:
    coords = np.stack(
        np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Swin shifted-window attention mask: (nW, w*w, w*w) additive, -100
    (not -inf) between tokens of different regions, as the reference."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h // window, window, w // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _gelu(x, dtype):
    return K.activation(x.float(), "gelu").to(dtype)


class Projection(nn.Module):
    """msclap projection head: LN(linear1(x) + linear2(gelu(linear1(x))))."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.linear1 = Dense(d_in, d_out, dtype)
        self.linear2 = Dense(d_out, d_out, dtype)
        self.layer_norm = LayerNorm(d_out)

    def forward(self, x):
        e1 = self.linear1(x)
        return self.layer_norm(e1 + self.linear2(_gelu(e1, e1.dtype)))


class WindowAttention(nn.Module):
    """Window MHA with the relative-position bias: qkv, proj and the bias
    table (f32); ``kernel`` routes it to the CUDA kernel's wrapper, which
    raises on the card for a shape outside the kernel's."""

    def __init__(self, dim: int, heads: int, window: int, dtype: torch.dtype,
                 kernel: bool):
        super().__init__()
        self.heads, self.window = heads, window
        self.kernel = kernel
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        n = window * window
        # bias[h, i, j] = table[index[i, j], h]: its flat offsets in the
        # (entries, heads) table, so the bias is one gather and no copy
        index = relative_position_index(window).reshape(1, n, n)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(index * heads
                             + np.arange(heads).reshape(heads, 1, 1)),
            persistent=False)

    def bias(self):
        """(heads, L, L) f32 relative-position bias."""
        return torch.take(self.relative_position_bias_table,
                          self.relative_position_index)

    def forward(self, x, mask=None):
        """x (nW * B, w * w, C); mask (nW, w * w, w * w) or None."""
        fn = SA.fused_window_attention if self.kernel else \
            SA.plain_window_attention
        return fn(x.to(self.qkv.kernel.dtype).contiguous(), self.qkv.kernel,
                  self.qkv.bias, self.proj.kernel, self.proj.bias,
                  self.bias(), mask, self.heads)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 resolution, mlp_ratio: float, c: CLAPConfig):
        super().__init__()
        dt = c.torch_dtype
        hres, wres = resolution
        ff = int(dim * mlp_ratio)
        self.heads, self.window, self.resolution = heads, window, resolution
        # torch-Swin/HTSAT clamp: one window over the whole resolution has
        # nothing to shift across (HTSAT stage 3, res 8 = window 8)
        self.shift = shift if min(hres, wres) > window else 0
        self.block_path = c.fused_swin_block and dt == torch.bfloat16
        self.kernel = c.fused_block
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window, dt, c.fused_block)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, ff, dt)
        self.mlp_fc2 = Dense(ff, dim, dt)
        mask = (torch.from_numpy(shift_attn_mask(hres, wres, window,
                                                 self.shift))
                if self.shift else None)
        self.register_buffer("attn_mask", mask, persistent=False)
        # the block path's window-layout row -> spatial row of an image; None
        # where that is the identity (one window over the whole map)
        tmap = SB.token_map(hres, wres, window, self.shift)
        if np.array_equal(tmap.numpy(), np.arange(tmap.numel())):
            tmap = None
        self.register_buffer("token_map", tmap, persistent=False)

    def _roll(self, x, sign: int):
        s = sign * self.shift
        return torch.roll(x, shifts=(s, s), dims=(1, 2)) if s else x

    def forward(self, x):
        """x (B, H * W, C) -> the same shape."""
        (hres, wres), w = self.resolution, self.window
        b, l, c = x.shape
        if self.block_path:
            # the whole block in the bf16 stream on spatial rows; LN,
            # attention, MLP and the residuals commute with the token
            # permutation, so the roll and the partition are the map's
            # gather and their reverse its scatter
            xs = x.to(self.mlp_fc1.kernel.dtype)
            if self.token_map is None:
                xs = xs.reshape(-1, w * w, c)
            fn = SB.fused_swin_block if self.kernel else SB.plain_swin_block
            a = self.attn
            out = fn(xs, self.norm1.scale, self.norm1.bias, a.qkv.kernel,
                     a.qkv.bias, a.proj.kernel, a.proj.bias, a.bias(),
                     self.attn_mask, self.norm2.scale, self.norm2.bias,
                     self.mlp_fc1.kernel, self.mlp_fc1.bias,
                     self.mlp_fc2.kernel, self.mlp_fc2.bias, heads=self.heads,
                     token_map=self.token_map)
            return out.reshape(b, l, c)
        y = self._roll(self.norm1(x).reshape(b, hres, wres, c), -1)
        y = self.attn(window_partition(y, w), self.attn_mask)
        y = self._roll(window_reverse(y, w, hres, wres), 1)
        x = x + y.reshape(b, l, c)
        h = _gelu(self.mlp_fc1(self.norm2(x)), self.mlp_fc1.kernel.dtype)
        return x + self.mlp_fc2(h)


class PatchMerging(nn.Module):
    """2x2 merge in the official Swin concat order ([(row0, col0),
    (row1, col0), (row0, col1), (row1, col1)]), LN, bias-free reduction."""

    def __init__(self, dim: int, resolution, dtype: torch.dtype):
        super().__init__()
        self.resolution = resolution
        self.norm = LayerNorm(4 * dim)
        self.reduction = Dense(4 * dim, 2 * dim, dtype, bias=False)

    def forward(self, x):
        hres, wres = self.resolution
        b, _, c = x.shape
        g = x.reshape(b, hres // 2, 2, wres // 2, 2, c)
        x = torch.cat([g[:, :, 0, :, 0], g[:, :, 1, :, 0], g[:, :, 0, :, 1],
                       g[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class PatchEmbed(nn.Module):
    """The patch convolution's kernel in flax HWIO layout (p, p, 1, E) and
    its bias, applied as patchify + one GEMM."""

    def __init__(self, patch: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(patch, patch, 1, dim,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x):
        """x (B, H, W) -> (B, H/p * W/p, E)."""
        p, dim = self.kernel.shape[0], self.kernel.shape[-1]
        b, h, w = x.shape
        x = x.to(self.kernel.dtype).reshape(b, h // p, p, w // p, p)
        x = x.permute(0, 1, 3, 2, 4).reshape(b, (h // p) * (w // p), p * p)
        return x @ self.kernel.reshape(p * p, dim) + self.bias


class HTSATEncoder(nn.Module):
    """Hierarchical window-attention encoder over the log-mel spectrogram."""

    def __init__(self, c: CLAPConfig):
        super().__init__()
        self.config = c
        dt = c.torch_dtype
        # HTSAT's bn0 over mel bins, folded into an affine; (x + 40) / 40
        # until a checkpoint's running statistics replace it
        self.bn0_scale = nn.Parameter(torch.full((c.n_mels,), 1.0 / 40.0))
        self.bn0_bias = nn.Parameter(torch.ones(c.n_mels))
        self.patch_embed = PatchEmbed(c.patch_size, c.embed_dim, dt)
        self.patch_norm = LayerNorm(c.embed_dim)
        hres = c.spec_frames // c.freq_ratio // c.patch_size
        wres = c.freq_ratio * c.n_mels // c.patch_size
        dim = c.embed_dim
        self.stages = []
        for stage, (depth, heads) in enumerate(zip(c.depths, c.num_heads)):
            names = []
            for blk in range(depth):
                name = f"stage{stage}_block{blk}"
                shift = 0 if blk % 2 == 0 else c.window_size // 2
                setattr(self, name, SwinBlock(dim, heads, c.window_size,
                                              shift, (hres, wres),
                                              c.mlp_ratio, c))
                names.append(name)
            if stage < len(c.depths) - 1:
                names.append(f"merge{stage}")
                setattr(self, names[-1], PatchMerging(dim, (hres, wres), dt))
                hres, wres, dim = hres // 2, wres // 2, dim * 2
            self.stages.append(names)
        self.norm = LayerNorm(dim)

    def embed(self, mel):
        """mel (B, frames, n_mels) f32 log-mel -> the first stage's patch
        tokens (B, H * W, embed_dim)."""
        c = self.config
        b, t = mel.shape[:2]
        if t < c.spec_frames:
            mel = torch.nn.functional.pad(mel, (0, 0, 0, c.spec_frames - t))
        else:
            mel = mel[:, :c.spec_frames]
        mel = mel * self.bn0_scale + self.bn0_bias
        # stack freq_ratio time chunks along frequency: a square-ish map
        chunk = c.spec_frames // c.freq_ratio
        x = mel.reshape(b, c.freq_ratio, chunk, c.n_mels).permute(0, 2, 1, 3)
        x = self.patch_embed(x.reshape(b, chunk, c.freq_ratio * c.n_mels))
        x = self.patch_norm(x)
        # the block path's stream is bf16 from the first block on
        first = getattr(self, self.stages[0][0])
        return x.to(c.torch_dtype) if first.block_path else x

    def forward(self, mel):
        """mel (B, frames, n_mels) f32 log-mel -> (B, 8 * embed_dim) f32."""
        x = self.embed(mel)
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
        return self.norm(x).mean(dim=1)


class CaptionEncoder(nn.Module):
    """GPT2-layout causal text encoder, pooled at the last real token."""

    def __init__(self, c: CLAPConfig):
        super().__init__()
        self.config = c
        dt, w = c.torch_dtype, c.text_width
        self.token_embedding = nn.Parameter(torch.zeros(c.vocab_size, w,
                                                        dtype=dt))
        self.positional_embedding = nn.Parameter(
            torch.zeros(c.context_length, w, dtype=dt))
        self.transformer = Transformer(w, c.text_layers, c.text_heads,
                                       c.text_act, dt, c.fused_block)
        self.ln_f = LayerNorm(w)

    def forward(self, tokens, lengths):
        """tokens (B, context_length) int, lengths (B,) int -> (B, width)
        f32 at row clip(lengths - 1)."""
        c = self.config
        n = c.context_length
        x = self.token_embedding[tokens] + self.positional_embedding
        rows = (lengths.long() - 1).clamp(0, n - 1)
        if c.pool_last_block:
            return self.ln_f(self.transformer(
                x, n, causal=True, pool_rows=rows.to(torch.int32)))
        x = self.ln_f(self.transformer(x, n, causal=True))
        return x[torch.arange(x.shape[0], device=x.device), rows]


def _l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class BertLayerNorm(LayerNorm):
    """LayerNorm's f32 parameter pair, applied in f32 at BERT's eps."""

    def __init__(self, dim: int, eps: float):
        super().__init__(dim)
        self.eps = eps

    def forward(self, x):
        return K.layer_norm_f32(x, self.scale, self.bias, self.eps)


class BertBlock(nn.Module):
    """One post-LN BERT block (the reference's ``_BertBlock``):
    bidirectional attention under an additive pad mask, q k^T in the
    compute dtype, the softmax in f32, the exact-erf GELU MLP."""

    def __init__(self, width: int, heads: int, eps: float,
                 dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.query = Dense(width, width, dtype)
        self.key = Dense(width, width, dtype)
        self.value = Dense(width, width, dtype)
        self.attn_out = Dense(width, width, dtype)
        self.attn_ln = BertLayerNorm(width, eps)
        self.intermediate = Dense(width, 4 * width, dtype)
        self.output = Dense(4 * width, width, dtype)
        self.out_ln = BertLayerNorm(width, eps)

    def forward(self, x, km):
        """x (B, L, D) in the compute dtype; km (B, L) additive f32 (0 real,
        -inf pad)."""
        dt = self.query.dtype
        b, n, d = x.shape
        h = self.heads
        hd = d // h
        q, k, v = (f(x).view(b, n, h, hd)
                   for f in (self.query, self.key, self.value))
        # the product rounds to the compute dtype; the scale (a numpy
        # scalar in the reference, which promotes) and the mask act in f32
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
        probs = torch.softmax(logits + km[:, None, None, :], dim=-1).to(dt)
        att = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, n, d)
        x = self.attn_ln(x + self.attn_out(att)).to(dt)
        m = self.output(K.activation(self.intermediate(x), "gelu"))
        return self.out_ln(x + m).to(dt)


class BertCaptionEncoder(nn.Module):
    """msclap 2022's caption tower: bert-base-uncased to its last hidden
    state, pooled at [CLS] (msclap ignores BERT's pooler head). The
    embedding is word[tokens] + pos[:L] + type[0] in f32 (positions from 0,
    token type 0), LayerNorm'd at eps ``text_ln_eps``; the pad mask comes
    from ``lengths``. The tables stay f32, as the reference adds them in
    f32."""

    def __init__(self, c: CLAPConfig):
        super().__init__()
        self.config = c
        w = c.text_width
        self.word_embeddings = nn.Parameter(torch.zeros(c.vocab_size, w))
        self.position_embeddings = nn.Parameter(
            torch.zeros(c.text_max_positions, w))
        self.token_type_embeddings = nn.Parameter(
            torch.zeros(c.text_type_vocab, w))
        self.emb_ln = BertLayerNorm(w, c.text_ln_eps)
        for i in range(c.text_layers):
            setattr(self, f"layer_{i}", BertBlock(
                w, c.text_heads, c.text_ln_eps, c.torch_dtype))

    def forward(self, tokens, lengths):
        """tokens (B, L) int, lengths (B,) int -> (B, width) f32, the [CLS]
        row of the last layer."""
        c = self.config
        n = tokens.shape[1]
        x = (self.word_embeddings[tokens] + self.position_embeddings[:n]
             + self.token_type_embeddings[0])
        x = self.emb_ln(x).to(c.torch_dtype)
        # [CLS] caption [SEP] [PAD]*: no query may read a pad key
        keep = (torch.arange(n, device=tokens.device)[None, :]
                < lengths.to(tokens.device)[:, None])
        km = torch.zeros(keep.shape, device=tokens.device).masked_fill(
            ~keep, -math.inf)
        for i in range(c.text_layers):
            x = getattr(self, f"layer_{i}")(x, km)
        return x[:, 0].float()


class Conv3x3(nn.Module):
    """A bias-free 3x3 convolution, padding 1, with its kernel in flax's
    HWIO layout (3, 3, in, out); the activations are channels-last."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout, dtype=dtype))

    def forward(self, x):
        """x (B, C, T, F) in channels_last memory -> (B, out, T, F)."""
        w = self.kernel.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return torch.nn.functional.conv2d(x, w, padding=1)


class Cnn14Encoder(nn.Module):
    """PANNs CNN14 (msclap 2022's ``audioenc_name: Cnn14``): log-mel -> the
    bn0 affine per mel bin (f32) -> six conv blocks (3x3 conv in the compute
    dtype, then the folded-BN affine and relu in f32, twice; a 2x2 average
    pool after blocks 1 to 5) -> mean over mel bins -> max + mean over time
    -> fc1 + relu in f32: the embedding msclap projects.

    Block 6 does not pool, as upstream PANNs' and msclap's ``Cnn14.forward``
    (``conv_block6(x, pool_size=(1, 1))``): 690 frames x 64 bins end at
    21 x 2. The reference pools there too and ends at 10 x 1 (ROADMAP
    Queue C 1: a deliberate deviation of the port)."""

    def __init__(self, c: CLAPConfig):
        super().__init__()
        self.config = c
        dt = c.torch_dtype
        # PANNs' bn0 over mel bins folded into an affine: (x + 40) / 40
        # until a checkpoint's running statistics replace it
        self.bn0_scale = nn.Parameter(torch.full((c.n_mels,), 1.0 / 40.0))
        self.bn0_bias = nn.Parameter(torch.ones(c.n_mels))
        cin = 1
        for i, ch in enumerate(c.cnn14_channels):
            blk = f"conv_block{i + 1}"
            for j in (1, 2):
                setattr(self, f"{blk}_conv{j}", Conv3x3(cin, ch, dt))
                setattr(self, f"{blk}_bn{j}_scale",
                        nn.Parameter(torch.ones(ch)))
                setattr(self, f"{blk}_bn{j}_bias",
                        nn.Parameter(torch.zeros(ch)))
                cin = ch
        final = c.cnn14_channels[-1]
        self.fc1 = Dense(final, final, torch.float32)

    def forward(self, mel):
        """mel (B, frames, n_mels) f32 log-mel -> (B, cnn14_channels[-1])
        f32."""
        c = self.config
        n = len(c.cnn14_channels)
        x = mel.float() * self.bn0_scale + self.bn0_bias
        # (B, 1, T, F) in channels_last memory: the reference's (B, T, F, 1)
        x = x.to(c.torch_dtype)[:, None].contiguous(
            memory_format=torch.channels_last)
        for i in range(n):
            blk = f"conv_block{i + 1}"
            for j in (1, 2):
                x = getattr(self, f"{blk}_conv{j}")(x)
                s = getattr(self, f"{blk}_bn{j}_scale")[:, None, None]
                t = getattr(self, f"{blk}_bn{j}_bias")[:, None, None]
                x = torch.relu(x.float() * s + t).to(c.torch_dtype)
            if i < n - 1:
                x = torch.nn.functional.avg_pool2d(x, 2)
        x = x.float().mean(dim=3)                        # over mel bins
        x = x.amax(dim=2) + x.mean(dim=2)                # over time
        return torch.relu(self.fc1(x))


class CLAP(nn.Module):
    def __init__(self, config: CLAPConfig):
        super().__init__()
        c = self.config = config
        dt = c.torch_dtype
        if c.audio_encoder_type == "cnn14":
            self.audio_encoder = Cnn14Encoder(c)
            final = c.cnn14_channels[-1]
        else:
            self.audio_encoder = HTSATEncoder(c)
            final = c.embed_dim * 2 ** (len(c.depths) - 1)
        self.caption_encoder = (BertCaptionEncoder(c)
                                if c.text_encoder_type == "bert"
                                else CaptionEncoder(c))
        self.audio_projection = Projection(final, c.joint_dim, dt)
        self.caption_projection = Projection(c.text_width, c.joint_dim, dt)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_audio(self, mel, normalize: bool = True):
        z = self.audio_projection(self.audio_encoder(mel))
        return _l2_normalize(z) if normalize else z

    def encode_text(self, tokens, lengths, normalize: bool = True):
        z = self.caption_projection(self.caption_encoder(tokens, lengths))
        return _l2_normalize(z) if normalize else z


@torch.no_grad()
def init_random_(model: CLAP, seed: int = 0) -> CLAP:
    """Seeded random weights, drawn on the CPU from torch.Generator(seed) in
    the reference's initialiser families: lecun-normal kernels (a
    convolution's fan-in is 3 x 3 x in), N(0, 0.02) embeddings and bias
    tables (the GPT2 tower's positions N(0, 0.01)), zero biases, unit
    LayerNorm scales; CNN14's folded-BN affines at scale 1 and bias 0, the
    bn0 affine (1/40, 1) and logit_scale at their init."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "bn0_bias") or leaf.endswith("_scale"):
            continue
        if leaf == "bias" or leaf.endswith("_bias"):
            p.zero_()
            continue
        if leaf == "kernel":
            std = 1.0 / math.sqrt(math.prod(p.shape[:-1]))
        elif name == "caption_encoder.positional_embedding":
            std = 0.01
        else:
            std = 0.02
        p.copy_(torch.randn(p.shape, generator=g) * std)
    return model

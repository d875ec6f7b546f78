"""The embed fold: a ViT's patch embed, positional + cls table, ``ln_pre``
and first attention block in one kernel entry (wise_tpu/ops/embed_block.py).

``fused_embed_attn_block`` keeps the JAX wrapper's signature and layout
without its TPU arguments (``interpret``, ``group``): xp (B, SP, p*p*3) bf16
patchified pixels whose row 0 and rows >= n_valid are zero; ``kern`` the
patch convolution's kernel as (p*p*3, D) bf16; ``posc`` the (SP, D) f32
table of positions with the class embedding added to row 0 (pad rows zero);
``ln_pre`` and LN1 parameters f32; the attention weights as ops/block.py
takes them. It returns the first layer's output (B, SP, D), f32 unless
``bf16_out``. Rows >= n_valid are the kernel's to leave undefined.

On a CPU tensor it computes ``plain_embed_attn``; on a CUDA tensor it
launches ``wt_embed_attn_block`` (csrc/block_kernels.cu: the patch GEMM with
the table added to the f32 accumulator in its epilogue, ``ln_pre`` into the
residual stream, then ``wt_attn_block``'s chain) or raises. ``LAUNCHES``
counts the launches.

| wrapper                | TPU kernel it replaces                        |
| ---------------------- | --------------------------------------------- |
| fused_embed_attn_block | fused_embed_attn_block (embed_block.py:138)   |

The patch GEMM takes K = p*p*3 in 16-byte rows (a multiple of 8) and zero-fills
its last K step of 64 past K. The wrapper zero-pads K (xp's last axis and
kern's rows) to a multiple of 32 on the card: 3072 at /32 and 768 at /16 go
as they are, 588 at /14 becomes 608. The zero columns add nothing to the
product.

Like the reference, the model does not call the fold: ``supports_embed_fold``
reads a table that is empty, and a shape enters it only when a measurement
on the card shows the fold beating the split entry (the model's patch GEMM,
cls / positions, ``ln_pre``, then ``fused_attn_block``).
"""

from __future__ import annotations

import torch

from .block import (HEAD_DIMS, MAX_SEQ, _check_param, _is_f32, _ptrs,
                    _require, _stream, layer_norm_f32, plain_attn_block)
from .build import LaunchCounter, check, load_library, refuse_grad

_launches = LaunchCounter("fused_embed_attn_block")
#: kernel launches since the last reset_launches()
LAUNCHES = _launches.counts
#: the same launches keyed by (wrapper, SP, D)
LAUNCHES_BY_SHAPE = _launches.by_shape
reset_launches = _launches.reset

#: (SP, D) shapes on which the fold replaces the split entry. Empty, as the
#: reference's ``_CALIBRATED_EMBED`` is.
_CALIBRATED_EMBED: set = set()
#: the multiple the wrapper pads K to (the GEMM itself takes any multiple
#: of 8: csrc/common.cuh)
_K_STEP = 32


def supports_embed_fold(seq: int, width: int, heads: int, dtype) -> bool:
    """Whether a tower of this shape takes the fold: bf16, head_dim 64, a
    sequence the attention kernel takes, and (seq, width) in the table. The
    reference also asks for the monolithic block's own calibration and a
    batch that its VMEM group divides: TPU terms, not ported."""
    if dtype != torch.bfloat16 or heads < 1 or width % heads:
        return False
    return (width // heads == 64 and 1 <= seq <= MAX_SEQ
            and (seq, width) in _CALIBRATED_EMBED)


def plain_embed_attn(xp, kern, posc, lnp_s, lnp_b, ln_s, ln_b, wqkv, bqkv,
                     wo, bo, heads: int, n_valid: int, bf16_out: bool = False):
    """The fold's arithmetic in plain PyTorch: the patch product and the
    table add in f32 (one rounding fewer than the model's split entry,
    which rounds the product to bf16 first), ``ln_pre`` in f32, the stream
    rounded to its dtype, then ``plain_attn_block``."""
    t = xp.float() @ kern.float() + posc.float()
    x = layer_norm_f32(t, lnp_s, lnp_b).to(
        torch.bfloat16 if bf16_out else torch.float32)
    return plain_attn_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads,
                            n_valid)


def fused_embed_attn_block(xp, kern, posc, lnp_s, lnp_b, ln_s, ln_b, wqkv,
                           bqkv, wo, bo, heads: int, n_valid: int,
                           bf16_out: bool = False):
    """xp (B, SP, PD) bf16 -> the first attention block's output (B, SP, D)
    in the stream dtype (f32, or bf16 with ``bf16_out``)."""
    params = (kern, posc, lnp_s, lnp_b, ln_s, ln_b, wqkv, bqkv, wo, bo)
    if not xp.is_cuda:
        return plain_embed_attn(xp, *params, heads, n_valid, bf16_out)
    name = "fused_embed_attn_block"
    refuse_grad(name, (xp, *params),
                "the fold has no training rule, in the reference either")
    _require(xp.dim() == 3, f"{name}: xp must be (B, SP, PD)")
    b, sp, pd = xp.shape
    d = kern.shape[-1]
    _require(b >= 1 and 1 <= sp <= MAX_SEQ,
             f"{name}: batch {b} / sequence {sp} outside [1, {MAX_SEQ}]")
    _require(d % 32 == 0, f"{name}: width {d} not a multiple of 32")
    _require(heads >= 1 and d % heads == 0 and d // heads in HEAD_DIMS,
             f"{name}: head_dim {d / max(heads, 1):g} not in {HEAD_DIMS}")
    _require(1 <= n_valid <= sp, f"{name}: n_valid {n_valid} not in [1, {sp}]")
    dev, bf, f32 = xp.device, torch.bfloat16, torch.float32
    _check_param(xp, (b, sp, pd), bf, dev, f"{name} xp")
    _check_param(kern, (pd, d), bf, dev, f"{name} kern")
    _check_param(posc, (sp, d), f32, dev, f"{name} posc")
    for t, n in ((lnp_s, "lnp_s"), (lnp_b, "lnp_b"), (ln_s, "ln_s"),
                 (ln_b, "ln_b")):
        _check_param(t, (d,), f32, dev, f"{name} {n}")
    _check_param(wqkv, (d, 3 * d), bf, dev, f"{name} wqkv")
    _check_param(bqkv, (3 * d,), bf, dev, f"{name} bqkv")
    _check_param(wo, (d, d), bf, dev, f"{name} wo")
    _check_param(bo, (d,), bf, dev, f"{name} bo")
    pad = -pd % _K_STEP
    if pad:
        xp = torch.nn.functional.pad(xp, (0, pad))
        kern = torch.nn.functional.pad(kern, (0, 0, 0, pad))
    lib = load_library()
    m = b * sp
    out_dt = bf if bf16_out else f32
    t = torch.empty((m, d), dtype=f32, device=dev)
    xs = torch.empty((m, d), dtype=out_dt, device=dev)
    y = torch.empty((m, d), dtype=bf, device=dev)
    qkv = torch.empty((m, 3 * d), dtype=bf, device=dev)
    att = torch.empty((m, d), dtype=bf, device=dev)
    out = torch.empty((b, sp, d), dtype=out_dt, device=dev)
    check(lib.wt_embed_attn_block(
        *_ptrs(xp, kern, posc, lnp_s, lnp_b, ln_s, ln_b, wqkv, bqkv, wo, bo,
               out), _is_f32(out), *_ptrs(t, xs, y, qkv, att), b, sp,
        pd + pad, d, heads, int(n_valid), _stream(xp)), name)
    _launches.add(name, sp, d)
    return out

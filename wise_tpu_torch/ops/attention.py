"""The attention middle on its own: a CUDA kernel and its plain version
(wise_tpu/ops/attention.py).

``fused_short_attention`` keeps the JAX wrapper's signature and layout: q, k
and v are (B, SP, H * hd) in their natural layout, the output is (B, SP, D).
It is what a CLIP tower runs between its in- and out-projection when the
block kernels are off and ``fused_attention`` is on. On a CPU tensor it
computes the plain version; on a CUDA tensor it launches ``wt_short_attention``
(csrc/block_kernels.cu: the block kernels' attention kernel, csrc/
attention.cuh, reading three tensors) or raises. ``LAUNCHES`` counts the
launches.

| wrapper                   | TPU kernel it replaces                    |
| ------------------------- | ----------------------------------------- |
| fused_short_attention     | fused_short_attention (attention.py:125)  |
| fused_attention_trainable | fused_attention_trainable (:222), its     |
|                           |   custom VJP (_fat_fwd, _fat_bwd)         |

``fused_attention_trainable`` is the training entry: with a gradient
required its forward is this kernel and its backward autograd through
``plain_short_attention`` at the saved q, k and v, with the same mask (the
reference's ``_fat_bwd`` is ``jax.vjp`` of its XLA attention, no kernel);
with none it is ``fused_short_attention``. The serve wrapper refuses a
gradient on the card.

The reference admits head_dim 64 only, for a TPU layout reason, and its
padded-head block (ops/block.py ``fused_attn_block_padded``) calls it on
128-lane slots; the kernel here is instantiated for 64, 80, 88, 104 and
128 (``HEAD_DIMS``, a set of its own: the block kernels take all but 128).
At 88 and 104 the kernel carries each head zero-filled to 96 / 112 columns
(one k16 step and one n-tile pair more; the pad adds 0 and is not stored).
The reference holds a whole (SP, SP) logits block per head; the kernel runs
query tiles of ``Q_TILE`` rows over key tiles of ``KEY_TILE``, S and P in
registers, in two passes: the first takes each row's max and sum online,
the second rounds the normalised p to bf16 before the PV product, where the
reference and the plain version round it. The reference pads the token axis
to a multiple of 8 and masks the pad through ``n_valid``; the kernel masks
its ragged tiles itself, so callers pass SP as it is.
"""

from __future__ import annotations

import math

import torch

from . import block
from .block import MAX_SEQ, _leaves, _needs_grad, _stream
from .build import LaunchCounter, check, load_library, refuse_grad

#: head dims the attention-middle kernel takes: the block kernels' and the
#: padded-head block's 128-lane slots
HEAD_DIMS = (*block.HEAD_DIMS, block.HEAD_PAD)
#: the kernel's query rows a block and keys a step of its loop
#: (csrc/attention.cuh kQTile, kKTile)
Q_TILE = KEY_TILE = 64

_launches = LaunchCounter("fused_short_attention")
#: kernel launches since the last reset_launches()
LAUNCHES = _launches.counts
#: the same launches keyed by (wrapper, SP, D)
LAUNCHES_BY_SHAPE = _launches.by_shape
reset_launches = _launches.reset


def plain_short_attention(q, k, v, heads: int, n_valid: int,
                          causal: bool = False, scale: float | None = None):
    """softmax(q k^T * scale) v per head, (B, SP, D): key columns >= n_valid
    are masked, ``causal`` also masks columns above the query row. f32 logits
    and softmax; p rounds to v's dtype before the PV product. ``scale``
    defaults to 1 / sqrt(D / heads)."""
    b, sp, d = q.shape
    hd = d // heads
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    col = torch.arange(sp, device=q.device)
    keep = (col < n_valid)[None, :]
    if causal:
        keep = keep & (col[None, :] <= col[:, None])
    qh, kh, vh = (t.reshape(b, sp, heads, hd) for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
    logits = logits.masked_fill(~keep, -math.inf)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, sp, d)


def _rows(t, b: int, sp: int, d: int, name: str) -> int:
    """The row stride (elements) of a (B, SP, D) bf16 tensor whose rows the
    kernel can walk: unit stride along D, one stride from row to row across
    examples (a contiguous tensor, or a column range of a packed
    in-projection), 16-byte aligned. The messages are formatted only on a
    refusal: at a served batch the kernel takes microseconds, and the checks
    run on every call."""
    where = "fused_short_attention " + name
    if not (t.shape == (b, sp, d) and t.dtype == torch.bfloat16):
        raise ValueError(f"{where}: must be a ({b}, {sp}, {d}) bfloat16 "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")
    st = t.stride()
    ld = st[1]
    if not (st[2] == 1 and ld >= d and (b == 1 or st[0] == sp * ld)):
        raise ValueError(f"{where}: rows must be evenly strided with unit "
                         "stride along D")
    if not (ld % 8 == 0 and t.data_ptr() % 16 == 0):
        raise ValueError(f"{where}: rows must be 16-byte aligned")
    return ld


def fused_short_attention(q, k, v, heads: int, n_valid: int,
                          causal: bool = False, scale: float | None = None):
    """q, k, v (B, SP, D) bf16 -> softmax(q k^T * scale) v per head as
    (B, SP, D) bf16; key columns >= n_valid are masked and, with ``causal``,
    columns above the query row. ``scale`` overrides 1 / sqrt(D / heads).
    Every query row is computed (rows >= n_valid attend to the valid keys
    like any other)."""
    if not q.is_cuda:
        return plain_short_attention(q, k, v, heads, n_valid, causal, scale)
    name = "fused_short_attention"
    refuse_grad(name, (q, k, v),
                "call fused_attention_trainable, which differentiates")
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (B, SP, D)")
    b, sp, d = q.shape
    if not (heads >= 1 and d % heads == 0 and d // heads in HEAD_DIMS):
        raise ValueError(f"{name}: head_dim {d / max(heads, 1):g} not in "
                         f"{HEAD_DIMS}")
    if not (b >= 1 and 1 <= sp <= MAX_SEQ):
        raise ValueError(f"{name}: batch {b} / sequence {sp} outside [1, "
                         f"{MAX_SEQ}]")
    if not 1 <= n_valid <= sp:
        raise ValueError(f"{name}: n_valid {n_valid} not in [1, {sp}]")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k and v must lie on one device")
    lds = [_rows(q, b, sp, d, "q"), _rows(k, b, sp, d, "k"),
           _rows(v, b, sp, d, "v")]
    scale = 1.0 / math.sqrt(d // heads) if scale is None else float(scale)
    lib = load_library()
    out = torch.empty((b, sp, d), dtype=torch.bfloat16, device=q.device)
    check(lib.wt_short_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *lds, out.data_ptr(), b, sp,
        d, heads, int(n_valid), int(causal), scale, _stream(q)), name)
    _launches.add(name, sp, d)
    return out


class _AttentionTrain(torch.autograd.Function):
    """fused_attention_trainable under a gradient: the kernel forward, and a
    backward that differentiates plain_short_attention at the saved q, k and
    v (the reference's ``_fat_bwd``). Masked key columns get no gradient;
    rows >= n_valid, which the kernel computes like any other, take the
    caller's cotangent, as in the reference."""

    @staticmethod
    def forward(ctx, q, k, v, heads, n_valid, causal):
        out = fused_short_attention(q, k, v, heads, n_valid, causal)
        ctx.save_for_backward(q, k, v)
        ctx.static = (heads, n_valid, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        heads, n_valid, causal = ctx.static
        q, k, v = _leaves(*ctx.saved_tensors)
        with torch.enable_grad():
            out = plain_short_attention(q, k, v, heads, n_valid, causal)
        return (*torch.autograd.grad(out, (q, k, v), g), None, None, None)


def fused_attention_trainable(q, k, v, heads: int, n_valid: int,
                              causal: bool = False):
    """fused_short_attention for the towers: under a gradient the same
    kernel forward and a recompute backward; with none the serve wrapper."""
    if not _needs_grad(q, k, v):
        return fused_short_attention(q, k, v, heads, n_valid, causal)
    return _AttentionTrain.apply(q, k, v, heads, n_valid, causal)

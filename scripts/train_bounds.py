#!/usr/bin/env python3
"""The least time an H100 could take for each training rule's forward and
backward at the shapes chip_smoke.py times them (its ``[backward]`` lines and
the padded block's rule in ``[padded]``), from the shapes alone.
chip_smoke.py prints the same bound on each ``[backward]`` line from
``work``.

    python3 scripts/train_bounds.py

Operations: forward + backward ~ 3x the forward's (the backward does two
products for each one of the forward), at 989 TFLOP/s. Bytes at 3.35 TB/s,
each once: the stream's x, out, d_out and d_x (f32 or bf16), the tensors the
forward saves for the backward, written and read (bf16 qkv for the attention
block, the bf16 pre-activation h for the MLP, k and v for the pooled blocks;
the padded block and the post-LN blocks save only their inputs, as they
recompute), and the weights read by the forward and the backward and their
gradients written; the post-LN attention block also reads its f32 key mask
twice. The attention middle has no weights: q, k and v are read by the
forward and again by the backward, out written, d_out read, and dq, dk and
dv written. The bound is the larger of the two times. Needs no card and no
JAX.
"""

from __future__ import annotations

PEAK_OPS, PEAK_BYTES = 989e12, 3.35e12

#: name -> (kind, B, SP, D, stream bytes an element, causal)
ROWS = {
    "fused_attn_block_train 256x50x768 f32": ("attn", 256, 50, 768, 4, False),
    "fused_attn_block_train 256x77x512 bf16 causal": (
        "attn", 256, 77, 512, 2, True),
    "fused_mlp_block_train 256x50x768 f32": ("mlp", 256, 50, 768, 4, False),
    "fused_mlp_split_train 32x257x1024 f32": ("mlp", 32, 257, 1024, 4,
                                              False),
    "fused_attn_block_pooled_train 256x50x768 f32": (
        "pooled", 256, 50, 768, 4, False),
    "fused_attn_block_pooled_dyn_train 256x77x512 bf16 causal": (
        "pooled", 256, 77, 512, 2, True),
    "fused_attn_block_padded_train 32x257x1280 f32": (
        "padded", 32, 257, 1280, 4, False),
    "fused_attn_block_train 32x257x1280 f32": ("attn", 32, 257, 1280, 4,
                                               False),
    "fused_mlp_split_train 32x257x1280 f32": ("mlp", 32, 257, 1280, 4,
                                              False),
    "fused_postln_attn_block_train 32x64x1024 bf16": (
        "postln_attn", 32, 64, 1024, 2, False),
    "fused_postln_mlp_block_train 32x64x1024 bf16": (
        "postln_mlp", 32, 64, 1024, 2, False),
    "fused_attention_trainable 256x50x768 bf16": (
        "attention", 256, 50, 768, 2, False),
    "fused_attention_trainable 256x77x512 bf16 causal": (
        "attention", 256, 77, 512, 2, True),
}


def work(kind, b, sp, d, xb, causal):
    """(operations, bytes) of forward + backward."""
    m, f = b * sp, 4 * d
    keys = (sp + 1) / 2 if causal else sp
    stream = 4 * m * d * xb                      # x, out, d_out, d_x
    if kind == "attention":
        # q, k, v twice, out, d_out, dq, dk, dv
        return 3 * 4 * m * keys * d, 11 * m * d * xb
    if kind in ("mlp", "postln_mlp"):
        weights = 2 * (2 * d * f + f + d) + 8 * d
        saved = 0 if kind == "postln_mlp" else 2 * 2 * m * f   # h_pre
        return 3 * 4 * m * d * f, stream + saved + 3 * weights
    weights = 2 * (4 * d * d + 4 * d) + 8 * d
    if kind == "pooled":
        fwd = 4 * m * d * d + 4 * b * d * d + 4 * b * keys * d
        saved = 2 * 2 * m * 2 * d                 # k and v
        stream = 2 * m * d * xb + 2 * b * d * xb  # x, d_x; out, d_out rows
        return 3 * fwd, stream + saved + 3 * weights
    fwd = 8 * m * d * d + 4 * m * keys * d
    if kind == "postln_attn":
        return 3 * fwd, stream + 2 * 4 * b * sp + 3 * weights   # km twice
    saved = 0 if kind == "padded" else 2 * 2 * m * 3 * d   # qkv
    return 3 * fwd, stream + saved + 3 * weights


def main() -> int:
    for name, (kind, b, sp, d, xb, causal) in ROWS.items():
        ops, nbytes = work(kind, b, sp, d, xb, causal)
        t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"{name}: bound_ms={max(t_ops, t_bytes):.4f} bound_by={by} "
              f"ops={ops:.4g} bytes={nbytes:.4g} ops_ms={t_ops:.4f} "
              f"bytes_ms={t_bytes:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

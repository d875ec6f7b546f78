"""Operations, bytes and least times, from shapes alone.

The yardstick of every roofline and MFU metric of the benchmark. It counts
the work a configuration's published shapes need, whatever kernel does it.

Copies, each naming its origin:

- ``PEAK_OPS``, ``PEAK_BYTES``, ``bound``, ``attn_work`` and ``mlp_work``:
  ``chip_smoke.py``'s ``PEAK_OPS`` / ``PEAK_BYTES``, ``_bound``,
  ``_attn_work`` and ``_mlp_work`` (with ``_LN_BYTES``), unchanged but for
  their names.
- ``train_work``: ``scripts/train_bounds.py``'s ``work``, unchanged but for
  its name.

The rest is this file's own: the forward operations of a tower, the
products the block GEMMs compute and the attention middles, per example.
"""

from __future__ import annotations

#: published dense peaks of one H100 SXM: bf16 operations/s, HBM bytes/s
PEAK_OPS, PEAK_BYTES = 989e12, 3.35e12
#: bytes of a LayerNorm's f32 scale and bias, per column
LN_BYTES = 8


def bound(ops: float, nbytes: float, peak_ops: float = PEAK_OPS):
    """(ms, which) of the least time the card could take: the larger of the
    operations over the peak of their type (bf16 unless given) and the bytes
    over the memory rate."""
    by_ops, by_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / PEAK_BYTES
    return ((by_ops, "operations") if by_ops >= by_bytes
            else (by_bytes, "bytes"))


def attn_work(b, sp, d, xb, keys, pooled=False):
    """(operations, bytes) of the attention block on x (b, sp, d) of ``xb``
    bytes an element, each query attending to ``keys`` keys on average
    (causal: what the mask leaves). Pooled: k/v for every row, q, attention
    and out-proj for one row an example."""
    m = b * sp
    weights = (4 * d * d + 4 * d) * 2 + LN_BYTES * d
    if pooled:
        return (4 * m * d * d + 4 * b * d * d + 4 * b * keys * d,
                m * d * xb + b * d * xb + weights)
    return 8 * m * d * d + 4 * m * keys * d, 2 * m * d * xb + weights


def mlp_work(m, d, f, xb, half=None):
    """(operations, bytes) of the MLP block on m rows; ``half`` "fc" (x in,
    h out) or "proj" (h and x in, out)."""
    if half == "fc":
        return (2 * m * d * f,
                m * d * xb + (d * f + f) * 2 + LN_BYTES * d + m * f * 2)
    if half == "proj":
        return 2 * m * d * f, m * f * 2 + (d * f + d) * 2 + 2 * m * d * xb
    return (4 * m * d * f,
            2 * m * d * xb + (2 * d * f + f + d) * 2 + LN_BYTES * d)


def train_work(kind, b, sp, d, xb, causal):
    """(operations, bytes) of a training rule's forward + backward."""
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


# ---------------------------------------------------------------------------
# towers, from a configuration file's "shapes"
# ---------------------------------------------------------------------------


def vision_tokens(v: dict) -> int:
    """Tokens of a vision tower: the patches, and the class token where the
    tower pools it."""
    return (v["image_size"] // v["patch_size"]) ** 2 + (v["pool"] == "cls")


def vision_products(v: dict, b: int):
    """The block GEMMs of a vision tower over b images, as (M, K, N, bytes of
    an A element, bytes of a C element): qkv, out-proj, fc and proj a layer;
    with a class-token tower's pooled last layer, k and v over every row and
    q and out-proj at the class row (its MLP runs on (b, D) rows outside the
    block kernels). A is bf16; the out-proj and proj write the residual
    stream (f32 for a class-token tower, bf16 for a MAP tower)."""
    sp, d, f = vision_tokens(v), v["width"], v["mlp_width"]
    m, xb = b * sp, 4 if v["pool"] == "cls" else 2
    whole = v["layers"] - (v["pool"] == "cls")
    out = []
    for _ in range(whole):
        out += [(m, d, 3 * d, 2, 2), (m, d, d, 2, xb), (m, d, f, 2, 2),
                (m, f, d, 2, xb)]
    if v["pool"] == "cls":
        out += [(m, d, 2 * d, 2, 2), (b, d, d, 2, 2), (b, d, d, 2, xb)]
    return out


def vision_attention(v: dict, b: int):
    """The attention middles of a vision tower over b images, as
    (operations, bytes): 4 * rows * keys * D operations; q, k, v and out
    read or written once in bf16. The pooled last layer of a class-token
    tower attends from its class row alone."""
    sp, d = vision_tokens(v), v["width"]
    whole = v["layers"] - (v["pool"] == "cls")
    full = (4 * b * sp * sp * d, 8 * b * sp * d)
    out = [full] * whole
    if v["pool"] == "cls":
        out.append((4 * b * sp * d, 2 * 2 * b * sp * d + 2 * 2 * b * d))
    return out


def product_ms(products) -> float:
    """The least time of a list of products, each bound alone:
    max(2 M K N / peak, (A + B + C bytes) / bandwidth), B bf16."""
    total = 0.0
    for m, k, n, ab, cb in products:
        total += bound(2 * m * k * n, m * k * ab + k * n * 2 + m * n * cb)[0]
    return total


def work_ms(items) -> float:
    """The least time of (operations, bytes) pairs, each bound alone."""
    return sum(bound(ops, nbytes)[0] for ops, nbytes in items)


def vision_forward_ops(v: dict) -> float:
    """Forward operations of one image through a vision tower: the patch
    embedding, the blocks (a class-token tower's last one at its class row
    only, all the embedding needs), the head (MAP's probe attention and MLP)
    and the projection (none where it is the identity). Elementwise work is
    not counted."""
    sp, d, f = vision_tokens(v), v["width"], v["mlp_width"]
    patches = (v["image_size"] // v["patch_size"]) ** 2
    ops = 2 * patches * (v["patch_size"] ** 2 * 3) * d
    ops += sum(2 * m * k * n for m, k, n, _, _ in vision_products(v, 1))
    ops += sum(o for o, _ in vision_attention(v, 1))
    if v["pool"] == "cls":
        ops += 2 * 2 * d * f                      # the pooled row's MLP
    else:
        # MAP: q of the probe, k and v of every token, one query row of
        # attention, out-proj, MLP
        ops += 2 * d * d + 2 * sp * d * 2 * d + 4 * sp * d
        ops += 2 * d * d + 2 * 2 * d * f
    if v.get("proj") == "identity":
        return ops
    return ops + 2 * d * v["embed_dim"]


def text_forward_ops(t: dict, tokens: int) -> float:
    """Forward operations of one caption of ``tokens`` positions through a
    post-LN text tower with mean pooling and an MLP head (XLM-R): every
    position through every layer, attention over every position."""
    d, f = t["width"], t["mlp_width"]
    layer = 2 * tokens * (3 * d * d + d * d + 2 * d * f)
    layer += 4 * tokens * tokens * d
    hidden = (d + t["embed_dim"]) // 2
    return t["layers"] * layer + 2 * d * hidden + 2 * hidden * t["embed_dim"]

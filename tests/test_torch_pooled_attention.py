"""The pooled attention kernel (wise_tpu_torch/csrc/block_kernels.cu
``attention_pooled_kernel``, the attention half of ``fused_attn_block_pooled``
and ``fused_attn_block_pooled_dyn``), rehearsed on the CPU, where it cannot
run: a numpy model that follows the kernel's own decomposition, with the
constants read from the source.

The model: a block per (example, group of G heads); key tiles of
kPoolSegs / G rows, as many as the kept keys need (n_valid, and with causal
the example's row + 1: the causal tile skip), rows past the last kept key
zero-filled; the block's threads in groups of 8 lanes, group gi taking
segments gi + groups r of each tile, always of head gi % G, each lane
its columns (8 contiguous at head_dim 64; at 80, 88 and 104 the 4-byte
words l8 + 8 i of the segment, ``pooled_col``: 5 words at 80, 6 or 5 at
88, 7 or 6 at 104), the dot summed across the 8 lanes by the xor
butterfly;
each group's running max, merged per head; exp(logit - max) summed per
thread (thread t: head t % G, flat indices t, t + threads, ...), then across
the warp's lanes by xor shuffles, then across the warps; p = bf16(e / sum),
rounded once after the division; P V accumulated per group in f32 and the
groups of a head summed into att, rounded to bf16. Rows are clamped into
[0, SP).

Held against:
- a float64 reference that rounds p at the same point: the model's p must
  equal bf16 of the float64 p wherever that p lies further than 2^-16 (in
  relative terms) from a bf16 rounding midpoint; nearer one, f32 noise in
  the logits, the maximum and the sum (~1e-6 relative) may round either
  way, and both neighbours pass. Given the model's own p, its unrounded
  output must be within 1e-5 relative (L2 over the output) of the float64
  P V: the f32 accumulation of at most 640 terms;
- ``ops/block.py`` ``_softmax_attend`` (the port's plain version, through
  ``plain_pooled_attention``) and the attention of the JAX
  ``_pooled_block_xla`` / ``_pooled_block_xla_dyn`` (read off their output
  with out-proj = I, bias 0): bf16 outputs within 2 bf16 ulps of each
  (example, head)'s largest |att|. One ulp is the two sides' own bf16
  rounding of att; the other covers a p that the two round differently (a
  p rounded one ulp apart moves att by at most 2^-8 p |v|, under one ulp of
  the largest |att| since att = sum p v);
- planted model faults, which must fail the float64 check: the last key
  tile dropped, the maximum taken from the first tile only (on inputs with
  a key in the last tile whose logit is ~150 above the rest: exp
  overflows),
  p rounded before the normalisation, and at 88 and 104 the head's last 8
  columns dropped (what a lane's run of HD / 16 pairs would do).

The lanes' shared reads are held, from the source's constants, to 4-byte
alignment, no bank conflict within a read instruction, every column read
by one lane and every lane busy.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops import block as J
from wise_tpu_torch.ops import block as K

CU = Path(__file__).resolve().parents[1] / "wise_tpu_torch" / "csrc" / \
    "block_kernels.cu"


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CU.read_text()).group(1))


THREADS, ROUNDS, MAX_GROUP = (_constant("kPoolThreads"),
                              _constant("kPoolRounds"),
                              _constant("kPoolMaxGroup"))
GROUPS = THREADS // 8            # 8-lane groups of a block
SEGS = GROUPS * ROUNDS           # (key, head) segments of a tile
WARPS = THREADS // 32
SPS = [1, 50, 77, 257, 577, 640]
HEAD_DIMS = [64, 80, 88, 104]
WIDE = tuple(hd for hd in HEAD_DIMS if hd // 8 % 2)  # 88, 104: padded
#: (hd, sp) the model is held at: every length at 64 and 80; at the wide
#: head dims one key, a ragged tile, ViT-g / bigG's 257 keys and the most
HD_SP = ([(hd, sp) for hd in (64, 80) for sp in SPS]
         + [(hd, sp) for hd in WIDE for sp in (1, 77, 257, 640)])
HEADS = 4


def bf16(x):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def _f32_sum(terms, axis):
    """Sum along ``axis`` one term after the other, in float32."""
    terms = np.moveaxis(terms, axis, 0)
    acc = np.zeros(terms.shape[1:], np.float32)
    for t in terms:
        acc = (acc + t).astype(np.float32)
    return acc


def _butterfly(v, offsets, axis=-1):
    """v[l] + v[l ^ off] along ``axis`` for each offset in turn: the xor
    shuffles of a warp."""
    n = v.shape[axis]
    for off in offsets:
        perm = np.arange(n) ^ off
        v = (v + np.take(v, perm, axis=axis)).astype(np.float32)
    return v


def lane_cols(hd):
    """(8, E) segment columns of each lane, in the order its loop takes
    them (block_kernels.cu ``pooled_col``); hd where a lane has none (its
    word past HD / 2 reads as 0)."""
    if hd == 64:
        return np.arange(8)[:, None] * 8 + np.arange(8)[None, :]
    e = 2 * (-(-(hd // 2) // 8))
    cols = np.array([[2 * (l8 + 8 * (i >> 1)) + (i & 1) for i in range(e)]
                     for l8 in range(8)])
    return np.where(cols < hd, cols, hd)


def _kept(sp, n_valid, row, causal):
    return min(n_valid, row + 1) if causal else n_valid


def model(q, kv, heads, n_valid, rows=None, pool_row=0, causal=False,
          group=1, fault=None):
    """The kernel's arithmetic: q (B, D), kv (B, SP, 2D) float32 (bf16
    values) -> (att bf16 as float32 (B, D), the unrounded f32 output
    (B, D), p (B, heads, SP) float32)."""
    b_n, sp, d2 = kv.shape
    d = d2 // 2
    hd = d // heads
    lanes = lane_cols(hd)             # (8, columns of a lane)
    g_n = group
    tk = SEGS // g_n                  # keys of a tile
    scale = np.float32(1.0 / np.sqrt(np.float32(hd)))
    att = np.zeros((b_n, d), np.float32)
    out = np.zeros((b_n, d), np.float32)
    p_all = np.zeros((b_n, heads, sp), np.float32)
    seg = np.arange(SEGS)
    seg_key, seg_head, seg_group = seg // g_n, seg % g_n, seg % GROUPS
    for b in range(b_n):
        row = (pool_row if rows is None
               else int(np.clip(rows[b], 0, sp - 1)))
        kend = _kept(sp, n_valid, row, causal)
        tiles = -(-kend // tk)
        if fault == "last_key_tile_dropped":
            tiles -= 1
            kend = min(kend, tiles * tk)
        for h0 in range(0, heads, g_n):
            cols = slice(h0 * hd, (h0 + g_n) * hd)
            qh = q[b, cols].reshape(g_n, hd)
            if fault == "last_8_columns_dropped":
                qh = np.concatenate([qh[:, :hd - 8],
                                     np.zeros((g_n, 8), np.float32)], 1)
            # a zero column at hd for the lanes' missing words
            qh = np.pad(qh, ((0, 0), (0, 1)))[:, lanes]
            logits = np.full((tiles * tk, g_n), -np.inf, np.float32)
            gmax = np.full(GROUPS, -np.inf, np.float32)
            for t in range(tiles):
                keys = t * tk + seg_key
                ok = keys < kend
                kt = np.where(ok[:, None], kv[b, np.minimum(keys, sp - 1),
                                              cols.start:cols.stop]
                              .reshape(SEGS, g_n, hd)[seg, seg_head], 0)
                kl = np.pad(kt, ((0, 0), (0, 1)))[:, lanes]
                part = _f32_sum(qh[seg_head] * kl, -1)
                s = _butterfly(part, (4, 2, 1))[:, 0]
                lg = np.where(ok, (s * scale).astype(np.float32), -np.inf)
                logits[keys, seg_head] = lg
                if fault != "max_from_first_tile" or t == 0:
                    np.maximum.at(gmax, seg_group, lg.astype(np.float32))
            mh = np.array([gmax[h::g_n].max() for h in range(g_n)],
                          np.float32)
            flat = logits.reshape(-1)
            n_exp = kend * g_n
            n_pad = -(-n_exp // THREADS) * THREADS
            e = np.zeros(n_pad, np.float32)
            with np.errstate(over="ignore"):
                e[:n_exp] = np.exp(flat[:n_exp] - mh[np.arange(n_exp) % g_n])
            thread = _f32_sum(e.reshape(-1, THREADS), 0)
            offs = [o for o in (1, 2, 4, 8, 16) if o >= g_n]
            warp = _butterfly(thread.reshape(WARPS, 32), offs)
            sh = _f32_sum(warp[:, :g_n], 0)
            with np.errstate(invalid="ignore"):
                if fault == "p_rounded_before_normalisation":
                    pf = bf16(e[:n_exp]) / sh[np.arange(n_exp) % g_n]
                else:
                    pf = bf16(e[:n_exp] / sh[np.arange(n_exp) % g_n])
            p = np.zeros((tiles * tk) * g_n, np.float32)
            p[:n_exp] = pf
            p = p.reshape(tiles * tk, g_n)
            acc = np.zeros((GROUPS, hd), np.float32)
            for t in range(tiles):
                keys = t * tk + seg_key
                ok = keys < kend
                vt = np.where(ok[:, None], kv[b, np.minimum(keys, sp - 1),
                                              d + cols.start:d + cols.stop]
                              .reshape(SEGS, g_n, hd)[seg, seg_head], 0)
                pv = p[keys, seg_head][:, None] * vt
                if fault == "last_8_columns_dropped":
                    pv[:, hd - 8:] = 0
                for r in range(ROUNDS):
                    rs = slice(r * GROUPS, (r + 1) * GROUPS)
                    acc = (acc + pv[rs]).astype(np.float32)
            o = np.stack([_f32_sum(acc[h::g_n], 0) for h in range(g_n)])
            out[b, cols] = o.reshape(-1)
            att[b, cols] = bf16(o).reshape(-1)
            n_keys = min(tiles * tk, sp)
            p_all[b, h0:h0 + g_n, :n_keys] = p[:n_keys].T
    return att, out, p_all


def reference64(q, kv, heads, n_valid, rows=None, pool_row=0, causal=False):
    """float64 logits and softmax; (p64 (B, heads, SP), v as float64)."""
    b_n, sp, d2 = kv.shape
    d = d2 // 2
    hd = d // heads
    f = np.float64
    qh = q.astype(f).reshape(b_n, heads, hd)
    kh = kv[..., :d].astype(f).reshape(b_n, sp, heads, hd)
    logits = np.einsum("bhd,bkhd->bhk", qh, kh) / np.sqrt(hd)
    row = (np.full(b_n, pool_row) if rows is None
           else np.clip(rows, 0, sp - 1))
    col = np.arange(sp)[None, :]
    keep = col < n_valid
    if causal:
        keep = keep & (col <= row[:, None])
    logits = np.where(keep[:, None, :], logits, -np.inf)
    logits -= logits.max(-1, keepdims=True)
    ex = np.exp(logits)
    return ex / ex.sum(-1, keepdims=True)


def _p_ok(p_model, p64):
    """p_model == bf16(p64), but where p64 lies within 2^-16 relative of a
    bf16 rounding midpoint: there either neighbour."""
    p32 = p64.astype(np.float32)
    want = bf16(p32)
    bits = want.view(np.uint32).astype(np.int64)
    down = (bits - 0x10000).clip(0).astype(np.uint32).view(np.float32)
    up = (bits + 0x10000).astype(np.uint32).view(np.float32)
    mid_lo, mid_hi = (want + down) / 2, (want + up) / 2
    near = ((np.abs(p64 - mid_lo) <= 2.0 ** -16 * p64)
            | (np.abs(p64 - mid_hi) <= 2.0 ** -16 * p64))
    ok = (p_model == want) | (near & ((p_model == down) | (p_model == up)))
    return bool(np.isfinite(p_model).all() and ok.all())


def _out_ok(out, p_model, kv, heads):
    """The model's unrounded output against the float64 P V of its own p."""
    b_n, sp, d2 = kv.shape
    d = d2 // 2
    hd = d // heads
    vh = kv[..., d:].astype(np.float64).reshape(b_n, sp, heads, hd)
    want = np.einsum("bhk,bkhd->bhd", p_model.astype(np.float64),
                     vh).reshape(b_n, d)
    if not np.isfinite(out).all():
        return False
    return bool(np.linalg.norm(out - want)
                <= 1e-5 * max(np.linalg.norm(want), 1e-30))


def _holds(q, kv, heads, n_valid, rows, pool_row, causal, group,
           fault=None):
    att, out, p = model(q, kv, heads, n_valid, rows, pool_row, causal, group,
                        fault)
    p64 = reference64(q, kv, heads, n_valid, rows, pool_row, causal)
    return _p_ok(p, p64) and _out_ok(out, p, kv, heads)


def _inputs(seed, b, sp, hd, heads=HEADS, scale=1.0):
    """q, kv as bf16 values (float32): q ~ N(0, scale²), k and v ~ N(0, 1):
    logits ~ N(0, scale²)."""
    rng = np.random.default_rng(seed)
    d = heads * hd
    q = bf16(scale * rng.standard_normal((b, d)).astype(np.float32))
    kv = bf16(rng.standard_normal((b, sp, 2 * d)).astype(np.float32))
    return q, kv


#: (rows or None, pool_row, causal, n_valid) by mode, for SP = sp; the rows
#: run past both ends of [0, SP) (clamped, as the kernel clamps them)
def _mode(mode, sp):
    if mode == "row0":
        return None, 0, False, sp
    if mode == "n_valid":
        return None, sp - 1, False, max(1, sp - sp // 3)
    if mode == "causal_rows":
        return (np.array([0, sp // 2, sp - 1, sp + 5, -3], np.int32), 0,
                True, sp)
    if mode == "causal_static":
        return None, sp // 2, True, max(1, sp - sp // 5)
    raise ValueError(mode)


MODES = ["row0", "n_valid", "causal_rows", "causal_static"]


def _torch_att(q, kv, heads, n_valid, rows, pool_row, causal):
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tkv = torch.from_numpy(kv).to(torch.bfloat16)
    tr = None if rows is None else torch.from_numpy(rows)
    return K.plain_pooled_attention(tq, tkv, heads, n_valid, tr, pool_row,
                                    causal).float().numpy()


def _within_ulps(got, want, heads, ulps=2):
    """|got - want| <= ulps bf16 ulps of each (example, head)'s largest
    |want|."""
    b_n, d = want.shape
    w = want.reshape(b_n, heads, -1)
    top = np.abs(w).max(-1, keepdims=True)
    ulp = np.where(top > 0, 2.0 ** (np.floor(np.log2(np.where(
        top > 0, top, 1.0))) - 7), 0.0)
    err = np.abs(got.reshape(b_n, heads, -1) - w)
    return bool(np.isfinite(got).all() and (err <= ulps * ulp).all())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hd,sp", HD_SP)
def test_model_against_float64_and_the_plain_version(hd, sp, mode):
    rows, pool_row, causal, n_valid = _mode(mode, sp)
    b = 5 if rows is not None else 3
    q, kv = _inputs(hash((hd, sp, mode)) % 2 ** 31, b, sp, hd, scale=0.3)
    want = _torch_att(q, kv, HEADS, n_valid, rows, pool_row, causal)
    for group in (1, 2, 4):
        assert _holds(q, kv, HEADS, n_valid, rows, pool_row, causal, group)
        att = model(q, kv, HEADS, n_valid, rows, pool_row, causal, group)[0]
        assert _within_ulps(att, want, HEADS)


def _sixteen_heads(hd, groups):
    q, kv = _inputs(7, 2, 257, hd, heads=16, scale=0.3)
    want = _torch_att(q, kv, 16, 257, None, 0, False)
    for group in groups:
        assert _holds(q, kv, 16, 257, None, 0, False, group)
        att = model(q, kv, 16, 257, None, 0, False, group)[0]
        assert _within_ulps(att, want, 16)


def test_model_at_vit_h_group_of_sixteen():
    """ViT-H/14's pooled row: 16 heads of 80 over 257 keys, a block taking
    all 16 heads (tiles of 4 keys) and 4 (the grid the card picks)."""
    _sixteen_heads(80, (16, 4))


@pytest.mark.parametrize("hd", WIDE)
def test_model_at_vit_g_and_bigg_groups(hd):
    """ViT-g-14's and ViT-bigG-14's pooled row: 16 heads of 88 or 104 over
    257 keys, a block taking all 16 heads, 8 (the grid the card picks) and
    4."""
    _sixteen_heads(hd, (16, 8, 4))


def _jax_attention(hd, sp, seed, rows, pool_row, causal, n_valid):
    """(q, kv as float32, the attention read off the JAX reference): x
    small against the attention (std 0.01; its LayerNorm is scale-free up
    to eps), out-proj the identity and its bias 0, so out = x_row + att in
    bf16."""
    rng = np.random.default_rng(seed)
    b = 5 if rows is not None else 3
    d = HEADS * hd
    x = jnp.asarray(0.01 * rng.standard_normal((b, sp, d)), jnp.bfloat16)
    ln_s = jnp.asarray(1 + 0.02 * rng.standard_normal(d), jnp.float32)
    ln_b = jnp.asarray(0.02 * rng.standard_normal(d), jnp.float32)
    wqkv = jnp.asarray(rng.standard_normal((d, 3 * d)) * d ** -0.5,
                       jnp.bfloat16)
    bqkv = jnp.asarray(0.02 * rng.standard_normal(3 * d), jnp.bfloat16)
    wo = jnp.eye(d, dtype=jnp.bfloat16)
    bo = jnp.zeros(d, jnp.bfloat16)
    # q, k, v as _pooled_block_xla(_dyn) computes them, op for op
    y = J._ln_f32(x.astype(jnp.float32), ln_s, ln_b).astype(x.dtype)
    kv = y @ wqkv[:, d:] + bqkv[d:]
    if rows is None:
        yq = y[:, pool_row, :]
        out = J._pooled_block_xla(x, ln_s, ln_b, wqkv, bqkv, wo, bo, HEADS,
                                  n_valid, pool_row, causal)
        xr = x[:, pool_row, :]
    else:
        r = jnp.asarray(rows)
        yq = y[jnp.arange(b), r]
        out = J._pooled_block_xla_dyn(x, r, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                      HEADS, n_valid, causal)
        xr = x[jnp.arange(b), r]
    q = yq @ wqkv[:, :d] + bqkv[:d]
    f = np.float32
    return (np.asarray(q.astype(jnp.float32), f),
            np.asarray(kv.astype(jnp.float32), f),
            np.asarray(out.astype(jnp.float32), f),
            np.asarray(xr.astype(jnp.float32), f))


@pytest.mark.parametrize("kind", ["static", "dyn"])
@pytest.mark.parametrize("hd,sp", [(hd, sp) for hd, sp in HD_SP
                                   if hd not in WIDE or sp in (77, 257)])
def test_model_against_the_jax_reference(hd, sp, kind):
    """Static rows (row 0, causal at the middle row with n_valid < SP) and
    per-example causal rows in range (0, the middle, SP - 1)."""
    if kind == "static":
        cases = [(None, 0, False, sp),
                 (None, sp // 2, True, max(1, sp - sp // 5))]
    else:
        cases = [(np.array([0, sp // 2, sp - 1, sp // 3, sp - 1],
                           np.int32), 0, True, sp)]
    for i, (rows, pool_row, causal, n_valid) in enumerate(cases):
        q, kv, out, xr = _jax_attention(hd, sp, 100 * hd + sp + i, rows,
                                        pool_row, causal, n_valid)
        att = model(q, kv, HEADS, n_valid, rows, pool_row, causal, 2)[0]
        mine = bf16(xr + att)
        # att within 2 ulps of each (example, head)'s largest |att| (as
        # against the plain version), and the residual add rounded once on
        # each side: one ulp of the largest |output|
        b_n = out.shape[0]

        def ulp(v):
            top = np.abs(v.reshape(b_n, HEADS, -1)).max(-1, keepdims=True)
            return 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)

        err = np.abs((mine - out).reshape(b_n, HEADS, -1))
        assert np.isfinite(mine).all()
        assert (err <= 2 * ulp(att) + ulp(out)).all()


def _peaked(hd, sp, seed, group):
    """Inputs whose one key in the last tile has a logit of 200 in head 0,
    ~150 above the others: q at 12 along every column of head 0 (the other
    keys' logits there ~ N(0, 12²)) and that key at 200 / (12 sqrt(hd))."""
    q, kv = _inputs(seed, 2, sp, hd, scale=0.3)
    tk = SEGS // group
    last = ((sp - 1) // tk) * tk
    q[:, :hd] = 12.0
    kv[:, last, :hd] = bf16(np.full(hd, 200.0 / (12.0 * np.sqrt(hd)),
                                    np.float32))
    return q, kv


FAULTS = ["last_key_tile_dropped", "max_from_first_tile",
          "p_rounded_before_normalisation"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("hd,sp", [(hd, sp) for hd in HEAD_DIMS
                                   for sp in (77, 257, 640)
                                   if hd not in WIDE or sp == 257])
def test_planted_model_faults_fail(hd, sp, fault):
    """Each fault fails the float64 check where the correct model passes,
    at every head group; the maximum from the first tile only is a fault
    that shows where a later tile holds a far larger logit."""
    for group in (1, 4):
        q, kv = _peaked(hd, sp, sp + hd, group)
        assert _holds(q, kv, HEADS, sp, None, 0, False, group)
        assert not _holds(q, kv, HEADS, sp, None, 0, False, group, fault)


@pytest.mark.parametrize("sp", [77, 257])
@pytest.mark.parametrize("hd", WIDE)
def test_dropped_last_columns_fail(hd, sp):
    """The head's last 8 columns dropped from the logits and the output
    (a lane loop of HD / 16 pairs at 88 or 104) fails the float64 check, on
    ordinary inputs, at every head group."""
    for group in (1, 4):
        q, kv = _inputs(hd + sp, 2, sp, hd, scale=1.0)
        assert _holds(q, kv, HEADS, sp, None, 0, False, group)
        assert not _holds(q, kv, HEADS, sp, None, 0, False, group,
                          "last_8_columns_dropped")


def test_lane_reads_are_aligned_conflict_free_and_cover_the_segment():
    """For each head dim, from the source's constants: the segment stride
    in the ring (HD, or kPoolWideSeg at 88 and 104) holds whole 16-byte
    chunks (the copies' destinations); a lane's reads are 4-byte aligned
    words (16 bytes at 64) inside the segment; every column of the head is
    read by exactly one lane; every lane reads (none idle, at most one
    word more than another); and each read instruction's 32 lanes (4
    groups of 8 at segments 4 w + j + 16 r) fall in 32 distinct banks, or,
    at 64, 4 quarter-warp phases of 128 contiguous bytes."""
    src = CU.read_text()
    assert "2 * (l8 + 8 * (i >> 1)) + (i & 1)" in src
    wide_seg = _constant("kPoolWideSeg")
    for hd in HEAD_DIMS:
        seg = wide_seg if hd in WIDE else hd           # bf16
        assert (seg * 2) % 16 == 0 and seg >= hd
        lanes = lane_cols(hd)
        cols = lanes[lanes < hd]
        assert sorted(cols.tolist()) == list(range(hd))
        per_lane = (lanes < hd).sum(1)
        assert per_lane.min() >= 1 and per_lane.max() - per_lane.min() <= 2
        if hd == 64:  # one 16-byte read a lane, 8 lanes' 128 bytes a phase
            assert (lanes[:, 0] * 2 % 16 == 0).all()
            assert (np.diff(lanes, axis=1) == 1).all()
            continue
        assert (lanes[:, 0::2] % 2 == 0).all()        # 4-byte aligned pairs
        for r in range(ROUNDS):
            for warp in range(WARPS):
                for i in range(lanes.shape[1] // 2):
                    banks = set()
                    for j in range(4):
                        gi = 4 * warp + j
                        s_idx = gi + r * GROUPS
                        for l8 in range(8):
                            w = l8 + 8 * i
                            assert w < seg // 2   # inside the segment
                            banks.add((s_idx * seg // 2 + w) % 32)
                    assert len(banks) == 32, (hd, r, warp, i)


def test_constants_fit_the_kernel():
    """Every head group the launcher allows divides the groups (so a group
    keeps one head) and a tile; a tile holds at least one key at 16 heads;
    HD / 8 columns a lane at both head dims."""
    assert THREADS % 32 == 0 and GROUPS % MAX_GROUP == 0
    for g in (1, 2, 4, 8, MAX_GROUP):
        assert GROUPS % g == 0 and SEGS % g == 0 and SEGS // g >= 1
    for hd in HEAD_DIMS:
        assert hd % 8 == 0
    # the ring and 640 keys' logits of 16 heads fit a block's 227 KB at
    # every head dim; at 257 keys and 4 heads a block leaves room for the
    # blocks an SM its launch bounds ask for (pooled_blocks_per_sm)
    stages = _constant("kPoolStages")
    red = GROUPS + WARPS * MAX_GROUP
    for hd in HEAD_DIMS:
        seg = _constant("kPoolWideSeg") if hd in WIDE else hd

        def smem(sp, g):
            tk = SEGS // g
            return stages * SEGS * seg * 2 + (-(-sp // tk) * tk * g + red) * 4
        assert smem(640, MAX_GROUP) <= 232448
        assert (233472 // (smem(257, 4) + 1024)) >= _blocks_per_sm(hd)


def test_cpu_wrapper_is_the_plain_version():
    """pooled_attention on CPU tensors computes plain_pooled_attention;
    the plain pooled block goes through the same function."""
    q, kv = _inputs(3, 3, 50, 64)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tkv = torch.from_numpy(kv).to(torch.bfloat16)
    rows = torch.tensor([0, 25, 49], dtype=torch.int32)
    got = K.pooled_attention(tq, tkv, HEADS, 40, rows, causal=True)
    want = K.plain_pooled_attention(tq, tkv, HEADS, 40, rows, causal=True)
    assert torch.equal(got, want)
    assert not any(K.LAUNCHES.values())


def _blocks_per_sm(hd):
    """block_kernels.cu pooled_blocks_per_sm: kPoolBlocksSm, or
    kPoolWideBlocksSm where the ring's segments are padded (HD / 8 odd)."""
    return _constant("kPoolWideBlocksSm" if hd in WIDE else "kPoolBlocksSm")


def _pooled_group(b, h, hd, sms=132):
    """block_kernels.cu pooled_group: the largest power-of-two G <= 16
    dividing h whose grid of b x h / G blocks still fills half the blocks
    an SM holds (_blocks_per_sm: 4 of 8; 3 of 6 at the wide head dims) on
    every SM."""
    slots = _blocks_per_sm(hd) // 2 * sms
    g = 1
    while 2 * g <= MAX_GROUP and h % (2 * g) == 0 and b * (h // (2 * g)) \
            >= slots:
        g *= 2
    return g


def test_pooled_group_picks_at_the_paths_shapes():
    """The rule, with each head dim's blocks an SM read from the source's
    constants, and its picks on an H100's 132 SMs: 4 at ViT-H/14 and ViT-B/32, 8 at ViT-g-14 and ViT-bigG-14 (one
    wave of 512 blocks, where 4 left 1.3 waves), 1 at ViT-L/14-336's batch
    of 64 and at the text towers' batches of 8."""
    assert [_blocks_per_sm(hd) for hd in HEAD_DIMS] == [8, 8, 6, 6]
    picks = {"vit_h": _pooled_group(256, 16, 80),
             "vit_b32": _pooled_group(256, 12, 64),
             "vit_g": _pooled_group(256, 16, 88),
             "vit_bigg": _pooled_group(256, 16, 104),
             "vit_l336": _pooled_group(64, 16, 64),
             "text": _pooled_group(8, 8, 64)}
    assert picks == {"vit_h": 4, "vit_b32": 4, "vit_g": 8, "vit_bigg": 8,
                     "vit_l336": 1, "text": 1}

"""The arithmetic of the port's attention kernel (wise_tpu_torch/csrc/
attention.cuh, ``attention_kernel``), rehearsed on the CPU.

The kernel cannot run here, so this file holds a numpy model of what it
computes, step for step: query tiles of ``Q_TILE`` rows; two passes over key
tiles of ``KEY_TILE`` (the last one ragged, zero-filled past the last key a
row of the tile keeps, causal tiles past the tile's last row never visited).
Pass 1 carries the f32 running max and sum per row, the max taken as 0 while
it is -inf; pass 2 rounds p = exp(s - m) / sum to bf16 before the PV product,
as the reference does, and the f32 sum of p v rounds to bf16 once.

The model is held to the JAX package's ``fused_short_attention`` run in
interpret mode (the Pallas TPU kernel, as tests/test_fused_attention.py runs
it) at the tolerance the port's plain version meets there
(tests/test_torch_short_attention.py): per-token cosine >= 0.999 and max abs
error <= 1e-2. The key mask of the post-LN block is held to the port's plain
post-LN attention, NaN for NaN.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops import attention as JA
from wise_tpu_torch.ops import postln_block as P
from wise_tpu_torch.ops.attention import KEY_TILE, Q_TILE


def bf16(x):
    """Round f32 values to bf16 (to nearest, ties to even), kept as f32."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    r = (u + ((u >> 16) & 1) + np.uint32(0x7FFF)) & np.uint32(0xFFFF0000)
    return np.where(np.isnan(x), x, r.view(np.float32))


def online_attention(q, k, v, heads, n_valid, causal=False, scale=None,
                     km=None, guard=True, visits=None):
    """q, k, v (B, SP, D) f32 holding bf16 values; km (B, SP) f32 or None.
    Returns (B, SP, D) f32 holding bf16 values, NaN on a row with no kept
    key. ``guard=False`` drops the -inf guard; ``visits``, a list, gets
    (first query row, head, first key) of every key tile pass 2 computes."""
    b, sp, d = q.shape
    hd = d // heads
    scale = np.float32(1.0 / math.sqrt(hd) if scale is None else scale)
    out = np.empty((b, sp, d), np.float32)
    for q0 in range(0, sp, Q_TILE):
        rows = np.arange(q0, min(q0 + Q_TILE, sp))
        kend = min(n_valid, q0 + Q_TILE, sp) if causal else n_valid
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)

            def tile(j0):
                """(logits, V) of the key tile at j0: keys past kend zero."""
                keys = np.arange(j0, j0 + KEY_TILE)
                real = keys < kend
                kt = np.zeros((b, KEY_TILE, hd), np.float32)
                vt = np.zeros((b, KEY_TILE, hd), np.float32)
                kt[:, real] = k[:, keys[real], cols]
                vt[:, real] = v[:, keys[real], cols]
                s = np.einsum("bqd,bkd->bqk", q[:, rows, cols], kt,
                              dtype=np.float32) * scale
                if km is not None:
                    s = s + np.where(real, km[:, np.minimum(keys, sp - 1)],
                                     0)[:, None, :].astype(np.float32)
                keep = (keys < n_valid)[None, None, :]
                if causal:
                    keep = keep & (keys[None, :] <= rows[:, None])[None]
                return np.where(keep, s, -np.inf).astype(np.float32), vt

            m = np.full((b, len(rows)), -np.inf, np.float32)
            l = np.zeros((b, len(rows)), np.float32)
            for j0 in range(0, kend, KEY_TILE):      # pass 1
                s, _ = tile(j0)
                mt = np.maximum(m, s.max(-1))
                u = (np.where(mt == -np.inf, 0, mt).astype(np.float32)
                     if guard else mt)
                with np.errstate(invalid="ignore"):
                    l = l * np.exp(m - u) + np.exp(s - u[..., None]).sum(
                        -1, dtype=np.float32)        # 0 while m was -inf
                m = mt
            mu = np.where(m == -np.inf, 0, m).astype(np.float32)
            o = np.zeros((b, len(rows), hd), np.float32)
            for j0 in range(0, kend, KEY_TILE):      # pass 2
                if visits is not None:
                    visits.append((q0, h, j0))
                s, vt = tile(j0)
                with np.errstate(invalid="ignore"):  # no kept key: 0 / 0
                    p = bf16(np.exp(s - mu[..., None]) / l[..., None])
                o = o + np.einsum("bqk,bkd->bqd", p, vt, dtype=np.float32)
            out[:, rows, cols] = bf16(o)
    return out


def _agree(got, want, d):
    """Per-token cosine >= 0.999 and max abs error <= 1e-2, on the rows
    where the reference is finite; NaN exactly where it is NaN."""
    g, w = got.reshape(-1, d), want.reshape(-1, d)
    nan = np.isnan(w).any(-1)
    assert (np.isnan(g).any(-1) == nan).all()
    g, w = g[~nan], w[~nan]
    cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                             * np.linalg.norm(w, axis=-1))
    assert cos.min() >= 0.999, cos.min()
    assert np.abs(g - w).max() <= 1e-2, np.abs(g - w).max()


#: (B, SP, D, heads, n_valid, causal, scale): head_dim 64, 80 and 128 at
#: 50, 77 and 257 tokens; SP 130 leaves a 2-key last tile; n_valid 64 at
#: 77 tokens ends the loop on a whole tile
CASES = {
    "hd64-50": (3, 50, 128, 2, 50, False, None),
    "hd64-77-causal": (2, 77, 128, 2, 77, True, None),
    "hd64-257-n_valid": (1, 257, 128, 2, 250, False, None),
    "hd64-77-tile_end": (2, 77, 128, 2, 64, False, None),
    "hd64-130-ragged": (2, 130, 128, 2, 130, False, None),
    "hd80-50-n_valid": (2, 50, 160, 2, 43, False, None),
    "hd80-77-causal": (2, 77, 160, 2, 77, True, None),
    "hd80-257-n_valid": (1, 257, 160, 2, 250, False, None),
    "hd128-50-scale": (2, 50, 256, 2, 50, False, 80 ** -0.5),
    "hd128-77-causal-n_valid": (2, 77, 256, 2, 70, True, None),
    "hd128-257-causal-n_valid": (1, 257, 256, 2, 250, True, 80 ** -0.5),
}


def _qkv(case, seed=90):
    b, sp, d = CASES[case][:3]
    rng = np.random.default_rng(seed)
    return [bf16(rng.standard_normal((b, sp, d)).astype(np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("case", list(CASES))
def test_online_arithmetic_matches_tpu_kernel(case):
    _, _, d, heads, n_valid, causal, scale = CASES[case]
    qkv = _qkv(case)
    want = np.asarray(JA.fused_short_attention(
        *[jnp.asarray(t, jnp.bfloat16) for t in qkv], heads=heads,
        n_valid=n_valid, causal=causal, interpret=True, scale=scale),
        np.float32)
    _agree(online_attention(*qkv, heads, n_valid, causal, scale), want, d)


def test_the_model_runs_several_key_tiles_and_skips_causal_ones():
    """The loop's edges: 257 keys make 5 key tiles for each of 5 query tiles
    (the last tile holds one key); n_valid 250 ends it after 4; with causal,
    query tile t visits key tiles 0..t alone."""
    qkv = _qkv("hd64-257-n_valid")
    for n_valid, causal, want in ((257, False, 5 * 5), (250, False, 5 * 4),
                                  (257, True, 1 + 2 + 3 + 4 + 5)):
        visits = []
        online_attention(*qkv, 2, n_valid, causal, visits=visits)
        assert len(visits) == 2 * want
    assert max(j0 for _, _, j0 in visits) == 4 * KEY_TILE


def _postln_qkv(seed, b, sp, d):
    """x (B, SP, D) bf16 and its in-projection as the plain post-LN
    attention computes it, so that both see the same q, k, v."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, sp, d)).astype(
        np.float32)).to(torch.bfloat16)
    wqkv = torch.from_numpy((rng.standard_normal((d, 3 * d)) * d ** -0.5)
                            .astype(np.float32)).to(torch.bfloat16)
    bqkv = torch.from_numpy((rng.standard_normal(3 * d) * 0.02).astype(
        np.float32)).to(torch.bfloat16)
    q, k, v = (x @ wqkv + bqkv).float().numpy().reshape(
        b, sp, 3, d).transpose(2, 0, 1, 3)
    return x, wqkv, bqkv, (q, k, v)


@pytest.mark.parametrize("sp,d,heads", [(64, 128, 2), (77, 160, 2),
                                        (130, 256, 2)],
                         ids=["hd64-64", "hd80-77", "hd128-130"])
def test_key_mask_matches_plain_postln_attention(sp, d, heads):
    """km as the post-LN block takes it (0 keep, -inf drop, n_valid = SP):
    example 0 keeps a prefix, example 1 drops every key of its first tile
    (the -inf guard: its rows find their first kept key in the second tile
    or, at 64 tokens, none), example 2 drops every key (NaN in both)."""
    b = 3
    x, wqkv, bqkv, qkv = _postln_qkv(91, b, sp, d)
    km = np.zeros((b, sp), np.float32)
    km[0, sp - 9:] = -np.inf
    km[1, :KEY_TILE + 3] = -np.inf
    km[2] = -np.inf
    want = P.plain_postln_attention(x, torch.from_numpy(km)[:, None], wqkv,
                                    bqkv, heads).float().numpy()
    got = online_attention(*qkv, heads, sp, km=km)
    assert np.isnan(want[2]).all() and np.isnan(got[2]).all()
    assert np.isnan(want[1]).all() == (sp <= KEY_TILE + 3)
    _agree(got, want, d)


def test_the_guard_is_what_keeps_a_late_key_finite():
    """A row whose first key tile is all masked finds its kept keys in the
    second: finite with the -inf guard, NaN without it (exp(-inf - -inf)
    poisons the running sum)."""
    x, wqkv, bqkv, qkv = _postln_qkv(92, 1, 130, 128)
    km = np.zeros((1, 130), np.float32)
    km[0, :KEY_TILE] = -np.inf
    want = P.plain_postln_attention(x, torch.from_numpy(km)[:, None], wqkv,
                                    bqkv, 2).float().numpy()
    got = online_attention(*qkv, 2, 130, km=km)
    assert np.isfinite(want).all()
    _agree(got, want, 128)
    assert np.isnan(online_attention(*qkv, 2, 130, km=km, guard=False)).all()

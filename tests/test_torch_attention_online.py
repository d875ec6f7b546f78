"""The arithmetic of the port's attention kernel (wise_tpu_torch/csrc/
attention.cuh, ``attention_kernel``), rehearsed on the CPU.

The kernel cannot run here, so this file holds a numpy model of what it
computes, step for step: query tiles of ``Q_TILE`` rows; two passes over key
tiles of ``KEY_TILE`` (the last one ragged, zero-filled past the last key a
row of the tile keeps, causal tiles past the tile's last row never visited).
Pass 1 carries the f32 running max and sum per row, the max taken as 0 while
it is -inf; pass 2 rounds p = exp(s - m) / sum to bf16 before the PV product,
as the reference does, and the f32 sum of p v rounds to bf16 once.

Head dims 88 and 104 (ViT-g-14, ViT-bigG-14) are not a multiple of the
m16n8k16 step: the kernel carries each head's tile zero-filled to 96 / 112
columns (``attn_pad_dim``), one k16 step and one pair of n-tiles more. The
model computes on such padded tiles too, and two planted faults show why:
the tail dropped (a bare ``HD / 16`` steps, the last 8 columns neither in
the logits nor stored) and the pad left unzeroed (what shared memory held
before) must each fail. The rows' padding (``attn_ld``: the padded head_dim
and ``kAttnRowPad``) is read from the source and held to 16-byte-aligned,
bank-conflict-free ldmatrix reads.

The model is held to the JAX package's ``fused_short_attention`` run in
interpret mode (the Pallas TPU kernel, as tests/test_fused_attention.py runs
it) at the tolerance the port's plain version meets there
(tests/test_torch_short_attention.py): per-token cosine >= 0.999 and max abs
error <= 1e-2. The key mask of the post-LN block is held to the port's plain
post-LN attention, NaN for NaN.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops import attention as JA
from wise_tpu_torch.ops import postln_block as P
from wise_tpu_torch.ops import attention as TA
from wise_tpu_torch.ops.attention import KEY_TILE, Q_TILE

CUH = Path(__file__).resolve().parents[1] / "wise_tpu_torch" / "csrc" / \
    "attention.cuh"


def _cuh_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CUH.read_text()).group(1))


def pad_dim(hd):
    """attention.cuh attn_pad_dim: head_dim rounded up to the k16 step."""
    return -(-hd // 16) * 16


def bf16(x):
    """Round f32 values to bf16 (to nearest, ties to even), kept as f32."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    r = (u + ((u >> 16) & 1) + np.uint32(0x7FFF)) & np.uint32(0xFFFF0000)
    return np.where(np.isnan(x), x, r.view(np.float32))


def online_attention(q, k, v, heads, n_valid, causal=False, scale=None,
                     km=None, guard=True, visits=None, fault=None):
    """q, k, v (B, SP, D) f32 holding bf16 values; km (B, SP) f32 or None.
    Returns (B, SP, D) f32 holding bf16 values, NaN on a row with no kept
    key. ``guard=False`` drops the -inf guard; ``visits``, a list, gets
    (first query row, head, first key) of every key tile pass 2 computes.
    Each head's Q, K and V tiles are ``pad_dim(hd)`` columns, zero past hd;
    ``fault``: "tail_dropped" computes hd // 16 k16 steps and n-tile pairs
    alone (a bare HD / 16: the last hd % 16 columns neither in the logits
    nor in the output, which keeps what the staging rows held, here 0);
    "pad_unzeroed" leaves the pad columns of Q, K and V at what shared
    memory held before (here each row's own first hp - hd columns)."""
    b, sp, d = q.shape
    hd = d // heads
    hp = pad_dim(hd)
    used = hd // 16 * 16 if fault == "tail_dropped" else hp
    scale = np.float32(1.0 / math.sqrt(hd) if scale is None else scale)
    out = np.empty((b, sp, d), np.float32)
    for q0 in range(0, sp, Q_TILE):
        rows = np.arange(q0, min(q0 + Q_TILE, sp))
        kend = min(n_valid, q0 + Q_TILE, sp) if causal else n_valid
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)
            stale = slice(0, hp - hd)  # what the pad held, under the fault
            qt = np.zeros((b, len(rows), hp), np.float32)
            qt[..., :hd] = q[:, rows, cols]

            def tile(j0):
                """(logits, V) of the key tile at j0: keys past kend zero."""
                keys = np.arange(j0, j0 + KEY_TILE)
                real = keys < kend
                kt = np.zeros((b, KEY_TILE, hp), np.float32)
                vt = np.zeros((b, KEY_TILE, hp), np.float32)
                kt[:, real, :hd] = k[:, keys[real], cols]
                vt[:, real, :hd] = v[:, keys[real], cols]
                if fault == "pad_unzeroed":
                    kt[:, :, hd:] = kt[:, :, stale]
                    vt[:, :, hd:] = vt[:, :, stale]
                    qt[..., hd:] = qt[..., stale]
                s = np.einsum("bqd,bkd->bqk", qt[..., :used], kt[..., :used],
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
            o = np.zeros((b, len(rows), hp), np.float32)
            for j0 in range(0, kend, KEY_TILE):      # pass 2
                if visits is not None:
                    visits.append((q0, h, j0))
                s, vt = tile(j0)
                with np.errstate(invalid="ignore"):  # no kept key: 0 / 0
                    p = bf16(np.exp(s - mu[..., None]) / l[..., None])
                o[..., :used] = o[..., :used] + np.einsum(
                    "bqk,bkd->bqd", p, vt[..., :used], dtype=np.float32)
            out[:, rows, cols] = bf16(o[..., :hd])
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
    "hd88-50": (2, 50, 176, 2, 50, False, None),
    "hd88-77-causal": (2, 77, 176, 2, 77, True, None),
    "hd88-257-n_valid": (1, 257, 176, 2, 250, False, None),
    "hd104-50-n_valid": (2, 50, 208, 2, 43, False, None),
    "hd104-77-causal": (2, 77, 208, 2, 77, True, None),
    "hd104-257": (1, 257, 208, 2, 257, False, None),
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


@pytest.mark.parametrize("fault", ["tail_dropped", "pad_unzeroed"])
@pytest.mark.parametrize("case", ["hd88-77-causal", "hd88-257-n_valid",
                                  "hd104-50-n_valid", "hd104-257"])
def test_planted_faults_fail_at_the_wide_head_dims(case, fault):
    """At 88 and 104 the model passes against the Pallas kernel and each
    planted fault fails: the last 8 columns dropped (the bare case of a
    ``switch`` entry, which compiles), and the pad columns not zeroed."""
    _, _, d, heads, n_valid, causal, scale = CASES[case]
    qkv = _qkv(case)
    want = np.asarray(JA.fused_short_attention(
        *[jnp.asarray(t, jnp.bfloat16) for t in qkv], heads=heads,
        n_valid=n_valid, causal=causal, interpret=True, scale=scale),
        np.float32)
    _agree(online_attention(*qkv, heads, n_valid, causal, scale), want, d)
    with pytest.raises(AssertionError):
        _agree(online_attention(*qkv, heads, n_valid, causal, scale,
                                fault=fault), want, d)


def test_shared_rows_are_aligned_and_conflict_free():
    """attention.cuh's rows, from its constants: each head dim the kernel
    is instantiated for pads to whole k16 steps (hd + at most 8 columns,
    the one 16-byte chunk the kernel zeroes), and a shared row of
    pad_dim(hd) + kAttnRowPad bf16 is a whole number of 16-byte groups and
    an odd one, so the 8 rows one ldmatrix phase reads (8 x 16 bytes at the
    row stride) land in 8 distinct 16-byte bank groups of 128 bytes. A row
    of hd + 8 would not be at 88 and 104: the rule is needed there."""
    src = CUH.read_text()
    assert "return (HD + 15) / 16 * 16;" in src
    assert "return attn_pad_dim<HD>() + kAttnRowPad;" in src
    row_pad = _cuh_int("kAttnRowPad")
    for hd in TA.HEAD_DIMS:
        hp = pad_dim(hd)
        assert hd % 8 == 0 and 0 <= hp - hd <= 8 and hp % 16 == 0
        ld_bytes = (hp + row_pad) * 2
        assert ld_bytes % 16 == 0 and (ld_bytes // 16) % 2 == 1, hd
        groups = {(r * ld_bytes // 16) % 8 for r in range(8)}
        assert len(groups) == 8, hd
        # each ldmatrix address, row r at k16 step st and half 0 / 1, is
        # 16-byte aligned and its 8 columns lie inside the padded row
        ld = hp + row_pad
        for r in range(64):
            for st in range(hp // 16):
                for half in (0, 1):
                    col = st * 16 + 8 * half
                    assert (r * ld + col) * 2 % 16 == 0 and col + 8 <= hp
    for hd in (88, 104):
        bare = (hd + 8) * 2
        assert len({(r * bare // 16) % 8 for r in range(8)}) < 8

"""The arithmetic of the port's window attention kernel (wise_tpu_torch/csrc/
swin_kernels.cu, ``window_attention_kernel<HD>``, in the chain of both
``fused_window_attention`` and ``fused_swin_block`` at C > 384; their fused
``swin_attn_kernel`` runs the same arithmetic), rehearsed on the CPU.

The kernel cannot run here, so this file holds a numpy model of what it
computes, step for step:

- the grid: a CTA per (head, residue r of the shift mask's period, chunk of
  the residue's window list), the head fastest, the lists cut into as many
  chunks as fill the card's resident CTA slots (``window_lists``);
- per CTA, the bias + mask fragment of head h and residue r, pre-summed in
  f32 once, keys >= L at -inf; then its windows one after another:
- S = Q K^T over head_dim in mma.sync steps, m16n8k16 while 16 columns
  remain and one m16n8k8 for the rest, each step's sum rounded to f32 and
  added to the f32 accumulator; K and V rows >= L zero;
- logit = f32(S * scale) + (bias + mask); the row max; exp in f32, 0 for a
  logit 64 or more below the max; the sum as the kernel takes it (each lane
  of a quad sums its 16 keys in order, then the two quad shuffles);
  p = bf16(e / sum);
- O = P V in four k-steps of 16 keys, f32 sums a step; rows < L stored in
  bf16.

Wrapped in the qkv and out-projection GEMMs (f32 sums, bias, bf16 out), the
model is held to the JAX package's ``fused_window_attention`` in interpret
mode (the Pallas TPU kernel, as tests/test_torch_swin.py runs it), or at
L = 49, which the JAX gate refuses (seq % 8), to the port's
``plain_window_attention``, which tests/test_torch_swin.py holds to the JAX
kernel. The bar is that file's: per-token cosine >= 0.999 and max abs error
<= 5% of the reference's max abs (``ops.block.increment_agreement`` over a
zero base). The model's exp is numpy's, not the card's expf (within 2 ulp).
Planted faults must fail the same bar: the k8 step dropped, the mask of
residue r + 1, the bias of head h + 1, and keys >= L left unmasked (the rows
that follow the window in memory loaded in their place).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops.swin_attention import fused_window_attention as j_attn
from wise_tpu_torch.models.clap.model import (relative_position_index,
                                              shift_attn_mask)
from wise_tpu_torch.ops import swin_attention as SA
from wise_tpu_torch.ops.block import increment_agreement

SOURCE = (Path(__file__).resolve().parents[1] / "wise_tpu_torch" / "csrc"
          / "swin_kernels.cu")
MAX_L = 64            # kWinMaxL: a window's rows in a shared stage
EXP_FLOOR = -64.0     # kWinExpFloor: exp(d) at or below it is 0
#: resident CTA slots of an H100: 132 SMs x 4 CTAs (128 registers a thread)
H100_SLOTS = 132 * 4
FAULTS = ("k8_dropped", "mask_of_next_residue", "bias_of_next_head",
          "ragged_keys_unmasked")


def bf16(x):
    """Round f32 values to bf16 (to nearest, ties to even), kept as f32."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    r = (u + ((u >> 16) & 1) + np.uint32(0x7FFF)) & np.uint32(0xFFFF0000)
    return np.where(np.isnan(x), x, r.view(np.float32))


def f32(x):
    return np.asarray(x, np.float32)


def win_ld(hd: int) -> int:
    """A shared row of q, k or v in bf16 elements (``win_ld<HD>``)."""
    return hd if (hd // 8) % 2 else hd + 8


def k_steps(hd: int, fault=None):
    """(first column, depth) of the QK^T mma steps over head_dim."""
    steps = [(c, 16) for c in range(0, hd - hd % 16, 16)]
    if hd % 16 and fault != "k8_dropped":
        steps.append((hd - 8, 8))
    return steps


def window_lists(n: int, heads: int, periods: int, slots: int):
    """The launcher's grid in blockIdx.x order: (h, r, windows) a CTA."""
    per_residue = n // periods
    lists = heads * periods
    fit = slots // lists
    chunks = 1 if fit < 1 else min(fit, per_residue)
    chunk = -(-per_residue // chunks)
    chunks = -(-per_residue // chunk)
    ctas = []
    for bx in range(lists * chunks):
        h, lst = bx % heads, bx // heads
        r, first = lst % periods, (lst // periods) * chunk
        count = min(chunk, per_residue - first)
        ctas.append((h, r, [r + periods * (first + i)
                            for i in range(count)]))
    return ctas


def quad_sum(e):
    """The kernel's row sum of e (..., 64): lane t of a quad adds keys
    8n + 2t, 8n + 2t + 1 for n = 0..7 in order, then v + shfl_xor 1, then
    + shfl_xor 2."""
    part = []
    for t in range(4):
        s = np.zeros(e.shape[:-1], np.float32)
        for n in range(8):
            for b in range(2):
                s = f32(s + e[..., 8 * n + 2 * t + b])
        part.append(s)
    return f32(f32(part[0] + part[1]) + f32(part[2] + part[3]))


def cta(qkv, att, n, l, c, heads, h, r, windows, bias, mask, fault=None):
    """One CTA: head h of ``windows`` (all of residue r), into att."""
    hd = c // heads
    scale = f32(1.0) / np.sqrt(f32(hd))
    # the fragment, once for the walk: bias[h] + mask[r]; keys >= L -inf,
    # rows >= L (never stored) 0
    hb = (h + 1) % heads if fault == "bias_of_next_head" else h
    bm = np.zeros((MAX_L, MAX_L), np.float32)
    tab = bias[hb]
    if mask is not None:
        rm = (r + 1) % len(mask) if fault == "mask_of_next_residue" else r
        tab = f32(tab + mask[rm])
    bm[:l, :l] = tab
    if fault != "ragged_keys_unmasked":
        bm[:, l:] = -np.inf
    # the stages: q, k, v of head h, rows >= L zero (or, with the fault, the
    # rows that follow the window in memory)
    w = np.asarray(windows)
    rows = w[:, None] * l + np.arange(MAX_L)[None]
    keep = np.arange(MAX_L)[None] < l
    if fault == "ragged_keys_unmasked":
        keep = rows < n * l
    rows = np.where(keep, rows, 0)

    def part(i):
        cols = slice(i * c + h * hd, i * c + (h + 1) * hd)
        return np.where(keep[..., None], qkv[rows, cols], 0).astype(
            np.float32)

    q, k, v = part(0), part(1), part(2)
    s = np.zeros((len(w), MAX_L, MAX_L), np.float32)
    for c0, depth in k_steps(hd, fault):
        step = np.einsum("wqd,wkd->wqk", q[..., c0:c0 + depth].astype(
            np.float64), k[..., c0:c0 + depth].astype(np.float64))
        s = f32(s + f32(step))
    logit = f32(f32(s * scale) + bm)
    m = logit.max(-1, keepdims=True)
    d = f32(logit - m)
    e = np.where(d > EXP_FLOOR, np.exp(d), 0).astype(np.float32)
    p = bf16(e / quad_sum(e)[..., None])
    o = np.zeros((len(w), MAX_L, hd), np.float32)
    for kk in range(MAX_L // 16):
        keys = slice(16 * kk, 16 * kk + 16)
        o = f32(o + f32(np.einsum("wqk,wkd->wqd", p[..., keys].astype(
            np.float64), v[:, keys].astype(np.float64))))
    out = att.reshape(n, l, c)
    out[w, :, h * hd:(h + 1) * hd] = bf16(o[:, :l])


def model_window_attention(x, wqkv, bqkv, wo, bo, bias, mask, heads,
                           slots=H100_SLOTS, fault=None):
    """out_proj(the kernel's window attention of qkv(x)): x (N, L, C) and
    the weights f32 arrays holding bf16 values; the port's GEMMs sum in f32
    and round to bf16 after their bias."""
    n, l, c = x.shape
    qkv = bf16(f32(x.reshape(n * l, c).astype(np.float64) @ wqkv) + bqkv)
    att = np.full((n * l, c), np.nan, np.float32)
    periods = 1 if mask is None else len(mask)
    for h, r, windows in window_lists(n, heads, periods, slots):
        cta(qkv, att, n, l, c, heads, h, r, windows, bias, mask, fault)
    assert not np.isnan(att).any(), "a (window, head) left unwritten"
    return bf16(f32(att.astype(np.float64) @ wo) + bo).reshape(n, l, c)


#: name -> (window, C, heads, res of the shifted map or None, examples (the
#: windows where unshifted), CTA slots, reference): HTSAT stage 0 (head_dim
#: 24) shifted (64 windows an example) and not, stage 3 (32 heads); 16
#: tokens at head_dim 8, 16 and 32; 49 tokens (window 7) at head_dim 8, 16,
#: 24 and 32 against the plain version. Slots few enough that most CTAs walk
#: several windows.
CASES = {
    "stage0-shifted": (8, 96, 4, 64, 1, 64, "jax"),
    "stage0": (8, 96, 4, None, 16, 20, "jax"),
    "stage3": (8, 768, 32, None, 4, 40, "jax"),
    "l16-hd8": (4, 32, 4, 8, 2, 8, "jax"),
    "l16-hd16": (4, 32, 2, 8, 2, 4, "jax"),
    "l16-hd32": (4, 64, 2, 8, 2, H100_SLOTS, "jax"),
    "l49-hd8": (7, 32, 4, 14, 2, 8, "plain"),
    "l49-hd16": (7, 32, 2, 14, 2, 4, "plain"),
    "l49-hd24": (7, 96, 4, 14, 2, 16, "plain"),
    "l49-hd32": (7, 64, 2, None, 4, 4, "plain"),
}


def _inputs(case, seed=80):
    """x ~ N(0, 1) (bf16 values); kernels at 1/sqrt(fan_in); the relative
    bias table at std 1 (so that the wrong head's shows); biases N(0,
    0.02); the shift mask of a res x res map (n_win windows) or None."""
    window, c, heads, res, examples = CASES[case][:5]
    rng = np.random.default_rng(seed)
    l = window * window
    n_win = (res // window) ** 2 if res else 1

    def w(*shape, std=0.02):
        return bf16(std * rng.standard_normal(shape))

    x = bf16(rng.standard_normal((examples * n_win, l, c)))
    table = f32(rng.standard_normal(((2 * window - 1) ** 2, heads)))
    idx = relative_position_index(window).reshape(-1)
    bias = np.ascontiguousarray(
        table[idx].reshape(l, l, heads).transpose(2, 0, 1))
    mask = (f32(shift_attn_mask(res, res, window, window // 2)) if res
            else None)
    attn = (w(c, 3 * c, std=c ** -0.5), w(3 * c), w(c, c, std=c ** -0.5),
            w(c))
    return x, attn, bias, mask, heads


def _reference(case, inputs):
    x, attn, bias, mask, heads = inputs
    if CASES[case][6] == "jax":
        def j(a, dt=jnp.bfloat16):
            return None if a is None else jnp.asarray(a, dt)
        want = j_attn(j(x), *[j(a) for a in attn], j(bias, jnp.float32),
                      j(mask, jnp.float32), heads=heads, interpret=True)
        return np.asarray(want, np.float32)
    t = torch.from_numpy
    return SA.plain_window_attention(
        t(x).bfloat16(), *[t(a).bfloat16() for a in attn], t(bias),
        None if mask is None else t(mask), heads).float().numpy()


def _check(got, want):
    return increment_agreement(torch.from_numpy(got), torch.from_numpy(want),
                               torch.zeros(()))


@pytest.fixture(scope="module")
def refs():
    """The reference of each case, computed once (the JAX kernel in
    interpret mode compiles per shape)."""
    return {}


def _case(case, refs):
    inputs = _inputs(case)
    if case not in refs:
        refs[case] = _reference(case, inputs)
    return inputs, refs[case]


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_reference(case, refs):
    (x, attn, bias, mask, heads), want = _case(case, refs)
    got = model_window_attention(x, *attn, bias, mask, heads,
                                 slots=CASES[case][5])
    assert got.shape == want.shape == x.shape
    check = _check(got, want)
    assert check["ok"], check


def _fault_cases():
    """Each planted fault on the cases where it changes what is computed:
    the k8 step at head_dim 8 and 24, the residue where there is a mask,
    the head everywhere, the ragged keys at L = 49."""
    for case, (window, c, heads, res, *_rest) in CASES.items():
        hd = c // heads
        for fault in FAULTS:
            if fault == "k8_dropped" and hd % 16 == 0:
                continue
            if fault == "mask_of_next_residue" and not res:
                continue
            if fault == "ragged_keys_unmasked" and window * window == MAX_L:
                continue
            yield case, fault


@pytest.mark.parametrize("case,fault", list(_fault_cases()))
def test_planted_fault_fails_the_bar(case, fault, refs):
    (x, attn, bias, mask, heads), want = _case(case, refs)
    bad = model_window_attention(x, *attn, bias, mask, heads,
                                 slots=CASES[case][5], fault=fault)
    assert not _check(bad, want)["ok"]


def test_every_fault_is_planted_somewhere():
    assert {f for _, f in _fault_cases()} == set(FAULTS)


#: HTSAT's four stages at batch 64: (windows, heads, periods)
HTSAT = {"stage0": (4096, 4, 1), "stage0-shifted": (4096, 4, 64),
         "stage1-shifted": (1024, 8, 16), "stage2-shifted": (256, 16, 4),
         "stage3": (64, 32, 1)}


@pytest.mark.parametrize("slots", [1, 7, 100, H100_SLOTS, 10 ** 6])
@pytest.mark.parametrize("shape", list(HTSAT) + ["odd"])
def test_window_lists_cover_each_tile_once(shape, slots):
    """Every (window, head) in exactly one CTA; a CTA's windows share the
    residue and ascend by the period; the head fastest; no more CTAs than
    the slots unless there are more lists than slots (then one a list)."""
    n, heads, periods = HTSAT.get(shape, (30, 3, 5))
    ctas = window_lists(n, heads, periods, slots)
    seen = sorted((w, h) for h, _, ws in ctas for w in ws)
    assert seen == [(w, h) for w in range(n) for h in range(heads)]
    for bx, (h, r, ws) in enumerate(ctas):
        assert h == bx % heads and ws
        assert all(w % periods == r for w in ws)
        assert np.all(np.diff(ws) == periods)
    assert len(ctas) <= max(slots, heads * periods)


@pytest.mark.parametrize("shape", list(HTSAT))
def test_htsat_grids_fill_an_h100(shape):
    """At every stage the grid is one wave of 512 CTAs of the H100's 528
    slots."""
    n, heads, periods = HTSAT[shape]
    ctas = window_lists(n, heads, periods, H100_SLOTS)
    assert len(ctas) == 512
    assert max(len(ws) for _, _, ws in ctas) == n * heads // 512


@pytest.mark.parametrize("hd", [8, 16, 24, 32])
def test_shared_rows_free_of_bank_conflicts(hd):
    """The 8 rows an ldmatrix reads start in 8 distinct 16-byte groups of
    the 128-byte bank line; unpadded rows of 32 or 64 bytes would not."""
    def groups(ld):
        return {(row * ld * 2) % 128 // 16 for row in range(8)}
    assert len(groups(win_ld(hd))) == 8
    assert (win_ld(hd) * 2) % 16 == 0       # 16-byte cp.async rows
    if hd in (16, 32):
        assert len(groups(hd)) < 8


def test_exp_floor_leaves_the_row_sum_unchanged():
    """Terms dropped by the floor are under half an ulp of the row sum (>= 1,
    the max's own term), so the sum of rows with half their logits pushed
    past the floor, as the shift mask's -100 does, is the same bit for bit
    with and without them."""
    rng = np.random.default_rng(3)
    logit = f32(rng.standard_normal((256, 64)) * 3)
    logit[:, rng.random(64) < 0.5] -= 80           # a mask below -64
    d = f32(logit - logit.max(-1, keepdims=True))
    full = np.exp(d).astype(np.float32)
    floor = np.where(d > EXP_FLOOR, full, 0).astype(np.float32)
    assert (floor < full).any() and (full[floor == 0] < 2.0 ** -92).all()
    assert np.array_equal(quad_sum(full), quad_sum(floor))


def test_model_constants_match_the_source():
    src = SOURCE.read_text()
    assert re.search(r"kWinMaxL\s*=\s*64;", src)
    assert re.search(r"kWinExpFloor\s*=\s*-64\.f;", src)
    assert "(HD / 8) % 2 ? HD : HD + 8" in src
    assert "__launch_bounds__(kWinThreads, 4)" in src
    assert "mma_bf16_k8" in src and "__fmul_rn(s[n][e], scale)" in src

"""The fused Swin block (wise_tpu_torch/csrc/swin_kernels.cu: kernel A
``swin_attn_kernel``, kernel B ``swin_mlp_kernel``, behind
``fused_swin_block`` and ``fused_window_attention``), rehearsed on the CPU.

The kernels cannot run here, so this file holds what surrounds them and
numpy models of what they compute:

- the token map (``ops.swin_block.token_map``): at HTSAT's four stage
  resolutions its gather equals the roll by -shift followed by the window
  partition, and its scatter the window reverse followed by the roll back,
  in torch and in the JAX package (``jnp.roll``, its ``window_partition``);
- the model's block path through the map (plain versions) against the JAX
  ``SwinBlock``, shifted and unshifted: in f32 at
  tests/test_swin_torch_parity.py's tolerance (2e-4 abs, 1e-3 rel), in bf16
  (the Pallas kernel in interpret mode) on the block's increment
  (``ops.block.increment_agreement``: per-token cosine >= 0.999, max abs
  error <= 5% of the reference increment's max abs); and it makes no roll,
  partition or reverse;
- kernel A's head slicing: a head's q, k and v come from three weight
  pieces (its columns of Wqkv), the attention runs on that head's 3·hd qkv
  columns, att is assembled head by head and projected in pieces of hd
  columns of Wo; held to ``plain_window_attention`` and to the attention
  half of ``plain_swin_block`` by the increment bar;
- kernel B's chunk loop: acc += bf16(gelu(y2 Wfc_c + bfc_c)) Wproj_c in
  f32, chunk c of the width ``mlp_plan`` gives, a ragged last chunk where F
  is not a multiple of it, held to ``plain_swin_block``'s MLP;
- the routes and counts: two kernels a block up to C 384 (stages 0-2),
  the seven-launch chain at C 768 (stage 3), and the shared-memory byte
  counts that decide it, from the source's constants; the counts as the C
  entries report them (read from the source: which kernels each route
  counts, and that each count sits where its kernel is launched), through
  ``count_launched`` into ``KERNEL_LAUNCHES``.

Planted faults must fail the same bars: a head's k piece taken from the
next head, the last out-proj piece dropped, one F chunk dropped, the map
rolled by one row.
"""

import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.models.clap import model as JM
from wise_tpu.ops import swin_block as JSB
from wise_tpu_torch.models.clap import config as TC
from wise_tpu_torch.models.clap import model as TM
from wise_tpu_torch.models.clap.convert import from_flax_params
from wise_tpu_torch.ops import swin_attention as SA
from wise_tpu_torch.ops import swin_block as SB
from wise_tpu_torch.ops.block import increment_agreement

SOURCE = (Path(__file__).resolve().parents[1] / "wise_tpu_torch" / "csrc"
          / "swin_kernels.cu")
#: HTSAT's stages: (side of the map, C, heads)
HTSAT = {"stage0": (64, 96, 4), "stage1": (32, 192, 8),
         "stage2": (16, 384, 16), "stage3": (8, 768, 32)}
SMEM_MAX = 232448          # dynamic shared memory a block may use (H100)


def mlp_plan(c):
    """Kernel B's tile at C (csrc/swin_kernels.cu ``mlp_plan``; its lines
    are checked in test_constants_match_the_source): (warpgroups a 64-row
    CTA, fc2 columns of warpgroup 0, F columns a chunk)."""
    if c <= 192:
        return 1, c, 64
    return 2, 64 * -(-c // 128), 64


def bf16(x):
    """Round f32 values to bf16 (to nearest, ties to even), kept as f32."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    r = (u + ((u >> 16) & 1) + np.uint32(0x7FFF)) & np.uint32(0xFFFF0000)
    return np.where(np.isnan(x), x, r.view(np.float32))


def f32(x):
    return np.asarray(x, np.float32)


def dot(a, b):
    """A product summed in f64 and rounded to f32: the tensor cores' f32
    sums up to their order."""
    return f32(np.asarray(a, np.float64) @ np.asarray(b, np.float64))


def layer_norm(x, s, b):
    """layernorm_kernel's arithmetic: f32 E[x] and E[x^2], var clamped."""
    mean = x.mean(-1, keepdims=True, dtype=np.float32)
    var = np.maximum((x * x).mean(-1, keepdims=True, dtype=np.float32)
                     - mean * mean, 0)
    return f32((x - mean) * (f32(1.0) / np.sqrt(var + f32(1e-5)) * s) + b)


def gelu(v):
    from scipy.special import erf
    return f32(0.5 * v * (1.0 + erf(v / np.sqrt(2.0))))


# ---------------------------------------------------------------------------
# the token map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("stage", list(HTSAT))
def test_token_map_is_roll_then_partition(stage, shift):
    res = HTSAT[stage][0]
    rng = np.random.default_rng(res + shift)
    x = rng.standard_normal((2, res, res, 3)).astype(np.float32)
    tmap = SB.token_map(res, res, 8, shift)
    assert tmap.dtype == torch.int32 and tmap.shape == (res * res,)
    assert torch.equal(torch.sort(tmap).values,
                       torch.arange(res * res, dtype=torch.int32))
    rows = SB._map_rows(tmap, 2 * res * res, "cpu")
    got = torch.from_numpy(x).reshape(-1, 3)[rows].reshape(-1, 64, 3)
    xt = torch.from_numpy(x)
    want = TM.window_partition(torch.roll(xt, (-shift, -shift), (1, 2)), 8)
    assert torch.equal(got, want)
    want_j = JM.window_partition(
        jnp.roll(jnp.asarray(x), (-shift, -shift), (1, 2)), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_j))

    # the scatter through the same map is the reverse, then the roll back
    win = rng.standard_normal(tuple(want.shape)).astype(np.float32)
    out = torch.empty(2 * res * res, 3)
    out[rows] = torch.from_numpy(win).reshape(-1, 3)
    back = torch.roll(TM.window_reverse(torch.from_numpy(win), 8, res, res),
                      (shift, shift), (1, 2))
    assert torch.equal(out.reshape(back.shape), back)
    back_j = jnp.roll(JM.window_reverse(jnp.asarray(win), 8, res, res),
                      (shift, shift), (1, 2))
    np.testing.assert_array_equal(out.reshape(back.shape).numpy(),
                                  np.asarray(back_j))


def test_block_buffers_build_under_a_device_context():
    """The extractor builds models under ``torch.device(...)``: the token map
    and the bias's gather offsets come from numpy, whatever the context."""
    cfg = dataclasses.replace(TC.CLAPConfig(), dtype="bfloat16")
    with torch.device("meta"):
        blk = TM.SwinBlock(32, 2, 8, 4, (64, 64), 4.0, cfg)
    assert torch.equal(blk.token_map, SB.token_map(64, 64, 8, 4))
    want = TM.WindowAttention(32, 2, 8, torch.bfloat16, False)
    assert torch.equal(blk.attn.relative_position_index,
                       want.relative_position_index)


def test_model_keeps_a_map_only_where_it_permutes():
    """HTSAT's stage 3 (one window over the 8 x 8 map, shift clamped to 0)
    keeps no map: its window layout is its spatial layout."""
    cfg = dataclasses.replace(TC.CLAPConfig(), dtype="bfloat16")
    for res, shift, kept in ((64, 4, True), (64, 0, True), (8, 4, False)):
        blk = TM.SwinBlock(32, 2, 8, shift, (res, res), 4.0, cfg)
        assert (blk.token_map is not None) == kept


# ---------------------------------------------------------------------------
# the model's block path through the map against the JAX SwinBlock
# ---------------------------------------------------------------------------

def _block_pair(res, shift, dtype, seed=5):
    """(JAX output, the port's block-path output, x) of one SwinBlock of
    width 32, 2 heads, window 4 on one parameter tree; x (2, res^2, 32)."""
    x = np.random.default_rng(seed).standard_normal(
        (2, res * res, 32)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jb = JM.SwinBlock(32, 2, 4, shift, (res, res), dtype=jdt)
    params = jb.init(jax.random.PRNGKey(3), jnp.asarray(x))
    with pytest.MonkeyPatch.context() as mp:
        if dtype == torch.bfloat16:   # the Pallas kernel in interpret mode
            mp.setattr(JSB, "supports_fused_swin_block", lambda *a: True)
            mp.setattr(JSB, "fused_swin_block", functools.partial(
                JSB.fused_swin_block, interpret=True))
        want = np.asarray(jb.apply(params, jnp.asarray(x)), np.float32)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cfg = dataclasses.replace(TC.CLAPConfig(), dtype=name,
                              fused_swin_block=True)
    tb = TM.SwinBlock(32, 2, 4, shift, (res, res), 4.0, cfg)
    tb.load_state_dict(from_flax_params(params))
    tb.block_path = True      # f32: the block path's plain version in f32
    with torch.no_grad():
        got = tb(torch.from_numpy(x).to(dtype)).float().numpy()
    return want, got, x


@pytest.mark.parametrize("res,shift", [(8, 0), (8, 2), (12, 2), (4, 2)])
def test_block_path_matches_jax_f32(res, shift):
    want, got, _ = _block_pair(res, shift, torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("res,shift", [(8, 0), (8, 2)])
def test_block_path_matches_the_tpu_kernel_bf16(res, shift):
    want, got, x = _block_pair(res, shift, torch.bfloat16)
    base = torch.from_numpy(x).to(torch.bfloat16).float()
    check = increment_agreement(torch.from_numpy(got),
                                torch.from_numpy(want), base)
    assert check["ok"], check


def test_block_path_makes_no_roll_partition_or_reverse(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a layout copy on the block path")

    cfg = dataclasses.replace(TC.CLAPConfig(), dtype="bfloat16",
                              fused_swin_block=True)
    blk = TM.SwinBlock(32, 2, 4, 2, (8, 8), 4.0, cfg)
    x = torch.randn(2, 64, 32).to(torch.bfloat16)
    with torch.no_grad():
        want = blk(x)
        monkeypatch.setattr(torch, "roll", refuse)
        monkeypatch.setattr(TM, "window_partition", refuse)
        monkeypatch.setattr(TM, "window_reverse", refuse)
        assert torch.equal(blk(x), want)


def test_map_rolled_by_one_row_fails_the_bar():
    rng = np.random.default_rng(9)
    c, heads, res = 32, 2, 8
    x, attn, bias, mask, ln, mlp = _torch_inputs(_inputs(
        rng, 2 * (res // 4) ** 2, 16, c, heads, c * 4, mask_res=res))
    xs = x.reshape(2, res * res, c)
    tmap = SB.token_map(res, res, 4, 2)

    def run(m):
        return SB.fused_swin_block(xs, *ln[:2], *attn, bias, mask, *ln[2:],
                                   *mlp, heads=heads, token_map=m)

    want = run(tmap)
    assert increment_agreement(run(tmap), want, xs)["ok"]
    assert not increment_agreement(run(tmap.roll(1)), want, xs)["ok"]


# ---------------------------------------------------------------------------
# numpy models of the two kernels
# ---------------------------------------------------------------------------

def _inputs(rng, n, l, c, heads, f, mask_res=None):
    """A window batch (n, l, c) ~ N(0, 1) and bf16-valued weights (f32
    arrays): kernels at 1/sqrt(fan_in), the bias table at std 1."""
    def w(*s, std=0.02):
        return bf16(std * rng.standard_normal(s))

    x = bf16(rng.standard_normal((n, l, c)))
    window = int(round(l ** 0.5))
    table = f32(rng.standard_normal(((2 * window - 1) ** 2, heads)))
    idx = TM.relative_position_index(window).reshape(-1)
    bias = np.ascontiguousarray(table[idx].reshape(l, l, heads)
                                .transpose(2, 0, 1))
    mask = (TM.shift_attn_mask(mask_res, mask_res, window, window // 2)
            if mask_res else None)
    attn = (w(c, 3 * c, std=c ** -0.5), w(3 * c), w(c, c, std=c ** -0.5),
            w(c))
    ln = (f32(1 + 0.02 * rng.standard_normal(c)),
          f32(0.02 * rng.standard_normal(c)),
          f32(1 + 0.02 * rng.standard_normal(c)),
          f32(0.02 * rng.standard_normal(c)))
    mlp = (w(c, f, std=c ** -0.5), w(f), w(f, c, std=f ** -0.5), w(c))
    return x, attn, bias, mask, ln, mlp


def _torch_inputs(ins):
    """The wrappers' dtypes: x and weights bf16, LN, bias and mask f32."""
    x, attn, bias, mask, ln, mlp = ins
    bf = torch.bfloat16

    def t(a, dt):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dt)

    return (t(x, bf), tuple(t(a, bf) for a in attn), t(bias, torch.float32),
            t(mask, torch.float32), tuple(t(a, torch.float32) for a in ln),
            tuple(t(a, bf) for a in mlp))


def head_pieces(wqkv, h, hd, fault=None):
    """Kernel A's three weight pieces of head h: its q, k and v columns of
    Wqkv (C x hd each), as ``load_piece`` copies them; with the fault, the
    k piece of the next head."""
    c, heads = wqkv.shape[0], wqkv.shape[0] // hd
    pieces = []
    for part in range(3):
        hp = (h + 1) % heads if fault == "next_head_k" and part == 1 else h
        pieces.append(wqkv[:, part * c + hp * hd:part * c + (hp + 1) * hd])
    return pieces


def model_attention_half(x, attn, bias, mask, heads, ln=None, fault=None):
    """Kernel A: y = bf16(LN1 x) (or x); per head, q, k and v each from its
    own piece, bf16(y piece + b); the window attention on them (the bias +
    mask table pre-summed in f32 and added to the f32 logits, softmax, p in
    bf16, PV in f32), att assembled in bf16; the out-proj in pieces of 32
    columns: bf16(att Wo_j + bo_j); out = bf16(x + that) with ``ln`` (the
    block), else that alone."""
    wqkv, bqkv, wo, bo = attn
    n, l, c = x.shape
    hd = c // heads
    y = bf16(layer_norm(x, *ln)) if ln is not None else x
    att = np.zeros_like(x)
    for h in range(heads):
        q, k, v = (bf16(dot(y, piece) + bqkv[part * c + h * hd:
                                              part * c + (h + 1) * hd])
                   for part, piece in enumerate(head_pieces(wqkv, h, hd,
                                                            fault)))
        logit = f32(dot(q, k.transpose(0, 2, 1)) * f32(1 / np.sqrt(hd)))
        tab = bias[h][None]
        if mask is not None:
            tab = f32(tab + np.tile(mask, (n // len(mask), 1, 1)))
        logit = f32(logit + tab)
        e = np.exp(logit - logit.max(-1, keepdims=True)).astype(np.float32)
        p = bf16(e / e.sum(-1, keepdims=True))
        att[..., h * hd:(h + 1) * hd] = bf16(dot(p, v))
    inc = np.zeros_like(x)
    for c0 in range(0, c, hd):
        if fault == "last_piece_dropped" and c0 + hd == c:
            continue
        inc[..., c0:c0 + hd] = bf16(dot(att, wo[:, c0:c0 + hd])
                                    + bo[c0:c0 + hd])
    return bf16(x + inc) if ln is not None else inc


def model_mlp_half(o, ln2, mlp, chunk, fault=None):
    """Kernel B: y2 = bf16(LN2 o); over F in chunks: acc += h_c Wproj_c in
    f32 with h_c = bf16(gelu(y2 Wfc_c + bfc_c)); out = bf16(o + bf16(acc +
    bproj))."""
    wfc, bfc, wproj, bproj = mlp
    y2 = bf16(layer_norm(o, *ln2))
    acc = np.zeros(o.shape, np.float32)
    f = wfc.shape[1]
    for i, f0 in enumerate(range(0, f, chunk)):
        if fault == "chunk_dropped" and i == 1:
            continue
        f1 = min(f, f0 + chunk)
        h = bf16(gelu(dot(y2, wfc[:, f0:f1]) + bfc[f0:f1]))
        acc = f32(acc + dot(h, wproj[f0:f1]))
    return bf16(o + bf16(acc + bproj))


#: (windows, tokens, C, heads, res of the shift mask or None)
ATTN_CASES = {"stage0-shifted": (16, 64, 96, 4, 32),
              "stage1": (4, 64, 192, 8, None),
              "stage2-shifted": (4, 64, 384, 16, 16),
              "l16-hd8": (4, 16, 32, 4, 8), "l16-hd32": (4, 16, 64, 2, None),
              "c160": (2, 16, 160, 5, None)}


@pytest.mark.parametrize("block", [False, True], ids=["attention", "block"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_half_model_matches_plain(case, block):
    n, l, c, heads, res = ATTN_CASES[case]
    rng = np.random.default_rng(len(case) + 17 * block)
    ins = _inputs(rng, n, l, c, heads, 4 * c, mask_res=res)
    x, attn, bias, mask, ln, mlp = ins
    tx, tattn, tbias, tmask, tln, tmlp = _torch_inputs(ins)
    with torch.no_grad():
        if block:
            zero = tuple(torch.zeros_like(a) for a in tmlp)  # MLP off: o
            want = SB.plain_swin_block(tx, *tln[:2], *tattn, tbias, tmask,
                                       *tln[2:], *zero, heads=heads)
            got = model_attention_half(x, attn, bias, mask, heads, ln[:2])
            base = tx.float()
        else:
            want = SA.plain_window_attention(tx, *tattn, tbias, tmask, heads)
            got = model_attention_half(x, attn, bias, mask, heads)
            base = torch.zeros(())
    check = increment_agreement(torch.from_numpy(got), want, base)
    assert check["ok"], check
    for fault in ("next_head_k", "last_piece_dropped"):
        if fault == "next_head_k" and heads == 1:
            continue
        bad = model_attention_half(x, attn, bias, mask, heads,
                                   ln[:2] if block else None, fault)
        assert not increment_agreement(torch.from_numpy(bad), want,
                                       base)["ok"], fault


#: (C, F): HTSAT's three fused stages, a wide hidden at stage 0's width,
#: and F = 4C + 32, whose last chunk of 64 is ragged
MLP_CASES = [(96, 384), (192, 768), (384, 1536), (96, 3072), (96, 416)]


@pytest.mark.parametrize("c,f", MLP_CASES)
def test_mlp_chunk_loop_matches_plain(c, f):
    _, _, chunk = mlp_plan(c)
    rng = np.random.default_rng(c + f)
    ins = _inputs(rng, 2, 64, c, c // 24 if c % 24 == 0 else 4, f)
    x, attn, bias, _, ln, mlp = ins
    tx, tattn, tbias, _, tln, tmlp = _torch_inputs(ins)
    # the attention half off (Wo = 0, bo = 0): o = x, the block is its MLP
    off = (tattn[0], tattn[1], torch.zeros_like(tattn[2]),
           torch.zeros_like(tattn[3]))
    with torch.no_grad():
        want = SB.plain_swin_block(tx, *tln[:2], *off, tbias, None, *tln[2:],
                                   *tmlp, heads=tbias.shape[0])
    chunks = -(-f // chunk)
    assert (f % chunk != 0) == (f == 416)
    got = model_mlp_half(x, ln[2:], mlp, chunk)
    check = increment_agreement(torch.from_numpy(got), want, tx.float())
    assert check["ok"], check
    assert chunks >= 2
    bad = model_mlp_half(x, ln[2:], mlp, chunk, "chunk_dropped")
    assert not increment_agreement(torch.from_numpy(bad), want,
                                   tx.float())["ok"]


# ---------------------------------------------------------------------------
# kernel B's shared-memory tiles and wgmma descriptors
# ---------------------------------------------------------------------------

BOX = 8192          # a 64 x 64 bf16 box, 128-byte rows
ROW = 128


def swizzle(addr):
    """The 128-byte swizzle on a shared-memory byte address (bits 4-6 ^=
    bits 7-9), as wgmma reads and TMA writes."""
    return addr ^ (((addr >> 7) & 7) << 4)


def swz_off(m, k, rows):
    """``swz_off``: element (m, k) of a K-major tile of ``rows`` rows in
    boxes of 64 columns, its 16-byte piece at piece ^ (m mod 8)."""
    return ((k >> 6) * rows * ROW + m * ROW + ((((k & 63) >> 3) ^ (m & 7))
                                                << 4) + ((k & 7) << 1))


def read_a(smem, start):
    """The 64 x 16 A (K-major, LBO 16, SBO 1024) a descriptor reads."""
    i = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    addr = start + (i % 8) * ROW + (i // 8) * 1024 + (k // 8) * 16 + (k % 8) * 2
    return smem[swizzle(addr) // 2]


def read_w(smem, start, n):
    """The 16 x n B (MN-major, LBO 8192, SBO 1024) a descriptor reads."""
    k = np.arange(16)[:, None]
    j = np.arange(n)[None, :]
    addr = (start + (j % 64) * 2 + (j // 64) * BOX + (k % 8) * ROW
            + (k // 8) * 1024)
    return smem[swizzle(addr) // 2]


def model_mlp_tiles(y2, wfc, wproj, fault=None):
    """Kernel B's products through its tiles, integer operands: y2 (64, C)
    placed by ``swz_off``, each chunk's Wfc (C x 64) and Wproj (64 x C) by
    ``load_wfc`` / ``load_wproj`` (zeros past F), fc1 by k16 descriptors
    over the boxes (each warpgroup's 32 columns at +64 bytes with two), h_c
    through its K-major tile, fc2 by the warpgroups' 64- and 32-column
    pieces; h is fc1's output (no GELU), so the result is y2 Wfc Wproj
    exactly."""
    c, f = wfc.shape
    kb = -(-c // 64)
    wgs, split, chunk = mlp_plan(c)
    ys, wf, wp, hs = 0, kb * BOX, 2 * kb * BOX, 3 * kb * BOX
    smem = np.full((3 * kb + 1) * BOX // 2, np.nan)
    for m in range(64):
        for k in range(c):
            smem[(ys + swz_off(m, k, 64)) // 2] = y2[m, k]
    acc = np.zeros((64, c))
    for f0 in range(0, f, chunk):
        for k in range(c):
            for col in range(64):
                j, e = col // 8, col % 8
                smem[(wf + (k >> 6) * BOX + (k & 63) * ROW
                      + ((j ^ (k & 7)) << 4)) // 2 + e] = (
                    wfc[k, f0 + col] if f0 + col < f else 0.0)
        for r in range(64):
            for col in range(c):
                j, e = col // 8, col % 8
                smem[(wp + (j >> 3) * BOX + r * ROW
                      + (((j & 7) ^ (r & 7)) << 4)) // 2 + e] = (
                    wproj[f0 + r, col] if f0 + r < f else 0.0)
        for wg in range(wgs):
            hn = 64 if wgs == 1 else 32
            h0 = 32 * wg if wgs == 2 else 0
            h = np.zeros((64, hn))
            for ks in range(c // 16):
                a = read_a(smem, ys + (ks >> 2) * 64 * ROW + (ks & 3) * 32)
                b = read_w(smem, wf + (ks >> 2) * BOX + (ks & 3) * 16 * ROW
                           + h0 * 2 + (64 if fault == "half_offset" and wg
                                       else 0), hn)
                h += a @ b
            for m in range(64):
                for col in range(hn):
                    smem[(hs + swz_off(m, h0 + col, 64)) // 2] = h[m, col]
        for wg in range(wgs):
            c0 = wg * split
            width = min(split, c - c0)
            for kk in range(4):
                a = read_a(smem, hs + kk * 32)
                for q in range(-(-width // 64)):
                    n0 = c0 + 64 * q
                    n = min(64, width - 64 * q)
                    start = wp + (n0 >> 6) * BOX + kk * 16 * ROW
                    if fault == "box_stride":
                        start = wp + n0 * 2 + kk * 16 * ROW
                    acc[:, n0:n0 + n] += a @ read_w(smem, start, n)
    return acc


@pytest.mark.parametrize("c,f", [(32, 128), (96, 384), (96, 416),
                                 (160, 640), (192, 768), (224, 896),
                                 (384, 1536)])
def test_mlp_tiles_and_descriptors_give_the_product(c, f):
    """Integer operands: every sum is exact, so the emulated tiles must give
    y2 Wfc Wproj to the last bit at every width kernel B takes, one and two
    warpgroups, a ragged last chunk (F = 416)."""
    rng = np.random.default_rng(c + f)
    y2 = rng.integers(-3, 4, (64, c)).astype(np.float64)
    wfc = rng.integers(-3, 4, (c, f)).astype(np.float64)
    wproj = rng.integers(-3, 4, (f, c)).astype(np.float64)
    assert np.array_equal(model_mlp_tiles(y2, wfc, wproj), y2 @ wfc @ wproj)


@pytest.mark.parametrize("fault", ["half_offset", "box_stride"])
def test_mlp_tile_faults_break_the_product(fault):
    """A second warpgroup's fc1 half read a half too far, and fc2's pieces
    addressed as if the boxes were one row-major tile, must not give it."""
    rng = np.random.default_rng(5)
    c, f = 384, 128
    y2 = rng.integers(-3, 4, (64, c)).astype(np.float64)
    wfc = rng.integers(-3, 4, (c, f)).astype(np.float64)
    wproj = rng.integers(-3, 4, (f, c)).astype(np.float64)
    got = model_mlp_tiles(y2, wfc, wproj, fault)
    assert not np.array_equal(got, y2 @ wfc @ wproj)


# ---------------------------------------------------------------------------
# routes, counts, and the source's constants
# ---------------------------------------------------------------------------

def _const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def odd_ld(n):
    return (n // 8 | 1) * 8


def attn_smem(c, hd, g):
    """Kernel A's shared memory (``attn_smem_bytes``)."""
    kld = hd if (hd // 8) % 2 else hd + 8
    return (2 * (2 * g * 64 * odd_ld(c) + (3 * g * 64 + 3 * c) * kld)
            + 4 * (64 * 72 + 2 * c))


def mlp_smem(c):
    """Kernel B's shared memory (``mlp_smem_bytes``)."""
    boxes = -(-c // 64)
    return 1024 + (3 * boxes + 1) * 8192 + 8 * c


def test_constants_match_the_source():
    src = SOURCE.read_text()
    assert _const("kSwinFusedMaxC") == 384
    assert _const("kSwinRing") == 3
    assert _const("kSmemMax") == SMEM_MAX
    assert _const("kMlpRows") == 64 and _const("kMlpChunk") == 64
    assert _const("kTabLd") == 72
    assert "return ((n / 8) | 1) * 8;" in src
    assert "*wgs = C <= 192 ? 1 : 2;" in src
    assert "*split = C <= 192 ? C : 64 * ((C + 127) / 128);" in src


@pytest.mark.parametrize("c", [32, 64, 96, 128, 160, 192, 224, 288, 352, 384])
def test_mlp_plan_fits_every_width_it_takes(c):
    """Each warpgroup's fc2 columns are at most 192 (96 accumulators a
    thread), start on a 64-column box and are whole 32-column pieces; the
    tile's shared memory fits."""
    wgs, split, chunk = mlp_plan(c)
    widths = [split] if wgs == 1 else [split, c - split]
    assert sum(widths) == c and all(0 < w <= 192 and w % 32 == 0
                                    for w in widths)
    assert split % 64 == 0 or wgs == 1
    assert chunk == 64 and mlp_smem(c) <= SMEM_MAX


def test_stage3_keeps_the_chain_for_its_bytes():
    """The numbers the source and PERF.md give for the route by C."""
    assert attn_smem(384, 24, 1) == 186368 <= SMEM_MAX
    assert attn_smem(768, 24, 1) == 343040 > SMEM_MAX
    assert [mlp_smem(c) for c in (96, 192, 384)] == [59136, 84480, 159744]
    assert 3 * 12 * 8192 == 294912 > SMEM_MAX   # kernel B's tiles at C 768
    assert [HTSAT[s][1] <= _const("kSwinFusedMaxC") for s in HTSAT] == [
        True, True, True, False]


def _kernel_kinds():
    """The ``SwinKernel`` enumerators in order: the indices of the C
    entries' ``launched`` array."""
    body = re.search(r"enum SwinKernel \{([^}]*)\}", SOURCE.read_text())
    assert body
    return [k.strip() for k in body.group(1).split(",") if k.strip()]


def _function(head):
    """The source of the C function that starts with ``head``."""
    src = SOURCE.read_text()
    start = src.index(head)
    return src[start:src.index("\n}\n", start)]


#: the calls that launch and count one kernel themselves (at their <<<>>>)
LAUNCHERS = {"swin_attention(": "kCountSwinAttn",
             "swin_mlp(": "kCountSwinMlp",
             "window_attention(": "kCountWindowAttention"}


def _entry_counts(entry):
    """The kinds C entry ``entry`` counts on its (fused, chain) routes, in
    launch order, read from its source: the launchers' own counts and
    those of its WT_COUNTED calls."""
    body = _function(f"int {entry}(")
    fused, chain = body.split("if (C <= kSwinFusedMaxC) {")[1].split(
        "\n  }\n", 1)
    pattern = (r"WT_COUNTED\(.*?,\s*(kCount\w+)\);|\b("
               + "|".join(re.escape(k[:-1]) for k in LAUNCHERS) + r")\(")
    return [[m.group(1) or LAUNCHERS[m.group(2) + "("]
             for m in re.finditer(pattern, part, re.S)] for part in
            (fused, chain)]


def test_each_launch_is_counted_where_it_is_made():
    """Each kernel the file launches adds one to its own count right after
    its launch succeeds, and the entries launch common.cuh's kernels only
    through WT_COUNTED."""
    kinds = _kernel_kinds()
    assert kinds == ["kCountSwinAttn", "kCountSwinMlp",
                     "kCountWindowAttention", "kCountGemm", "kCountLayerNorm",
                     "kCountKinds"]
    assert len(SA.KERNELS) == len(kinds) - 1
    src = SOURCE.read_text()
    for kernel, kind in (("swin_attn_kernel", "kCountSwinAttn"),
                         ("swin_mlp_kernel", "kCountSwinMlp"),
                         ("window_attention_kernel",
                          "kCountWindowAttention")):
        at = src.index("<<<", src.index(f"{kernel}<", src.index(
            f"cudaError_t launch_{kernel.replace('_kernel', '')}")))
        tail = src[at:src.index("\n}\n", at)]
        assert f"if (err == cudaSuccess) ++launched[{kind}];" in tail, kernel
    assert src.count("<<<") == 3
    for entry in ("wt_swin_block", "wt_window_attention"):
        body = _function(f"int {entry}(")
        assert not re.search(r"WT_CHECK\(\(?(gemm|layernorm)", body), entry


@pytest.mark.parametrize("stage", list(HTSAT))
def test_launch_counts_two_kernels_a_block_or_the_chain(stage):
    """What each C entry counts on the route its C takes, through
    ``count_launched``: two kernels a block and one for the attention up
    to C 384, the chain at C 768."""
    _, c, _ = HTSAT[stage]
    kinds = _kernel_kinds()
    SB.reset_launches()
    for entry in ("wt_swin_block", "wt_window_attention"):
        launched = SA.launched_array()
        for kind in _entry_counts(entry)[c > _const("kSwinFusedMaxC")]:
            launched[kinds.index(kind)] += 1
        SA.count_launched(launched, 64, c, True)
    counts = {k: v for k, v in SA.KERNEL_LAUNCHES.items() if v}
    if stage == "stage3":
        assert counts == {"layernorm_kernel": 2, "gemm_kernel": 6,
                          "window_attention_kernel": 2}
    else:
        assert counts == {"swin_attn_kernel": 2, "swin_mlp_kernel": 1}
    assert SA.KERNEL_LAUNCHES_BY_SHAPE == {
        (k, 64, c, True): v for k, v in counts.items()}
    SA.reset_launches()
    assert not any(SA.KERNEL_LAUNCHES.values())
    assert not SA.KERNEL_LAUNCHES_BY_SHAPE


def test_cpu_wrapper_with_a_map_is_the_plain_gather():
    """On the CPU the wrapper is the plain version with the map, and
    launches nothing."""
    rng = np.random.default_rng(2)
    ins = _inputs(rng, 8, 16, 32, 2, 128, mask_res=8)
    tx, tattn, tbias, tmask, tln, tmlp = _torch_inputs(ins)
    xs = tx.reshape(2, 64, 32)
    tmap = SB.token_map(8, 8, 4, 2)
    SB.reset_launches()
    with torch.no_grad():
        got = SB.fused_swin_block(xs, *tln[:2], *tattn, tbias, tmask,
                                  *tln[2:], *tmlp, heads=2, token_map=tmap)
        rows = SB._map_rows(tmap, 128, "cpu")
        want = SB.plain_swin_block(xs.reshape(-1, 32)[rows].reshape(8, 16, 32),
                                   *tln[:2], *tattn, tbias, tmask, *tln[2:],
                                   *tmlp, heads=2)
    assert torch.equal(got.reshape(-1, 32)[rows].reshape(8, 16, 32), want)
    assert not any(SB.LAUNCHES.values())
    assert not any(SA.KERNEL_LAUNCHES.values())

"""The CUDA kernels (wise_tpu_torch/csrc/*.cu: the pre-LN blocks, the Swin
blocks, the post-LN blocks, the attention middle, the fused scan + top-k,
the padded-head block's GEMMs, the embed fold) against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device and nvcc, carries the ``cuda`` marker
and skips without one. The file imports no JAX, so it also runs on a GPU
machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance (ops.block.increment_agreement): on each block's increment over
its residual input, per-token cosine >= 0.999, the bar the Pallas kernels
are held to (tests/test_block_kernels.py), and max abs error <= 5% of the
plain increment's max abs. The kernel rounds its bf16 operands at the TPU
kernel's points, the plain version at PyTorch's.

The top-k kernels (ops.fused_topk.topk_agreement): on integer-valued vectors
scores and rows identical to the plain version's; on unit-norm random vectors
scores within 2e-6 and rows equal except among entries whose plain scores lie
within 2e-6 of each other (f32 sums in another order than cuBLAS's).
"""

import numpy as np
import pytest
import torch

from wise_tpu_torch.ops import block as K

B, SP, D, HEADS, N_VALID = 8, 24, 128, 2, 20
ROWS = np.array([0, 5, 19, 12, 1, 23, 7, 19], np.int32)
KINDS = ["attn", "mlp", "pooled", "dyn"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


def _inputs(seed, device, stream, mlp=False):
    """Kernels at 1/sqrt(fan_in), as init_random_ draws them, so that each
    block adds about as much as x carries."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape, std=0.02):
        return (std * torch.randn(shape, generator=g)).to(device)

    x = torch.randn((B, SP, D), generator=g).to(device, stream)
    ln = [1.0 + w(D), w(D)]
    f = 4 * D if mlp else D
    first = (D, 4 * D) if mlp else (D, 3 * D)
    ws = (w(*first, std=D ** -0.5), w(first[1]), w(f, D, std=f ** -0.5),
          w(D))
    return x, ln, [t.to(torch.bfloat16) for t in ws]


def _zero_q(w):
    """wqkv and bqkv with the q columns zeroed: every logit 0."""
    wqkv, bqkv = w[0].clone(), w[1].clone()
    wqkv[:, :D] = 0
    bqkv[:D] = 0
    return [wqkv, bqkv, *w[2:]]


def _call(kind, causal, x, ln, w, rows, fused=True, act=None):
    """(output, wrapper name, residual base) of one block op."""
    if kind == "attn":
        fn = K.fused_attn_block if fused else K.plain_attn_block
        return (fn(x, *ln, *w, heads=HEADS, n_valid=N_VALID, causal=causal),
                "fused_attn_block", x)
    if kind == "mlp":
        fn = K.fused_mlp_block if fused else K.plain_mlp_block
        act = act or ("gelu_tanh" if causal else "gelu")
        return fn(x, *ln, *w, act=act), "fused_mlp_block", x
    if kind == "pooled":
        fn = K.fused_attn_block_pooled if fused else K.plain_attn_block_pooled
        return (fn(x, *ln, *w, heads=HEADS, n_valid=N_VALID, pool_row=5,
                   causal=causal), "fused_attn_block_pooled", x[:, 5])
    fn = (K.fused_attn_block_pooled_dyn if fused
          else K.plain_attn_block_pooled_dyn)
    return (fn(x, rows, *ln, *w, heads=HEADS, n_valid=N_VALID, causal=causal),
            "fused_attn_block_pooled_dyn",
            x[torch.arange(B, device=x.device), rows.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(cuda, kind, causal, stream):
    x, ln, w = _inputs(40 + KINDS.index(kind), cuda, stream, kind == "mlp")
    rows = torch.from_numpy(ROWS).to(cuda)
    K.reset_launches()
    got, name, base = _call(kind, causal, x, ln, w, rows)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == 1
    assert K.LAUNCHES_BY_SHAPE == {(name, SP, D): 1}
    want = _call(kind, causal, x, ln, w, rows, fused=False)[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    check = K.increment_agreement(got, want, base)
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_planted_kernel_fault_fails_the_check(cuda, kind):
    """The kernel run with its logits zeroed (uniform attention; for the
    MLP, its activation dropped), or a block that returns its residual
    input, must fail the check the kernels pass."""
    x, ln, w = _inputs(60 + KINDS.index(kind), cuda, torch.bfloat16,
                       kind == "mlp")
    rows = torch.from_numpy(ROWS).to(cuda)
    want, _, base = _call(kind, True, x, ln, w, rows, fused=False)
    if kind == "mlp":
        bad = _call(kind, True, x, ln, w, rows, act="none")[0]
    else:
        bad = _call(kind, True, x, ln, _zero_q(w), rows)[0]
    assert not K.increment_agreement(bad, want, base)["ok"]
    assert not K.increment_agreement(base, want, base)["ok"]


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    x, ln, w = _inputs(50, cuda, torch.float32)
    with pytest.raises(ValueError, match="dtype"):   # f32 weights
        K.fused_attn_block(x, *ln, *[t.float() for t in w], heads=HEADS,
                           n_valid=N_VALID)
    with pytest.raises(ValueError, match="head_dim"):
        K.fused_attn_block(x, *ln, *w, heads=4, n_valid=N_VALID)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_attn_block(x.transpose(0, 1), *ln, *w, heads=HEADS,
                           n_valid=N_VALID)
    with pytest.raises(ValueError, match="n_valid"):
        K.fused_attn_block(x, *ln, *w, heads=HEADS, n_valid=SP + 1)


# ---------------------------------------------------------------------------
# Swin kernels (wise_tpu_torch/csrc/swin_kernels.cu): window attention and the
# whole Swin block, on window batches with the relative-position bias and
# the shift mask, held to their plain versions by the same increment check
# (the window attention's increment is its whole output)
# ---------------------------------------------------------------------------

from wise_tpu_torch.models.clap.model import (  # noqa: E402
    relative_position_index, shift_attn_mask)
from wise_tpu_torch.ops import swin_attention as SA  # noqa: E402
from wise_tpu_torch.ops import swin_block as SB  # noqa: E402

#: (window, C, heads, res, batch): a tiny one (head_dim 16, 16 tokens),
#: HTSAT's stages 0-2 (head_dim 24, 64, 16 and 4 windows an example: the
#: two fused kernels, kernel B's three tiles) and stage 3 (one window, 32
#: heads: the chain), window 7 (49 tokens: ragged key tiles and a warp
#: without rows), and head_dim 8 and 32 (the k8 step alone, two k16 steps)
SWIN_SHAPES = {"tiny": (4, 32, 2, 8, 2), "stage0": (8, 96, 4, 64, 2),
               "stage1": (8, 192, 8, 32, 2), "stage2": (8, 384, 16, 16, 2),
               "stage3": (8, 768, 32, 8, 4), "l49": (7, 96, 4, 14, 2),
               "hd8": (8, 32, 4, 16, 2), "hd32": (8, 128, 4, 16, 2)}


def _swin_inputs(shape, masked, device, seed=70):
    """x ~ N(0, 1) in bf16; kernels at 1/sqrt(fan_in); the relative-bias
    table at std 1, so that dropping it shows."""
    window, c, heads, res, b = SWIN_SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    l, n_win, ff = window * window, (res // window) ** 2, 4 * c

    def w(*s, std=0.02):
        return (std * torch.randn(s, generator=g)).to(device)

    x = torch.randn((b * n_win, l, c), generator=g).to(device, torch.bfloat16)
    table = w((2 * window - 1) ** 2, heads, std=1.0)
    idx = torch.from_numpy(relative_position_index(window).reshape(-1))
    bias = table[idx.to(device)].reshape(l, l, heads).permute(2, 0, 1)
    mask = (torch.from_numpy(shift_attn_mask(res, res, window, window // 2))
            .to(device) if masked else None)
    bf = torch.bfloat16
    attn = [w(c, 3 * c, std=c ** -0.5).to(bf), w(3 * c).to(bf),
            w(c, c, std=c ** -0.5).to(bf), w(c).to(bf)]
    ln = [1.0 + w(c), w(c), 1.0 + w(c), w(c)]
    mlp = [w(c, ff, std=c ** -0.5).to(bf), w(ff).to(bf),
           w(ff, c, std=ff ** -0.5).to(bf), w(c).to(bf)]
    return x, attn, bias.contiguous(), mask, ln, mlp, heads


def _swin_call(block, x, attn, bias, mask, ln, mlp, heads, fused=True):
    if block:
        fn = SB.fused_swin_block if fused else SB.plain_swin_block
        return fn(x, *ln[:2], *attn, bias, mask, *ln[2:], *mlp, heads=heads)
    fn = SA.fused_window_attention if fused else SA.plain_window_attention
    return fn(x, *attn, bias, mask, heads=heads)


#: the kernels one call launches, by (block, C <= 384): two a block (one
#: for the attention) up to C 384, the chain wider
SWIN_CALL_KERNELS = {
    (True, True): {"swin_attn_kernel": 1, "swin_mlp_kernel": 1},
    (False, True): {"swin_attn_kernel": 1},
    (True, False): {"layernorm_kernel": 2, "gemm_kernel": 4,
                    "window_attention_kernel": 1},
    (False, False): {"gemm_kernel": 2, "window_attention_kernel": 1}}


def _swin_kernels_launched():
    return {k: v for k, v in SA.KERNEL_LAUNCHES.items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", [
    ("tiny", False), ("tiny", True), ("stage0", False), ("stage0", True),
    ("stage1", False), ("stage1", True), ("stage2", False), ("stage2", True),
    ("stage3", False),    # stage 3: one window, no shifted block
    ("l49", False), ("l49", True), ("hd8", False), ("hd8", True),
    ("hd32", False), ("hd32", True)])
@pytest.mark.parametrize("block", [False, True], ids=["attention", "block"])
def test_swin_kernel_matches_plain_on_card(cuda, block, shape, masked):
    x, attn, bias, mask, ln, mlp, heads = _swin_inputs(shape, masked, cuda)
    mod, name = (SB, "fused_swin_block") if block else \
        (SA, "fused_window_attention")
    mod.reset_launches()
    got = _swin_call(block, x, attn, bias, mask, ln, mlp, heads)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_BY_SHAPE == {(name, x.shape[1], x.shape[2], masked): 1}
    # the kernels the C entry reports it launched
    fused = x.shape[2] <= 384
    assert _swin_kernels_launched() == SWIN_CALL_KERNELS[block, fused]
    assert SA.swin_route(x.shape[2]) == ("fused" if fused else "chain")
    want = _swin_call(block, x, attn, bias, mask, ln, mlp, heads, False)
    assert got.dtype == want.dtype and got.shape == want.shape
    check = K.increment_agreement(got, want, x if block else torch.zeros(
        (), device=cuda))
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["logits_zeroed", "mask_dropped",
                                   "bias_dropped", "mask_rolled"])
@pytest.mark.parametrize("block", [False, True], ids=["attention", "block"])
def test_swin_planted_fault_fails_the_check(cuda, block, fault):
    x, attn, bias, mask, ln, mlp, heads = _swin_inputs("stage0", True, cuda)
    want = _swin_call(block, x, attn, bias, mask, ln, mlp, heads, False)
    c = x.shape[2]
    if fault == "logits_zeroed":
        wqkv, bqkv = attn[0].clone(), attn[1].clone()
        wqkv[:, :c], bqkv[:c] = 0, 0
        attn, bias, mask = [wqkv, bqkv, *attn[2:]], torch.zeros_like(bias), \
            None
    elif fault == "mask_dropped":
        mask = None
    elif fault == "mask_rolled":  # window w takes the mask of w - 1
        mask = mask.roll(1, 0)
    else:
        bias = torch.zeros_like(bias)
    bad = _swin_call(block, x, attn, bias, mask, ln, mlp, heads)
    base = x if block else torch.zeros((), device=cuda)
    assert not K.increment_agreement(bad, want, base)["ok"]


def _spatial(x, mask, res, window, masked):
    """x (N, L, C) as spatial rows (B, res^2, C), and the block's map."""
    b = x.shape[0] * x.shape[1] // (res * res)
    tmap = SB.token_map(res, res, window, window // 2 if masked else 0)
    return x.reshape(b, res * res, x.shape[2]), tmap.to(x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", [
    ("tiny", True), ("stage0", False), ("stage0", True), ("stage1", True),
    ("stage2", False), ("stage2", True), ("l49", True)])
def test_swin_block_token_map_matches_window_layout(cuda, shape, masked):
    """The map's entry (spatial rows in and out) against the window-layout
    entry on the gathered rows, scattered back: the same kernels on the
    same rows, so the same bits; and against the plain version through the
    map. Planted: the map rolled by one row, one F chunk of kernel B
    dropped (Wproj's rows of the second chunk zeroed)."""
    window, _, _, res, _ = SWIN_SHAPES[shape]
    x, attn, bias, mask, ln, mlp, heads = _swin_inputs(shape, masked, cuda)
    xs, tmap = _spatial(x, mask, res, window, masked)
    c = xs.shape[2]
    SB.reset_launches()
    got = SB.fused_swin_block(xs, *ln[:2], *attn, bias, mask, *ln[2:], *mlp,
                              heads=heads, token_map=tmap)
    torch.cuda.synchronize()
    assert _swin_kernels_launched() == SWIN_CALL_KERNELS[True, True]
    rows = SB._map_rows(tmap, xs.numel() // c, cuda)
    xw = xs.reshape(-1, c)[rows].reshape(x.shape)
    win = SB.fused_swin_block(xw, *ln[:2], *attn, bias, mask, *ln[2:], *mlp,
                              heads=heads)
    assert torch.equal(got.reshape(-1, c)[rows].reshape(x.shape), win)
    want = SB.plain_swin_block(xs, *ln[:2], *attn, bias, mask, *ln[2:], *mlp,
                               heads=heads, token_map=tmap)
    check = K.increment_agreement(got, want, xs)
    assert check["ok"], check
    bad = SB.fused_swin_block(xs, *ln[:2], *attn, bias, mask, *ln[2:], *mlp,
                              heads=heads, token_map=tmap.roll(1))
    assert not K.increment_agreement(bad, want, xs)["ok"]
    chunk = 64      # kernel B's F columns a chunk (kMlpChunk)
    wproj = mlp[2].clone()
    wproj[chunk:2 * chunk] = 0
    bad = SB.fused_swin_block(xs, *ln[:2], *attn, bias, mask, *ln[2:],
                              *mlp[:2], wproj, mlp[3], heads=heads,
                              token_map=tmap)
    assert not K.increment_agreement(bad, want, xs)["ok"]


@pytest.mark.cuda
def test_swin_wrappers_reject_what_they_do_not_take(cuda):
    x, attn, bias, mask, ln, mlp, heads = _swin_inputs("stage0", True, cuda)
    with pytest.raises(ValueError, match="dtype"):
        SA.fused_window_attention(x.float(), *attn, bias, mask, heads=heads)
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        SA.fused_window_attention(x, *attn, bias[:2], mask, heads=2)
    with pytest.raises(ValueError, match="multiple of the mask"):
        SB.fused_swin_block(x[:-1].contiguous(), *ln[:2], *attn, bias, mask,
                            *ln[2:], *mlp, heads=heads)
    wfc, bfc, wproj = (mlp[0][:, :100].contiguous(), mlp[1][:100].contiguous(),
                       mlp[2][:100].contiguous())
    with pytest.raises(ValueError, match="hidden width"):
        SB.fused_swin_block(x, *ln[:2], *attn, bias, mask, *ln[2:], wfc, bfc,
                            wproj, mlp[3], heads=heads)
    # C 768 runs the chain, on window layout only
    x, attn, bias, _, ln, mlp, heads = _swin_inputs("stage3", False, cuda)
    tmap = SB.token_map(8, 8, 8, 0).to(cuda)
    with pytest.raises(ValueError, match="takes no token_map"):
        SB.fused_swin_block(x, *ln[:2], *attn, bias, None, *ln[2:], *mlp,
                            heads=heads, token_map=tmap)


@pytest.mark.cuda
@pytest.mark.parametrize("swin_block", [True, False])
def test_swin_model_raises_outside_the_kernels_shapes(cuda, swin_block):
    """A CLAP block whose windows the kernels do not take (window 12: 144
    tokens) reaches the wrapper on the card and raises: no plain fallback.
    With autograd on and trainable parameters the wrapper refuses first: the
    Swin kernels have no training rule."""
    import dataclasses

    from wise_tpu_torch.models.clap import config as TC
    from wise_tpu_torch.models.clap import model as TM

    cfg = dataclasses.replace(TC.CLAPConfig(), dtype="bfloat16",
                              fused_block=True, fused_swin_block=swin_block)
    blk = TM.SwinBlock(32, 2, 12, 6, (24, 24), 4.0, cfg).to(cuda)
    x = torch.randn(2, 24 * 24, 32, device=cuda)
    with torch.no_grad(), pytest.raises(
            ValueError, match="outside the kernel's shapes"):
        blk(x)
    with pytest.raises(RuntimeError, match="cut from the autograd graph"):
        blk(x)


# ---------------------------------------------------------------------------
# The wide shapes (ViT-H/14's traits): head_dim 80, sequences over one
# 64-row query tile up to the 640-key limit (SigLIP-384's 576 tokens,
# ViT-L/14's 577 at 336 px), and the split MLP pair
# ---------------------------------------------------------------------------

#: (B, SP, n_valid, D, heads)
WIDE_SHAPES = {
    "vit_h": (3, 257, 257, 320, 4),      # head_dim 80, 257 tokens
    "masked": (2, 257, 250, 160, 2),     # keys masked inside the last tile
    "longest": (2, 640, 640, 160, 2),    # ten key tiles: MAX_SEQ
    "siglip": (2, 576, 576, 128, 2),     # SigLIP-384: 24 x 24 patches
    "vit_l336": (2, 577, 577, 128, 2),   # a one-row last query tile
    "tile+1": (2, 65, 65, 128, 2),       # one row into a second query tile
    "vit_b16": (2, 197, 197, 128, 2),    # head_dim 64 over 128 tokens
    "one": (2, 1, 1, 160, 2),
    "vit_g": (3, 257, 257, 352, 4),      # head_dim 88 (ViT-g-14)
    "vit_bigg": (3, 257, 250, 416, 4),   # head_dim 104 (ViT-bigG-14)
    "longest_88": (2, 640, 640, 352, 4),
    "tile+1_104": (2, 65, 65, 416, 4),
}


def _wide_inputs(shape, seed, device, stream, mlp=False):
    """x ~ N(0, 1), or N(0, 0.25²) past 272 tokens: the LayerNorm makes a
    block's increment independent of x's scale, and over ~600 keys the
    attention averages so many of them that at unit x the increment's max
    is ~1/10 of x's; 5% of it then falls under one bf16 ulp of a bf16
    stream's output at |x| >= 4, where the kernel and the plain version,
    which round the residual sum at other points, part by that ulp."""
    b, sp, _, d, _ = WIDE_SHAPES[shape]
    g = torch.Generator().manual_seed(seed)

    def w(*s, std=0.02):
        return (std * torch.randn(s, generator=g)).to(device)

    x_std = 0.25 if sp > 272 else 1.0
    x = (x_std * torch.randn((b, sp, d), generator=g)).to(device, stream)
    ln = [1.0 + w(d), w(d)]
    f = 4 * d if mlp else d
    first = (d, 4 * d) if mlp else (d, 3 * d)
    ws = (w(*first, std=d ** -0.5), w(first[1]), w(f, d, std=f ** -0.5),
          w(d))
    return x, ln, [t.to(torch.bfloat16) for t in ws]


def _wide_call(shape, kind, causal, x, ln, w, fused=True):
    """(output, wrapper name, residual base) at a wide shape; the pooled
    kinds take the last valid row (static) or rows spread over the
    sequence (dyn)."""
    b, sp, n_valid, _, heads = WIDE_SHAPES[shape]
    kw = dict(heads=heads, n_valid=n_valid, causal=causal)
    if kind == "attn":
        fn = K.fused_attn_block if fused else K.plain_attn_block
        return fn(x, *ln, *w, **kw), "fused_attn_block", x
    if kind == "pooled":
        fn = K.fused_attn_block_pooled if fused else K.plain_attn_block_pooled
        return (fn(x, *ln, *w, pool_row=n_valid - 1, **kw),
                "fused_attn_block_pooled", x[:, n_valid - 1])
    rows = torch.tensor([(7 * i * sp) // (3 * b) % sp for i in range(b)],
                        dtype=torch.int32, device=x.device)
    fn = (K.fused_attn_block_pooled_dyn if fused
          else K.plain_attn_block_pooled_dyn)
    return (fn(x, rows, *ln, *w, **kw), "fused_attn_block_pooled_dyn",
            x[torch.arange(b, device=x.device), rows.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["attn", "pooled", "dyn"])
@pytest.mark.parametrize("shape", list(WIDE_SHAPES))
def test_wide_attention_matches_plain_on_card(cuda, shape, kind, causal,
                                              stream):
    x, ln, w = _wide_inputs(shape, 90, cuda, stream)
    K.reset_launches()
    got, name, base = _wide_call(shape, kind, causal, x, ln, w)
    torch.cuda.synchronize()
    assert K.LAUNCHES_BY_SHAPE == {(name, x.shape[1], x.shape[2]): 1}
    want = _wide_call(shape, kind, causal, x, ln, w, fused=False)[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    check = K.increment_agreement(got, want, base)
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["static", "causal_rows"])
@pytest.mark.parametrize("sp", [1, 50, 77, 257, 577, 640])
@pytest.mark.parametrize("hd", [64, 80, 88, 104])
def test_pooled_attention_alone_matches_plain_on_card(cuda, hd, sp, mode):
    """attention_pooled_kernel alone (ops.block.pooled_attention) at every
    head group of 16 heads and at the kernel's own choice, on the whole
    output (ops.block.output_agreement): a static row with n_valid < SP,
    or per-example causal rows at 0, the middle, SP - 1 and past both ends
    (clamped)."""
    heads, b = 16, 6
    d = heads * hd
    g = torch.Generator().manual_seed(hd + sp)
    q = torch.randn((b, d), generator=g).to(cuda, torch.bfloat16)
    kv = torch.randn((b, sp, 2 * d), generator=g).to(cuda, torch.bfloat16)
    if mode == "static":
        rows, row, causal, n_valid = None, sp - 1, False, max(1, sp - 7)
    else:
        rows = torch.tensor([0, sp // 2, sp - 1, sp + 5, -3, sp // 3],
                            dtype=torch.int32, device=cuda)
        row, causal, n_valid = 0, True, sp
    want = K.plain_pooled_attention(q, kv, heads, n_valid, rows, row, causal)
    for group in (0, 1, 2, 4, 8, 16):
        K.reset_launches()
        got = K.pooled_attention(q, kv, heads, n_valid, rows, row, causal,
                                 group)
        torch.cuda.synchronize()
        assert K.LAUNCHES_BY_SHAPE == {("pooled_attention", sp, d): 1}
        check = K.output_agreement(got, want)
        assert check["ok"], (group, check)


@pytest.mark.cuda
def test_pooled_attention_refuses_what_it_does_not_take(cuda):
    """A head group that is not a power of two dividing the heads, n_valid
    outside [1, SP], a static row outside [0, SP): refused, nothing
    launched."""
    q = torch.zeros((2, 1024), device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros((2, 50, 2048), device=cuda, dtype=torch.bfloat16)
    K.reset_launches()
    for kw in (dict(group=3), dict(group=32), dict(n_valid=0),
               dict(n_valid=51), dict(pool_row=50)):
        args = dict(heads=16, n_valid=50)
        args.update(kw)
        with pytest.raises((RuntimeError, ValueError)):
            K.pooled_attention(q, kv, **args)
    assert not any(K.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "quick_gelu", "gelu_tanh"])
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["vit_h", "tile+1"])
def test_mlp_split_matches_plain_on_card(cuda, shape, stream, act):
    """The pair, and each half on its own: h is bf16 in device memory."""
    x, ln, w = _wide_inputs(shape, 91, cuda, stream, mlp=True)
    sp, d = x.shape[1:]
    K.reset_launches()
    got = K.fused_mlp_split(x, *ln, *w, act=act)
    torch.cuda.synchronize()
    assert K.LAUNCHES_BY_SHAPE == {("fused_mlp_fc", sp, d): 1,
                                   ("fused_mlp_proj", sp, d): 1}
    want = K.plain_mlp_split(x, *ln, *w, act=act)
    assert got.dtype == want.dtype == stream and got.shape == want.shape
    check = K.increment_agreement(got, want, x)
    assert check["ok"], check

    h = K.fused_mlp_fc(x, *ln, *w[:2], act=act)
    want_h = K.plain_mlp_fc(x, *ln, *w[:2], act=act)
    assert h.dtype == torch.bfloat16 and h.shape == (*x.shape[:2], 4 * d)
    check = K.increment_agreement(h, want_h, torch.zeros((), device=cuda))
    assert check["ok"], check
    out = K.fused_mlp_proj(want_h, *w[2:], x)
    check = K.increment_agreement(out, want, x)
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["scale_of_hd64", "tile_dropped",
                                   "h_not_activated"])
def test_wide_planted_fault_fails_the_check(cuda, fault):
    if fault == "h_not_activated":
        x, ln, w = _wide_inputs("vit_h", 92, cuda, torch.float32, mlp=True)
        want = K.plain_mlp_split(x, *ln, *w, act="gelu")
        bad = K.fused_mlp_split(x, *ln, *w, act="none")
    else:
        x, ln, w = _wide_inputs("vit_h", 92, cuda, torch.float32)
        d, heads = x.shape[2], WIDE_SHAPES["vit_h"][4]
        w[0][:, :d] *= 3.0   # a sharper softmax: the scale matters more
        want = _wide_call("vit_h", "attn", False, x, ln, w, fused=False)[0]
        if fault == "tile_dropped":
            bad = _wide_call("vit_h", "attn", False, x, ln, w)[0].clone()
            bad[:, 64:128] = x[:, 64:128]
        else:
            s = 0.125 * (d // heads) ** 0.5
            wq, bq = w[0].clone(), w[1].clone()
            wq[:, :d] *= s
            bq[:d] *= s
            bad = _wide_call("vit_h", "attn", False, x, ln,
                             [wq, bq, *w[2:]])[0]
    assert not K.increment_agreement(bad, want, x)["ok"]


@pytest.mark.cuda
def test_wide_wrappers_reject_what_they_do_not_take(cuda):
    g = torch.Generator().manual_seed(93)

    def attn_args(sp, d):
        x = torch.randn((1, sp, d), generator=g).to(cuda)
        bf = dict(dtype=torch.bfloat16, device=cuda)
        return (x, torch.ones(d, device=cuda), torch.zeros(d, device=cuda),
                torch.zeros((d, 3 * d), **bf), torch.zeros(3 * d, **bf),
                torch.zeros((d, d), **bf), torch.zeros(d, **bf))

    with pytest.raises(ValueError, match="head_dim"):   # head_dim 72
        K.fused_attn_block(*attn_args(16, 288), heads=4, n_valid=16)
    over = K.MAX_SEQ + 1
    with pytest.raises(ValueError, match="sequence"):   # past the gate
        K.fused_attn_block(*attn_args(over, 160), heads=2, n_valid=over)
    with pytest.raises(ValueError, match="sequence"):
        K.fused_attn_block_pooled(*attn_args(over, 160), heads=2,
                                  n_valid=over)
    x, ln, w = _wide_inputs("tile+1", 94, cuda, torch.float32, mlp=True)
    h = K.fused_mlp_fc(x, *ln, *w[:2])
    with pytest.raises(ValueError, match="dtype"):      # h must be bf16
        K.fused_mlp_proj(h.float(), *w[2:], x)
    with pytest.raises(ValueError, match="shape"):
        K.fused_mlp_proj(h[:, :-1].contiguous(), *w[2:], x)
    with pytest.raises(ValueError, match="activation"):
        K.fused_mlp_fc(x, *ln, *w[:2], act="relu")


@pytest.mark.cuda
@pytest.mark.parametrize("width,heads,seq,match", [
    (288, 4, 16, "head_dim"),     # head_dim 72
    (128, 2, K.MAX_SEQ + 1, "sequence"),    # one key past the gate
])
def test_clip_model_raises_outside_the_kernels_shapes(cuda, width, heads, seq,
                                                      match):
    """A CLIP block of a shape the kernels do not take reaches the wrapper
    on the card and raises, whole and pooled: no plain fallback."""
    from wise_tpu_torch.models.clip import model as TM

    blk = TM.ResidualAttentionBlock(width, heads, "gelu", torch.bfloat16,
                                    fused_block=True).to(cuda)
    x = torch.randn(2, seq, width, device=cuda)
    K.reset_launches()
    with pytest.raises(ValueError, match=match):
        blk(x, n_valid=seq)
    with pytest.raises(ValueError, match=match):
        blk.pooled(x, n_valid=seq, pool_row=0)
    rows = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=match):
        blk.pooled(x, n_valid=seq, rows=rows)
    assert not any(K.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The post-LN blocks (wise_tpu_torch/csrc/postln_kernels.cu) and the
# attention middle (wt_short_attention in block_kernels.cu). Their outputs
# have no residual stream under them (a LayerNorm's output; the attention
# alone), so they are held on the whole output (ops.block.output_agreement:
# per-token cosine >= 0.999, max abs error <= 4 bf16 ulps of the plain
# output's max abs)
# ---------------------------------------------------------------------------

from wise_tpu_torch.ops import attention as A  # noqa: E402
from wise_tpu_torch.ops import postln_block as P  # noqa: E402

#: (B, SP, D, heads): head_dim 64, head_dim 80, XLM-R's 64 tokens, one
#: token over a query tile
POSTLN_SHAPES = {"tiny": (4, 16, 128, 2), "hd80": (3, 24, 160, 2),
                 "xlmr": (2, 64, 256, 4), "tile+1": (2, 65, 128, 2)}


def _postln_inputs(shape, seed, device, mlp=False):
    """x bf16 ~ N(0, 1); kernels at 1/sqrt(fan_in); the closing LayerNorm's
    scale 1 + N(0, 0.25) and bias N(0, 0.25); km keeps a different number
    of tokens (at least one) of each example."""
    b, sp, d, _ = POSTLN_SHAPES[shape]
    g = torch.Generator().manual_seed(seed)

    def w(*s, std=0.02):
        return (std * torch.randn(s, generator=g)).to(device)

    bf = torch.bfloat16
    x = torch.randn((b, sp, d), generator=g).to(device, bf)
    ln = [1.0 + w(d, std=0.25), w(d, std=0.25)]
    f = 4 * d if mlp else d
    first = (d, 4 * d) if mlp else (d, 3 * d)
    ws = [t.to(bf) for t in (w(*first, std=d ** -0.5), w(first[1]),
                             w(f, d, std=f ** -0.5), w(d))]
    kept = torch.tensor([1 + (5 * i + sp - 1) % sp for i in range(b)])
    km = torch.zeros(b, 1, sp).masked_fill(
        torch.arange(sp)[None, None, :] >= kept[:, None, None],
        float("-inf")).to(device)
    return x, km, ln, ws


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(POSTLN_SHAPES))
def test_postln_attention_block_matches_plain_on_card(cuda, shape):
    x, km, ln, w = _postln_inputs(shape, 100, cuda)
    heads = POSTLN_SHAPES[shape][3]
    P.reset_launches()
    got = P.fused_postln_attn_block(x, km, *ln, *w, heads)
    torch.cuda.synchronize()
    assert P.LAUNCHES_BY_SHAPE == {
        ("fused_postln_attn_block", x.shape[1], x.shape[2]): 1}
    want = P.plain_postln_attn_block(x, km, *ln, *w, heads)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    check = K.output_agreement(got, want)
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "split"])
@pytest.mark.parametrize("shape", list(POSTLN_SHAPES))
def test_postln_mlp_block_matches_plain_on_card(cuda, shape, variant):
    """Both variants, and for the pair each half on its own."""
    x, _, ln, w = _postln_inputs(shape, 101, cuda, mlp=True)
    sp, d = x.shape[1:]
    P.reset_launches()
    got = P.fused_postln_mlp_block(x, *ln, *w, "gelu", variant=variant)
    torch.cuda.synchronize()
    assert P.LAUNCHES_BY_SHAPE == (
        {("fused_postln_mlp_block", sp, d): 1} if variant == "single" else
        {("fused_postln_fc", sp, d): 1, ("fused_postln_proj", sp, d): 1})
    want = P.plain_postln_mlp_block(x, *ln, *w, "gelu")
    assert got.dtype == want.dtype and got.shape == want.shape
    check = K.output_agreement(got, want)
    assert check["ok"], check
    if variant == "split":
        h = P.fused_postln_fc(x, *w[:2], "gelu")
        want_h = P.plain_postln_fc(x, *w[:2], "gelu")
        assert h.dtype == torch.bfloat16 and h.shape == (*x.shape[:2], 4 * d)
        check = K.output_agreement(h, want_h)
        assert check["ok"], check
        out = P.fused_postln_proj(want_h, *w[2:], x, *ln)
        check = K.output_agreement(out, want)
        assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["sum_rounded_bf16", "mask_dropped",
                                   "half_scale", "ln_identity"])
def test_postln_planted_fault_fails_the_check(cuda, fault):
    """The faults a post-LN kernel could have must fail the check the
    kernels pass. The bf16-sum fault is planted on inputs whose out-proj
    bias carries a common offset of 200, which the LayerNorm takes out: an
    f32 sum keeps the signal under it (the kernel passes), a bf16 sum
    does not."""
    x, km, ln, w = _postln_inputs("xlmr", 102, cuda)
    d, heads = x.shape[2], POSTLN_SHAPES["xlmr"][3]
    if fault == "sum_rounded_bf16":
        w[3] = (w[3].float() + 200.0).to(torch.bfloat16)
        want = P.plain_postln_attn_block(x, km, *ln, *w, heads)
        good = P.fused_postln_attn_block(x, km, *ln, *w, heads)
        assert K.output_agreement(good, want)["ok"]
        att = P.plain_postln_attention(x, km, *w[:2], heads)
        res = x.float() + (att @ w[2]).float() + w[3].float()
        bad = K.layer_norm_f32(res.to(torch.bfloat16), *ln).to(torch.bfloat16)
    else:
        want = P.plain_postln_attn_block(x, km, *ln, *w, heads)
        if fault == "mask_dropped":
            km = torch.zeros_like(km)
        elif fault == "half_scale":
            w[0][:, :d] *= 0.5
            w[1][:d] *= 0.5
        else:
            ln = [torch.ones_like(ln[0]), torch.zeros_like(ln[1])]
        bad = P.fused_postln_attn_block(x, km, *ln, *w, heads)
    assert not K.output_agreement(bad, want)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["xlmr", "tile+1"])
def test_postln_attention_with_an_example_masked_whole_on_card(cuda, shape):
    """km drops every key of example 0, and all keys of example 1 but its
    last (at 65 tokens the first key tile is masked whole, and the rows find
    their one key in the second): NaN where the plain version is NaN (all of
    example 0), agreement elsewhere."""
    x, km, ln, w = _postln_inputs(shape, 105, cuda)
    sp, heads = x.shape[1], POSTLN_SHAPES[shape][3]
    km[0] = float("-inf")
    km[1, :, :sp - 1] = float("-inf")
    km[1, :, sp - 1] = 0
    got = P.fused_postln_attn_block(x, km, *ln, *w, heads)
    want = P.plain_postln_attn_block(x, km, *ln, *w, heads)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert nan[0].all() and not nan[1:].any()
    assert torch.equal(torch.isnan(got), nan)
    check = K.output_agreement(got[1:], want[1:])
    assert check["ok"], check


@pytest.mark.cuda
def test_postln_wrappers_reject_what_they_do_not_take(cuda):
    x, km, ln, w = _postln_inputs("tiny", 103, cuda)
    heads = POSTLN_SHAPES["tiny"][3]
    P.reset_launches()
    with pytest.raises(ValueError, match="dtype"):       # an f32 stream
        P.fused_postln_attn_block(x.float(), km, *ln, *w, heads)
    with pytest.raises(ValueError, match="head_dim"):    # head_dim 32
        P.fused_postln_attn_block(x, km, *ln, *w, 4)
    with pytest.raises(ValueError, match="km"):          # (B, SP), not (B, 1, SP)
        P.fused_postln_attn_block(x, km[:, 0], *ln, *w, heads)
    with pytest.raises(ValueError, match="contiguous"):
        P.fused_postln_attn_block(x.transpose(0, 1), km, *ln, *w, heads)
    over = K.MAX_SEQ + 1
    long = torch.zeros(1, over, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="sequence"):
        P.fused_postln_attn_block(long, torch.zeros(1, 1, over, device=cuda),
                                  *ln, *w, heads)
    x, _, ln, w = _postln_inputs("tiny", 104, cuda, mlp=True)
    with pytest.raises(ValueError, match="variant"):
        P.fused_postln_mlp_block(x, *ln, *w, variant="both")
    with pytest.raises(ValueError, match="activation"):
        P.fused_postln_fc(x, *w[:2], "relu")
    with pytest.raises(ValueError, match="dtype"):       # f32 weights
        P.fused_postln_mlp_block(x, *ln, *[t.float() for t in w],
                                 variant="single")
    h = P.plain_postln_fc(x, *w[:2])
    with pytest.raises(ValueError, match="dtype"):       # h must be bf16
        P.fused_postln_proj(h.float(), *w[2:], x, *ln)
    with pytest.raises(ValueError, match="shape"):
        P.fused_postln_proj(h[:, :-1].contiguous(), *w[2:], x, *ln)
    assert not any(P.LAUNCHES.values())


#: (B, SP, D, heads, n_valid, causal, scale)
SHORT_CASES = {
    "n_valid": (8, 16, 128, 2, 13, False, None),
    "causal": (8, 16, 128, 2, 16, True, None),
    "head_dim_80": (3, 24, 160, 2, 24, False, None),
    "scale": (8, 16, 128, 2, 16, False, 0.2),
    "vit_b32": (4, 50, 768, 12, 50, False, None),
    "text": (2, 77, 512, 8, 77, True, None),
    "vit_h": (2, 257, 320, 4, 257, False, None),
    "longest": (2, 640, 160, 2, 638, True, None),
    "siglip": (2, 576, 128, 2, 576, False, None),
    "vit_l336": (2, 577, 128, 2, 577, False, None),
    "one": (2, 1, 128, 2, 1, False, None),
    # head_dim 128: the padded-head block's slots, at head_dim 80's scale
    "head_dim_128": (3, 257, 256, 2, 250, True, 80 ** -0.5),
    "longest_128": (2, 640, 256, 2, 640, False, None),
    # the key loop's edges: a 2-key last tile, causal tiles skipped with
    # n_valid < SP, a last tile of 250 - 192 keys at head_dim 80
    "ragged_tile": (2, 130, 128, 2, 130, False, None),
    "causal_257": (2, 257, 128, 2, 250, True, None),
    "head_dim_80_n_valid": (2, 257, 160, 2, 250, False, None),
    # head dims 88 and 104 (ViT-g-14, ViT-bigG-14): the pad to 96 / 112
    "vit_g": (2, 257, 352, 4, 257, False, None),
    "vit_bigg_causal": (2, 257, 416, 4, 250, True, None),
    "head_dim_88_ragged": (2, 130, 176, 2, 130, False, None),
    "head_dim_104_one": (2, 1, 208, 2, 1, False, None),
}


def _short_qkv(case, device, packed):
    b, sp, d = SHORT_CASES[case][:3]
    g = torch.Generator().manual_seed(110)
    qkv = torch.randn((b, sp, 3 * d), generator=g).to(device, torch.bfloat16)
    views = qkv.split(d, dim=-1)
    return views if packed else [v.contiguous() for v in views]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
@pytest.mark.parametrize("case", list(SHORT_CASES))
def test_short_attention_matches_plain_on_card(cuda, case, packed):
    """q, k and v as the column ranges of a packed in-projection (row stride
    3D) and as three tensors of their own (row stride D)."""
    _, sp, d, heads, n_valid, causal, scale = SHORT_CASES[case]
    q, k, v = _short_qkv(case, cuda, packed)
    A.reset_launches()
    got = A.fused_short_attention(q, k, v, heads, n_valid, causal, scale)
    torch.cuda.synchronize()
    assert A.LAUNCHES_BY_SHAPE == {("fused_short_attention", sp, d): 1}
    want = A.plain_short_attention(q, k, v, heads, n_valid, causal, scale)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape and got.is_contiguous()
    check = K.output_agreement(got, want)
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["half_scale", "mask_dropped",
                                   "causal_dropped"])
def test_short_attention_planted_fault_fails_the_check(cuda, fault):
    _, sp, d, heads, _, _, _ = SHORT_CASES["text"]
    q, k, v = _short_qkv("text", cuda, packed=True)
    want = A.plain_short_attention(q, k, v, heads, sp - 7, True)
    assert K.output_agreement(
        A.fused_short_attention(q, k, v, heads, sp - 7, True), want)["ok"]
    bad = A.fused_short_attention(
        q, k, v, heads, sp if fault == "mask_dropped" else sp - 7,
        fault != "causal_dropped",
        0.5 / (d // heads) ** 0.5 if fault == "half_scale" else None)
    assert not K.output_agreement(bad, want)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [88, 104])
@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_short_attention_last_head_columns_dropped_fail(cuda, hd, operand):
    """The last 8 columns of every head zeroed in q, k or v (what a kernel
    that computed hd // 16 steps alone would see) fails the check the
    kernel passes at head dims 88 and 104."""
    heads, sp = 4, 257
    d = heads * hd
    g = torch.Generator().manual_seed(hd)
    q, k, v = [torch.randn((2, sp, d), generator=g).to(cuda, torch.bfloat16)
               for _ in range(3)]
    want = A.plain_short_attention(q, k, v, heads, sp)
    assert K.output_agreement(
        A.fused_short_attention(q, k, v, heads, sp), want)["ok"]
    cut = dict(q=q, k=k, v=v)
    t = cut[operand].clone().view(2, sp, heads, hd)
    t[..., hd - 8:] = 0
    cut[operand] = t.view(2, sp, d)
    bad = A.fused_short_attention(cut["q"], cut["k"], cut["v"], heads, sp)
    assert not K.output_agreement(bad, want)["ok"]


@pytest.mark.cuda
def test_short_attention_rejects_what_it_does_not_take(cuda):
    def qkv(b, sp, d, dtype=torch.bfloat16):
        return [torch.zeros(b, sp, d, dtype=dtype, device=cuda)
                for _ in range(3)]

    A.reset_launches()
    with pytest.raises(ValueError, match="head_dim"):    # head_dim 72
        A.fused_short_attention(*qkv(1, 16, 288), 4, 16)
    over = K.MAX_SEQ + 1
    with pytest.raises(ValueError, match="sequence"):    # past the gate
        A.fused_short_attention(*qkv(1, over, 128), 2, over)
    with pytest.raises(ValueError, match="bfloat16"):
        A.fused_short_attention(*qkv(1, 16, 128, torch.float32), 2, 16)
    with pytest.raises(ValueError, match="n_valid"):
        A.fused_short_attention(*qkv(1, 16, 128), 2, 17)
    q, k, v = qkv(2, 16, 128)
    with pytest.raises(ValueError, match="strided"):     # rows not unit-stride
        A.fused_short_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                                k, v, 2, 16)
    with pytest.raises(ValueError, match="bfloat16"):    # k of another shape
        A.fused_short_attention(q, k[:, :8], v, 2, 16)
    assert A.LAUNCHES == {"fused_short_attention": 0}


@pytest.mark.cuda
def test_hybrid_and_postln_layers_raise_outside_the_kernels_shapes(cuda):
    """With ``fused_block`` off and ``fused_attention`` on, a CLIP block of
    a head_dim the attention kernel does not take reaches the wrapper on the
    card and raises, and so does an XLM-R layer on the post-LN wrappers: no
    plain fallback by shape. With autograd on and trainable parameters the
    layers take their training entries, whose forward reaches the same
    wrapper and raises the same way."""
    from wise_tpu_torch.models.clip import hf_text as TH
    from wise_tpu_torch.models.clip import model as TM

    blk = TM.ResidualAttentionBlock(288, 4, "gelu", torch.bfloat16,
                                    fused_block=False,
                                    fused_attention=True).to(cuda)
    A.reset_launches()
    x = torch.randn(2, 16, 288, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="head_dim"):
        blk(x, n_valid=16)
    with pytest.raises(ValueError, match="head_dim"):
        blk(x, n_valid=16)
    layer = TH.BertLayer(TH.HFTextConfig(
        vocab_size=64, width=128, layers=1, heads=4, intermediate=512,
        dtype="bfloat16", fused_block=True)).to(cuda)
    P.reset_launches()
    x = torch.randn(2, 16, 128, device=cuda).to(torch.bfloat16)
    km = torch.zeros(2, 1, 16, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="head_dim"):
        layer(x, km)
    with pytest.raises(ValueError, match="head_dim"):
        layer(x, km)
    assert not any(A.LAUNCHES.values()) and not any(P.LAUNCHES.values())


@pytest.mark.cuda
def test_hybrid_block_runs_the_attention_kernel_on_card(cuda):
    """A CLIP block under WISE_FUSED_BLOCK=0: one fused_short_attention
    launch, no block kernel, and the plain block's output."""
    from wise_tpu_torch.models.clip import model as TM

    kw = dict(width=128, heads=2, act="gelu", dtype=torch.bfloat16)
    hybrid = TM.ResidualAttentionBlock(fused_block=False,
                                       fused_attention=True, **kw)
    TM.init_random_(hybrid, seed=1)
    plain = TM.ResidualAttentionBlock(fused_block=False, **kw)
    plain.load_state_dict(hybrid.state_dict())
    hybrid, plain = hybrid.to(cuda), plain.to(cuda)
    x = torch.randn(3, 50, 128, device=cuda)
    K.reset_launches()
    A.reset_launches()
    with torch.no_grad():
        got = hybrid(x, n_valid=50, causal=True)
        assert A.LAUNCHES_BY_SHAPE == {("fused_short_attention", 50, 128): 1}
        want = plain(x, n_valid=50, causal=True)
    assert A.LAUNCHES == {"fused_short_attention": 1}
    assert not any(K.LAUNCHES.values())
    check = K.increment_agreement(got, want, x)
    assert check["ok"], check


@pytest.mark.cuda
def test_siglip_towers_run_the_kernels_on_card(cuda):
    """A small SigLIP CLIP (head_dim 64, 64 px at patch 8: 64 tokens; 12
    text tokens) on the kernel path against its plain twin: every vision
    layer whole (no pooled block), the text tower non-causal with the
    pooled block at row 11; embeddings agree (cosine >= 0.999)."""
    import dataclasses

    from wise_tpu_torch.models.clip import config as TC
    from wise_tpu_torch.models.clip import model as TM

    cfg = dataclasses.replace(
        TC.get_clip_config("ViT-L-16-SigLIP-384"), embed_dim=96,
        image_size=64, patch_size=8, vision_width=128, vision_heads=2,
        vision_layers=3, context_length=12, vocab_size=4096, text_width=128,
        text_heads=2, text_layers=2, dtype="bfloat16", fused_block=True,
        pool_last_block=True)
    fused = TM.init_random_(TM.CLIP(cfg), seed=2).eval()
    plain = TM.CLIP(dataclasses.replace(cfg, fused_block=False)).eval()
    plain.load_state_dict(fused.state_dict())
    fused, plain = fused.to(cuda), plain.to(cuda)
    g = torch.Generator().manual_seed(120)
    images = torch.randn((4, 64, 64, 3), generator=g).to(cuda)
    tokens = torch.randint(1, 4096, (5, 12), generator=g).to(cuda)
    K.reset_launches()
    with torch.no_grad():
        got_i = fused.encode_image(images)
        vision = dict(K.LAUNCHES_BY_SHAPE)
        got_t = fused.encode_text(tokens)
        want_i, want_t = plain.encode_image(images), plain.encode_text(tokens)
    assert vision == {("fused_attn_block", 64, 128): 3,
                      ("fused_mlp_block", 64, 128): 3}
    assert {k: v for k, v in K.LAUNCHES_BY_SHAPE.items() if k[1] == 12} == {
        ("fused_attn_block", 12, 128): 1, ("fused_mlp_block", 12, 128): 1,
        ("fused_attn_block_pooled", 12, 128): 1}
    for got, want in ((got_i, want_i), (got_t, want_t)):
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        assert bool(torch.isfinite(got).all()) and cos.min().item() >= 0.999


# ---------------------------------------------------------------------------
# The fused scan + top-k kernels (wise_tpu_torch/csrc/topk_kernels.cu)
# ---------------------------------------------------------------------------

from wise_tpu_torch.ops import fused_topk as FT  # noqa: E402
from wise_tpu_torch.ops import topk as TK  # noqa: E402

TOPK_FNS = ["fused_topk", "fused_topk_threshold"]
#: (n, d, q, k, group): one query, a ragged last group, more than one query
#: tile, the widest rows and buffer, fewer valid rows than k, a full query
#: tile of the threshold scan (16)
TOPK_CASES = [(1000, 16, 1, 10, 256), (300, 32, 3, 7, 128),
              (5000, 768, 9, 33, 512), (40000, 1024, 17, 1024, 4096),
              (3, 8, 2, 10, 64), (9000, 512, 16, 50, 1024),
              # ViT-bigG-14's 1280-d joint space: a tile of 16, of 1, and
              # the group path's batches
              (9000, 1280, 16, 10, 1024), (5000, 1280, 1, 100, 512),
              (7000, 1280, 64, 100, 1024)]


def _topk_tied(n, d, q, group, device, storage):
    """Small-integer vectors with planted duplicates (across groups, inside
    one tile, at the k-th boundary) and a query with only negative scores;
    rows zero-padded to a multiple of ``group``."""
    g = torch.Generator().manual_seed(n + d)
    db = torch.randint(-3, 4, (n, d), generator=g).float()
    if n > 50:
        db[n // 2] = db[3]
        db[n - 1] = db[3]
        db[7:12] = db[40]
    queries = torch.randint(-2, 3, (q, d), generator=g).float()
    queries[0] = -queries[0].abs()
    return queries.to(device), TK.pad_rows(db, group).to(device, storage)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TOPK_CASES)
@pytest.mark.parametrize("fn", TOPK_FNS)
def test_topk_kernel_identical_on_integer_vectors(cuda, fn, case, storage):
    n, d, q, k, group = case
    queries, db = _topk_tied(n, d, q, group, cuda, storage)
    FT.reset_launches()
    got = getattr(FT, fn)(queries, db, n, k, group)
    torch.cuda.synchronize()
    assert FT.LAUNCHES[fn] == 1
    assert FT.LAUNCHES_BY_SHAPE == {(fn, db.shape[0], d): 1}
    want = getattr(FT, fn + "_plain")(queries, db, n, k, group)
    check = FT.topk_agreement(got, want)
    assert check["ok"], check
    assert got[0].shape == (q, min(k, n)) and int(got[1].max()) < n
    # the same order as the exact search on the CPU
    cpu = TK.flat_topk(queries.cpu(), db.cpu(), n, k, group)
    assert torch.equal(got[1].cpu(), cpu[1])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", TOPK_FNS)
def test_topk_kernel_on_random_unit_vectors(cuda, fn, storage):
    g = torch.Generator().manual_seed(5)
    n, d, group = 50000, 512, 4096
    db = torch.nn.functional.normalize(torch.randn(n, d, generator=g))
    queries = torch.nn.functional.normalize(torch.randn(12, d, generator=g))
    db = TK.pad_rows(db, group).to(cuda, storage)
    got = getattr(FT, fn)(queries.to(cuda), db, n, 100, group)
    want = getattr(FT, fn + "_plain")(queries.to(cuda), db, n, 100, group)
    check = FT.topk_agreement(got, want, tol=2e-6)
    assert check["ok"], check


@pytest.mark.cuda
def test_topk_planted_faults_fail_the_check(cuda):
    """The n_valid mask dropped, and ties resolved to the higher row (the
    kernel run on the rows in reverse), must fail the check the kernels
    pass."""
    n, d, q, k, group = 1000, 16, 3, 10, 256
    queries, db = _topk_tied(n, d, q, group, cuda, torch.float32)
    # non-negative rows under a negative query: every true score is below
    # the zero padding's
    db, queries[0] = db.abs(), -(queries[0].abs() + 1)
    want = FT.fused_topk_threshold_plain(queries, db, n, k, group)
    unmasked = FT.fused_topk_threshold(queries, db, db.shape[0], k, group)
    assert not FT.topk_agreement(unmasked, want)["ok"]
    flipped = torch.zeros_like(db)
    flipped[db.shape[0] - n:] = db[:n].flip(0)
    s, r = FT.fused_topk_threshold(queries, flipped, db.shape[0], k, group)
    assert not FT.topk_agreement((s, db.shape[0] - 1 - r), want)["ok"]


@pytest.mark.cuda
def test_flat_topk_dispatches_to_the_kernels_on_card(cuda):
    n, d, group = 3000, 64, 512
    queries, db = _topk_tied(n, d, 32, group, cuda, torch.float32)
    cpu_db = db.cpu()
    # Q = 32 at k = 10: the router's cut (ops.topk.THRESHOLD_MAX_BATCH)
    q32 = ("fused_topk_threshold" if TK.THRESHOLD_MAX_BATCH >= 32
           else "fused_topk")
    for qn, k, name in ((1, 10, "fused_topk_threshold"),
                        (16, 10, "fused_topk_threshold"), (32, 10, q32),
                        (16, 100, "fused_topk"), (16, 600, None)):
        FT.reset_launches()
        got = TK.flat_topk(queries[:qn], db, n, k, group)
        want = TK.flat_topk(queries[:qn].cpu(), cpu_db, n, k, group)
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[0].cpu(), want[0])
        assert FT.LAUNCHES == {
            w: int(w == name) for w in ("fused_topk", "fused_topk_threshold")}


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qn,k", [(1, 1), (16, 10), (16, 1024), (33, 64)])
def test_topk_threshold_scan_flushes_on_tied_rows(cuda, qn, k, storage):
    """wt_topk_threshold on rows that all tie for every query: each range's
    lists fill and flush (counted by flush_count), the answer is the
    first k rows. Q = 16 is one query tile of 16 (k = 1024: tiles of 1,
    as scan_tile keeps the lists in shared memory), Q = 33 three tiles; the
    8 ranges (12 row blocks) end inside groups of 1,024."""
    n, d, group = 3000, 64, 1024
    db = TK.pad_rows(torch.ones(n, d), group).to(cuda, storage)
    queries = torch.ones(qn, d, device=cuda)
    queries[0] = -1.0  # every valid row under the zero padding
    FT.reset_flushes(cuda)
    out = (torch.empty((8, qn, k), device=cuda),
           torch.empty((8, qn, k), dtype=torch.int32, device=cuda))
    got = (torch.empty((qn, k), device=cuda),
           torch.empty((qn, k), dtype=torch.int64, device=cuda))
    FT.threshold_scan_cuda(queries, db, n, k, *out, got)
    torch.cuda.synchronize()
    # a range's rows all pass τ = 0 until a list of k <= 64 (at most 127
    # places) fills; a list of k = 1,024 holds a range's 512 rows whole
    assert (FT.flush_count(cuda) > 0) == (k <= 64)
    want = FT.fused_topk_threshold_plain(queries, db, n, k, group)
    check = FT.topk_agreement(got, want)
    assert check["ok"], check
    assert torch.equal(got[1][0].cpu(), torch.arange(k))
    # the merge by the last CTA against the torch merge of the candidates,
    # twice, then on two side streams at once: each call zeroes its own
    # tickets
    for _ in range(2):
        FT.threshold_scan_cuda(queries, db, n, k, *out, got)
        assert FT.topk_agreement(got, FT._merge(*out, k))["ok"]
    torch.cuda.synchronize()
    answers = []
    for side in (torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)):
        with torch.cuda.stream(side):
            cands = (torch.empty_like(out[0]), torch.empty_like(out[1]))
            top = (torch.empty_like(got[0]), torch.empty_like(got[1]))
            FT.threshold_scan_cuda(queries, db, n, k, *cands, top)
            answers.append(top)
    torch.cuda.synchronize()
    for top in answers:
        assert FT.topk_agreement(top, want)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 100, 1024])
@pytest.mark.parametrize("qn", [1, 7, 61, 64, 200])
def test_topk_bf16_group_path_with_chunks_forced(cuda, qn, k, storage):
    """fused_topk's group path (wt_topk_gemm or wt_topk_gemm_f32, then
    wt_topk_select), on both storage types: through the wrapper (one launch
    counted), and with chunks forced small (24 queries, Sᵀ scratch of two
    groups) so that queries and groups both split; identical to the plain
    version on integer vectors either way."""
    n, d, group = 15000, 128, 4096
    queries, db = _topk_tied(n, d, qn, group, cuda, storage)
    want = FT.fused_topk_plain(queries, db, n, k, group)
    FT.reset_launches()
    got = FT.fused_topk(queries, db, n, k, group)
    torch.cuda.synchronize()
    assert FT.LAUNCHES["fused_topk"] == 1
    check = FT.topk_agreement(got, want)
    assert check["ok"], check
    product = (FT.scores_t_cuda if storage == torch.bfloat16
               else FT.scores_t_f32_cuda)
    forced = FT.group_topk_chunks(
        queries, db, n, k, group, product, FT.select_groups_cuda,
        chunk_queries=24, scratch_bytes=2 * group * 24 * 4)
    torch.cuda.synchronize()
    check = FT.topk_agreement(forced, want)
    assert check["ok"], check


#: (rows, D, Q_pad): ragged rows (a 256-row tile's tail), ragged D (72 -> a
#: 32-column block half zero; 8), one and eight 8-query steps, the index's
#: width
F32_PRODUCT_CASES = [(1000, 72, 16), (300, 8, 8), (4096, 512, 64),
                     (2049, 128, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,q_pad", F32_PRODUCT_CASES)
def test_topk_f32_product_matches_its_plain_version(cuda, rows, d, q_pad):
    """wt_topk_gemm_f32: Sᵀ identical to the plain f32 product on integer
    vectors (lo = 0, every sum exact), within 2e-6 on unit vectors (3xTF32:
    the dropped terms are ~2^-22 of each product)."""
    g = torch.Generator().manual_seed(rows + d)
    for kind in ("integer", "unit"):
        if kind == "integer":
            db = torch.randint(-3, 4, (rows, d), generator=g).float()
            qp = torch.randint(-2, 3, (q_pad, d), generator=g).float()
        else:
            db = torch.nn.functional.normalize(torch.randn(rows, d,
                                                           generator=g))
            qp = torch.nn.functional.normalize(torch.randn(q_pad, d,
                                                           generator=g))
        db, qp = db.to(cuda), qp.to(cuda)
        st = torch.full((rows, q_pad), float("nan"), device=cuda)
        want = torch.empty_like(st)
        FT.scores_t_f32_cuda(db, qp, st)
        FT.scores_t_f32_plain(db, qp, want)
        torch.cuda.synchronize()
        if kind == "integer":
            assert torch.equal(st, want)
        else:
            assert float((st - want).abs().max()) <= 2e-6
            # a TF32-only product does not meet the bar
            one = FT.tf32(qp) @ FT.tf32(db).T
            assert float((one.T - want).abs().max()) > 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "tied"])
def test_topk_selection_branches_match_the_plain_selection(cuda, case):
    """wt_topk_select on one Sᵀ against select_groups_plain: random scores
    take the sort of the survivors (no overflow); scores tied everywhere
    (every row at the lower bound) overflow the buffer and take the
    insertion; a group of 5000 rows goes in three segments, n_valid ends
    inside the second group, the last group is all padding."""
    group, groups, qn, k = 5000, 3, 13, 100
    g = torch.Generator().manual_seed(3)
    if case == "random":
        st = torch.randn(group * groups, 16, generator=g)
    else:
        st = torch.randint(0, 2, (group * groups, 16), generator=g).float()
    st = st.to(cuda)
    n_valid = group + 1234
    outs = [(torch.empty((groups, qn, k), device=cuda),
             torch.empty((groups, qn, k), dtype=torch.int32, device=cuda))
            for _ in range(2)]
    FT.reset_overflows(cuda)
    FT.select_groups_cuda(st, 0, n_valid, k, group, *outs[0], 0, qn)
    FT.select_groups_plain(st, 0, n_valid, k, group, *outs[1], 0, qn)
    torch.cuda.synchronize()
    overflows = FT.overflow_count(cuda)
    assert (overflows > 0) == (case == "tied"), overflows
    # both leave each slot sorted by (score descending, row ascending)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert bool((outs[0][0][2] == float("-inf")).all())


@pytest.mark.cuda
def test_flat_topk_on_f32_runs_the_group_kernels(cuda):
    """flat_topk at Q = 64, k = 100 on an f32 CUDA database: fused_topk (the
    product and the selection), not the scan kernel of fused_topk_threshold;
    scores within 2e-6 of the CPU search, rows equal but among near ties."""
    g = torch.Generator().manual_seed(11)
    n, d, group = 20000, 512, 4096
    db = torch.nn.functional.normalize(torch.randn(n, d, generator=g))
    queries = torch.nn.functional.normalize(torch.randn(64, d, generator=g))
    pad = TK.pad_rows(db, group)
    FT.reset_launches()
    got = TK.flat_topk(queries.to(cuda), pad.to(cuda), n, 100, group)
    torch.cuda.synchronize()
    assert FT.LAUNCHES == {"fused_topk": 1, "fused_topk_threshold": 0}
    want = TK.flat_topk(queries, pad, n, 100, group)
    check = FT.topk_agreement(tuple(t.cpu() for t in got), want, tol=2e-6)
    assert check["ok"], check


@pytest.mark.cuda
def test_topk_bf16_halves_match_their_plain_versions(cuda):
    """The GEMM's Sᵀ equals the plain product on integer vectors (exact
    sums), and the selection's candidates, sorted per slot, equal the plain
    selection's; rows >= n_valid never enter."""
    n, d, group, qn, k = 9000, 64, 1024, 13, 50
    queries, db = _topk_tied(n, d, qn, group, cuda, torch.bfloat16)
    wq = torch.zeros((d, 16), dtype=torch.bfloat16, device=cuda)
    wq[:, :qn] = queries.to(torch.bfloat16).T
    st = torch.empty((db.shape[0], 16), device=cuda)
    want_st = torch.empty_like(st)
    FT.scores_t_cuda(db, wq, st)
    FT.scores_t_plain(db, wq, want_st)
    torch.cuda.synchronize()
    assert torch.equal(st, want_st)
    groups = db.shape[0] // group
    outs = [(torch.empty((groups, qn, k), device=cuda),
             torch.empty((groups, qn, k), dtype=torch.int32, device=cuda))
            for _ in range(2)]
    FT.select_groups_cuda(st, 0, n, k, group, *outs[0], 0, qn)
    FT.select_groups_plain(st, 0, n, k, group, *outs[1], 0, qn)
    torch.cuda.synchronize()
    # each slot's candidates are a set (the kernel leaves them unsorted):
    # compare them in row order (every group holds >= k valid rows)
    (gs, gr), (ws, wr) = (
        (torch.gather(s, 2, order), r)
        for s, (r, order) in ((s, torch.sort(r, dim=2)) for s, r in outs))
    assert torch.equal(gr, wr) and torch.equal(gs, ws)
    assert int(gr.max()) < n


@pytest.mark.cuda
def test_topk_wrappers_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 16, device=cuda)
    db = torch.zeros(4096, 16, device=cuda)
    FT.reset_launches()
    for fn in (FT.fused_topk, FT.fused_topk_threshold):
        with pytest.raises(ValueError, match="width"):
            fn(torch.zeros(1, 12, device=cuda),
               torch.zeros(4096, 12, device=cuda), 10, 5)
        with pytest.raises(ValueError, match="k "):
            fn(q, db, 4096, 2000)
        with pytest.raises(ValueError, match="multiple of group"):
            fn(q, db[:4000], 4000, 5)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(q, db.half(), 4096, 5)
    assert not any(FT.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the training forwards (fused_*_res) and the autograd rules (fused_*_train)
# ---------------------------------------------------------------------------


def _res_call(kind, x, ln, w, fused=True):
    """((out, residual), serve twin's output) of one training forward."""
    kw = dict(heads=HEADS, n_valid=SP, causal=kind == "attn-causal")
    pick = (lambda f, p: f) if fused else (lambda f, p: p)
    if kind.startswith("attn"):
        fn = pick(K.fused_attn_block_res, K.plain_attn_block_res)
        return fn(x, *ln, *w, **kw), K.fused_attn_block(x, *ln, *w, **kw)
    if kind == "mlp":
        fn = pick(K.fused_mlp_block_res, K.plain_mlp_block_res)
        return fn(x, *ln, *w, act="gelu"), K.fused_mlp_block(x, *ln, *w,
                                                             act="gelu")
    fn = pick(K.fused_mlp_split_res, K.plain_mlp_split_res)
    return (fn(x, *ln, *w, act="quick_gelu"),
            K.fused_mlp_split(x, *ln, *w, act="quick_gelu"))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["attn", "attn-causal", "mlp", "split"])
def test_res_kernel_matches_plain_on_card(cuda, kind, stream):
    """Output on its increment, residual whole (output_agreement); the
    output is the serve twin's bit for bit (one launch chain, one epilogue
    value)."""
    x, ln, w = _inputs(40, cuda, stream, mlp=not kind.startswith("attn"))
    with torch.inference_mode():
        (got, res), twin = _res_call(kind, x, ln, w)
        (want, want_res), _ = _res_call(kind, x, ln, w, fused=False)
        torch.cuda.synchronize()
    assert res.dtype == torch.bfloat16 and res.shape == want_res.shape
    assert K.increment_agreement(got, want, x)["ok"]
    assert K.output_agreement(res, want_res)["ok"]
    assert torch.equal(got, twin)


@pytest.mark.cuda
def test_mlp_residual_is_the_value_before_the_activation(cuda):
    x, ln, w = _inputs(41, cuda, torch.float32, mlp=True)
    with torch.inference_mode():
        h, h_pre = K.fused_mlp_fc_res(x, *ln, *w[:2], act="gelu")
        _, want = K.plain_mlp_fc_res(x, *ln, *w[:2], act="gelu")
        assert torch.equal(h, K.fused_mlp_fc(x, *ln, *w[:2], act="gelu"))
    assert K.output_agreement(h_pre, want)["ok"]
    assert not K.output_agreement(h, want)["ok"]
    assert not K.output_agreement(torch.zeros_like(h), want)["ok"]


def _grad_cos(got, want):
    return min(torch.nn.functional.cosine_similarity(
        g.float().flatten(), w.float().flatten(), dim=0).item()
        for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", ["attn", "attn-causal", "mlp", "split",
                                  "pooled", "dyn"])
def test_train_rule_gradients_match_plain_on_card(cuda, rule, stream):
    """Each autograd rule's gradients against autograd through the plain
    block on the same tensors: per-tensor cosine >= 0.999."""
    mlp = rule in ("mlp", "split")
    x, ln, w = _inputs(42, cuda, stream, mlp=mlp)
    args = [t.requires_grad_() for t in (x, *ln, *w)]
    rows = torch.from_numpy(ROWS).to(cuda)
    causal = rule == "attn-causal"
    fused, plain = {
        "attn": (lambda: K.fused_attn_block_train(*args, HEADS, SP, causal),
                 lambda: K.plain_attn_block(*args, HEADS, SP, causal)),
        "mlp": (lambda: K.fused_mlp_block_train(*args, "gelu"),
                lambda: K.plain_mlp_block(*args, "gelu")),
        "split": (lambda: K.fused_mlp_split_train(*args, "gelu"),
                  lambda: K.plain_mlp_split(*args, "gelu")),
        "pooled": (lambda: K.fused_attn_block_pooled_train(*args, HEADS, SP,
                                                           5, False),
                   lambda: K.plain_attn_block_pooled(*args, HEADS, SP, 5,
                                                     False)),
        "dyn": (lambda: K.fused_attn_block_pooled_dyn_train(
                    args[0], rows, *args[1:], HEADS, SP, True),
                lambda: K.plain_attn_block_pooled_dyn(
                    args[0], rows, *args[1:], HEADS, SP, True)),
    }[rule.split("-")[0]]
    K.reset_launches()
    out = fused()
    assert out.requires_grad
    weight = torch.randn(out.shape, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    got = torch.autograd.grad((out.float() * weight).sum(), args)
    want = torch.autograd.grad((plain().float() * weight).sum(), args)
    assert _grad_cos(got, want) >= 0.999
    launched = {k for k, v in K.LAUNCHES.items() if v}
    assert launched == {
        "attn": {"fused_attn_block_res"}, "mlp": {"fused_mlp_block_res"},
        "split": {"fused_mlp_fc_res", "fused_mlp_proj"},
        "pooled": {"fused_attn_block_pooled"},
        "dyn": {"fused_attn_block_pooled_dyn"}}[rule.split("-")[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["postln-attn", "postln-mlp", "attention",
                                  "attention-causal"])
def test_recompute_rule_gradients_match_plain_on_card(cuda, rule):
    """The post-LN rules (64 tokens at head_dim 64, every example's keys cut
    at another length) and the attention middle's (n_valid < SP,
    and causal): the kernel forward launches once, the output is the serve
    wrapper's bit for bit, and the gradients are autograd's through the
    plain version (per-tensor cosine >= 0.999)."""
    from wise_tpu_torch.ops import attention as A

    P.reset_launches()
    A.reset_launches()
    if rule.startswith("postln"):
        mlp = rule == "postln-mlp"
        x, km, ln, w = _postln_inputs("xlmr", 120, cuda, mlp=mlp)
        args = [t.requires_grad_() for t in (x, *ln, *w)]
        heads = POSTLN_SHAPES["xlmr"][3]
        if mlp:
            fused = lambda: P.fused_postln_mlp_block_train(*args)  # noqa
            plain = lambda: P.plain_postln_mlp_block(*args)  # noqa
            serve = lambda: P.fused_postln_mlp_block(*args)  # noqa
        else:
            fused = lambda: P.fused_postln_attn_block_train(  # noqa
                args[0], km, *args[1:], heads)
            plain = lambda: P.plain_postln_attn_block(  # noqa
                args[0], km, *args[1:], heads)
            serve = lambda: P.fused_postln_attn_block(  # noqa
                args[0], km, *args[1:], heads)
    else:
        causal = rule == "attention-causal"
        g = torch.Generator().manual_seed(121)
        args = [torch.randn(4, 77, 512, generator=g).to(cuda, torch.bfloat16)
                .requires_grad_() for _ in range(3)]
        n_valid = 77 if causal else 60
        fused = lambda: A.fused_attention_trainable(  # noqa
            *args, 8, n_valid, causal)
        plain = lambda: A.plain_short_attention(  # noqa
            *args, 8, n_valid, causal)
        serve = lambda: A.fused_short_attention(  # noqa
            *args, 8, n_valid, causal)
    out = fused()
    assert out.requires_grad
    # one launch: at width 256 the MLP is the "single" variant
    launched = dict(P.LAUNCHES_BY_SHAPE) | dict(A.LAUNCHES_BY_SHAPE)
    assert sum(launched.values()) == 1
    with torch.no_grad():
        assert torch.equal(out, serve())
    weight = torch.randn(out.shape, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(2))
    got = torch.autograd.grad((out.float() * weight).sum(), args)
    want = torch.autograd.grad((plain().float() * weight).sum(), args)
    assert all(bool(t.isfinite().all()) for t in got)
    assert _grad_cos(got, want) >= 0.999


@pytest.mark.cuda
def test_wrappers_raise_under_autograd_on_card(cuda):
    """A kernel wrapper called on CUDA tensors with an input that requires a
    gradient raises instead of returning a tensor cut from the graph; with
    autograd off it launches."""
    from wise_tpu_torch.ops import attention as A
    from wise_tpu_torch.ops import fused_topk as FT

    x, ln, w = _inputs(43, cuda, torch.bfloat16)
    w[0].requires_grad_()
    rows = torch.from_numpy(ROWS).to(cuda)
    kw = dict(heads=HEADS, n_valid=SP)
    calls = [lambda: K.fused_attn_block(x, *ln, *w, **kw),
             lambda: K.fused_attn_block_res(x, *ln, *w, **kw),
             lambda: K.fused_attn_block_pooled(x, *ln, *w, **kw),
             lambda: K.fused_attn_block_pooled_dyn(x, rows, *ln, *w, **kw)]
    xm, lnm, wm = _inputs(44, cuda, torch.bfloat16, mlp=True)
    lnm[0].requires_grad_()
    calls += [lambda: K.fused_mlp_block(xm, *lnm, *wm),
              lambda: K.fused_mlp_block_res(xm, *lnm, *wm),
              lambda: K.fused_mlp_split(xm, *lnm, *wm),
              lambda: K.fused_mlp_split_res(xm, *lnm, *wm),
              lambda: K.fused_mlp_fc(xm, *lnm, *wm[:2])]
    q = torch.randn(2, 16, 128, device=cuda).bfloat16().requires_grad_()
    calls.append(lambda: A.fused_short_attention(q, q, q, 2, 16))
    xp, km, lnp, wp = _postln_inputs("xlmr", 45, cuda)
    xp.requires_grad_()
    calls.append(lambda: P.fused_postln_attn_block(
        xp, km, *lnp, *wp, POSTLN_SHAPES["xlmr"][3]))
    db = torch.randn(4096, 64, device=cuda)
    qv = torch.randn(1, 64, device=cuda, requires_grad=True)
    calls.append(lambda: FT.fused_topk_threshold(qv, db, 4096, 10))
    for call in calls:
        with pytest.raises(RuntimeError, match="cut from the autograd"):
            call()
        with torch.no_grad():
            call()


# ---------------------------------------------------------------------------
# the padded-head block (fused_ln_matmul, fused_residual_matmul, the chain
# and its training rule) and the embed fold
# ---------------------------------------------------------------------------

from wise_tpu_torch.ops import embed_block as E  # noqa: E402

#: head_dim 80 at 24 tokens, as WIDE_SHAPES' smallest
PAD_B, PAD_SP, PAD_D, PAD_HEADS, PAD_NV = 3, 24, 160, 2, 21


def _padded_inputs(seed, device, stream):
    g = torch.Generator().manual_seed(seed)

    def w(*shape, std=0.02):
        return (std * torch.randn(shape, generator=g)).to(device)

    d = PAD_D
    x = torch.randn((PAD_B, PAD_SP, d), generator=g).to(device, stream)
    ln = [1.0 + w(d), w(d)]
    ws = (w(d, 3 * d, std=d ** -0.5), w(3 * d), w(d, d, std=d ** -0.5),
          w(d))
    return x, ln, [t.to(torch.bfloat16) for t in ws]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "gelu"])
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
def test_ln_matmul_matches_plain_on_card(cuda, stream, act):
    x, ln, w = _padded_inputs(120, cuda, stream)
    K.reset_launches()
    with torch.inference_mode():
        got = K.fused_ln_matmul(x, *ln, *w[:2], act)
        want = K.plain_ln_matmul(x, *ln, *w[:2], act)
        torch.cuda.synchronize()
    assert K.LAUNCHES_BY_SHAPE == {("fused_ln_matmul", PAD_SP, PAD_D): 1}
    assert got.dtype == want.dtype == stream and got.shape == want.shape
    assert K.output_agreement(got, want)["ok"]
    if act == "gelu":
        bad = K.fused_ln_matmul(x, *ln, *w[:2], "none")
        assert not K.output_agreement(bad, want)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
def test_residual_matmul_matches_plain_on_card(cuda, stream):
    x, _, w = _padded_inputs(121, cuda, stream)
    h = torch.randn(PAD_B, PAD_SP, PAD_D, device=cuda).bfloat16()
    with torch.inference_mode():
        got = K.fused_residual_matmul(x, h, *w[2:])
        want = K.plain_residual_matmul(x, h, *w[2:])
        torch.cuda.synchronize()
    assert got.dtype == stream and got.shape == x.shape
    assert K.increment_agreement(got, want, x)["ok"]
    assert not K.increment_agreement(x, want, x)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_padded_block_matches_plain_on_card(cuda, causal, stream):
    """Five wrapper calls: three fused_ln_matmul, one attention at head_dim
    128, one fused_residual_matmul; the attention block's function at rows
    < n_valid."""
    x, ln, w = _padded_inputs(122, cuda, stream)
    K.reset_launches()
    A.reset_launches()
    with torch.inference_mode():
        got = K.fused_attn_block_padded(x, *ln, *w, PAD_HEADS, PAD_NV, causal)
        want = K.plain_attn_block(x, *ln, *w, PAD_HEADS, PAD_NV, causal)
        torch.cuda.synchronize()
    assert K.LAUNCHES_BY_SHAPE == {("fused_ln_matmul", PAD_SP, PAD_D): 3,
                                   ("fused_residual_matmul", PAD_SP, PAD_D): 1}
    assert A.LAUNCHES_BY_SHAPE == {
        ("fused_short_attention", PAD_SP, PAD_HEADS * K.HEAD_PAD): 1}
    v = slice(0, PAD_NV)
    assert got.dtype == stream
    assert K.increment_agreement(got[:, v], want[:, v], x[:, v])["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_padded_train_rule_gradients_match_plain_on_card(cuda, causal):
    x, ln, w = _padded_inputs(123, cuda, torch.float32)
    args = [t.requires_grad_() for t in (x, *ln, *w)]
    weight = torch.randn(x.shape, device=cuda)
    weight[:, PAD_NV:] = 0

    def grads(fn):
        out = fn(*args, PAD_HEADS, PAD_NV, causal)
        return torch.autograd.grad((out.float() * weight).sum(), args)

    K.reset_launches()
    got = grads(K.fused_attn_block_padded_train)
    assert K.LAUNCHES["fused_ln_matmul"] == 3
    assert _grad_cos(got, grads(K.plain_attn_block)) >= 0.999
    with pytest.raises(RuntimeError, match="cut from the autograd"):
        K.fused_attn_block_padded(*args, PAD_HEADS, PAD_NV, causal)


def _embed_inputs(pd, device, seed=130, b=4, sp=50, d=128, nv=45):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=0.05):
        return std * torch.randn(shape, generator=g)

    xp = r(b, sp, pd, std=1.0)
    xp[:, 0] = 0
    xp[:, nv:] = 0
    posc = r(sp, d)
    posc[nv:] = 0
    bf = [t.to(device, torch.bfloat16) for t in (
        xp, r(pd, d, std=pd ** -0.5), r(d, 3 * d, std=d ** -0.5), r(3 * d),
        r(d, d, std=d ** -0.5), r(d))]
    lns = [t.to(device) for t in (1 + r(d), r(d), 1 + r(d), r(d))]
    return ([bf[0], bf[1], posc.to(device), *lns, *bf[2:]], nv)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_out", [False, True])
@pytest.mark.parametrize("pd", [96, 48, 588])
def test_embed_fold_matches_plain_on_card(cuda, pd, bf16_out):
    """PD 96 as it is; 48 and 588 (/14) pad K to the GEMM's step of 32. Held
    on the first block's increment over the ln_pre stream, rows < n_valid."""
    args, nv = _embed_inputs(pd, cuda)
    E.reset_launches()
    with torch.inference_mode():
        got = E.fused_embed_attn_block(*args, 2, nv, bf16_out)
        want = E.plain_embed_attn(*args, 2, nv, bf16_out)
        stream = E.layer_norm_f32(
            args[0].float() @ args[1].float() + args[2], args[3],
            args[4]).to(want.dtype)
        torch.cuda.synchronize()
    assert E.LAUNCHES == {"fused_embed_attn_block": 1}
    assert got.dtype == want.dtype and got.shape == want.shape
    v = slice(0, nv)
    assert K.increment_agreement(got[:, v], want[:, v], stream[:, v])["ok"]
    # a fold that dropped the positional table must fail the same check
    bad = E.fused_embed_attn_block(args[0], args[1], torch.zeros_like(args[2]),
                                   *args[3:], 2, nv, bf16_out)
    assert not K.increment_agreement(bad[:, v], want[:, v], stream[:, v])["ok"]


@pytest.mark.cuda
def test_padded_and_fold_wrappers_reject_what_they_do_not_take(cuda):
    x, ln, w = _padded_inputs(124, cuda, torch.bfloat16)
    K.reset_launches()
    with pytest.raises(ValueError, match="activation"):
        K.fused_ln_matmul(x, *ln, *w[:2], "relu")
    with pytest.raises(ValueError, match="output width"):
        K.fused_ln_matmul(x, *ln, w[0][:, :-4].contiguous(), w[1][:-4])
    with pytest.raises(ValueError, match="dtype"):
        K.fused_ln_matmul(x, *ln, w[0].float(), w[1])
    with pytest.raises(ValueError, match="shape"):
        K.fused_residual_matmul(x, x[:, :-1].contiguous(), *w[2:])
    with pytest.raises(ValueError, match="above"):
        K.fused_attn_block_padded(x, *ln, *w, 1, PAD_SP)
    assert not K.LAUNCHES["fused_ln_matmul"]
    args, nv = _embed_inputs(96, cuda)
    E.reset_launches()
    with pytest.raises(ValueError, match="head_dim"):
        E.fused_embed_attn_block(*args, 3, nv)
    with pytest.raises(ValueError, match="dtype"):
        E.fused_embed_attn_block(args[0].float(), *args[1:], 2, nv)
    assert E.LAUNCHES == {"fused_embed_attn_block": 0}



# ---------------------------------------------------------------------------
# the GEMM (csrc/common.cuh gemm_kernel) through its two one-GEMM entries, at
# shapes that take each of its three tiles, with ragged M, N and K edges
# ---------------------------------------------------------------------------

#: (B, SP, K, N) and the tile a 132-SM card picks: 128 x 256 where N is a
#: multiple of 256 and the epilogue has no activation (M = 2,112 = 16 x 128 +
#: 64: 17 x 10 tiles; with GELU 128 x 128), 128 x 128 (M = N = 1,056: 9 x 9
#: tiles, both edges ragged by 32), 64 x 64 (M = 130, Swin's N = 96). K = 160
#: and 96 end in a K step of 32.
GEMM_CASES = {"tile128x256": (64, 33, 160, 2560),
              "tile128x128": (32, 33, 96, 1056),
              "tile64x64": (2, 65, 96, 96)}


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "gelu"])
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_gemm_entries_match_plain_on_card(cuda, case, stream, act):
    b, sp, k, n = GEMM_CASES[case]
    g = torch.Generator().manual_seed(130)
    bf = torch.bfloat16
    x = torch.randn((b, sp, k), generator=g).to(cuda, stream)
    ln = [(1 + 0.25 * torch.randn(k, generator=g)).to(cuda),
          (0.25 * torch.randn(k, generator=g)).to(cuda)]
    w = (torch.randn((k, n), generator=g) * k ** -0.5).to(cuda, bf)
    bias = (0.02 * torch.randn(n, generator=g)).to(cuda, bf)
    xr = torch.randn((b, sp, n), generator=g).to(cuda, stream)
    h = torch.randn((b, sp, k), generator=g).to(cuda, bf)
    # W with the last K step's rows zeroed: a mainloop one stage short
    w_cut = w.clone()
    w_cut[(k - 1) // 64 * 64:] = 0
    with torch.inference_mode():
        want = K.plain_ln_matmul(x, *ln, w, bias, act)
        res_want = K.plain_residual_matmul(xr, h, w, bias)
        got = K.fused_ln_matmul(x, *ln, w, bias, act)
        res = K.fused_residual_matmul(xr, h, w, bias)
        cut = K.fused_ln_matmul(x, *ln, w_cut, bias, act)
        res_cut = K.fused_residual_matmul(xr, h, w_cut, bias)
        torch.cuda.synchronize()
    assert got.dtype == res.dtype == stream
    assert K.output_agreement(got, want)["ok"]
    assert K.increment_agreement(res, res_want, xr)["ok"]
    assert not K.output_agreement(cut, want)["ok"]
    assert not K.increment_agreement(res_cut, res_want, xr)["ok"]


@pytest.mark.cuda
def test_gemm_refuses_an_operand_off_16_bytes(cuda):
    """A W view 2 bytes off a 16-byte boundary (contiguous, so only the
    alignment is wrong): the wrapper raises, and the C entry returns
    cudaErrorInvalidValue without a launch. No other GEMM takes over."""
    from wise_tpu_torch.ops.build import load_library

    k, n, m = 64, 128, 8
    x = torch.randn((1, m, n), device=cuda)
    h = torch.randn((1, m, k), device=cuda).to(torch.bfloat16)
    bias = torch.zeros(n, dtype=torch.bfloat16, device=cuda)
    flat = torch.randn(k * n + 8, device=cuda).to(torch.bfloat16)
    w = flat[1:1 + k * n].view(k, n)
    with pytest.raises(ValueError, match="16-byte"):
        K.fused_residual_matmul(x, h, w, bias)
    out = torch.empty_like(x)
    err = load_library().wt_residual_matmul(
        h.data_ptr(), w.data_ptr(), bias.data_ptr(), x.data_ptr(), 1,
        out.data_ptr(), m, n, k, torch.cuda.current_stream().cuda_stream)
    assert err == 1

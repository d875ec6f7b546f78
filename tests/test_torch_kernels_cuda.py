"""The CUDA block kernels (wise_tpu_torch/csrc/block_kernels.cu) against
their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc, carries the ``cuda`` marker
and skips without one. The file imports no JAX, so it also runs on a GPU
machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance (ops.block.increment_agreement): on each block's increment over
its residual input, per-token cosine >= 0.999, the bar the Pallas kernels
are held to (tests/test_block_kernels.py), and max abs error <= 5% of the
plain increment's max abs. The kernel rounds its bf16 operands at the TPU
kernel's points, the plain version at PyTorch's.
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

#: (window, C, heads, res, batch): a tiny one, and HTSAT stage 0 (head_dim
#: 24, 64 windows an example) and stage 3 (one window, 32 heads)
SWIN_SHAPES = {"tiny": (4, 32, 2, 8, 2), "stage0": (8, 96, 4, 64, 2),
               "stage3": (8, 768, 32, 8, 4)}


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", [
    ("tiny", False), ("tiny", True), ("stage0", False), ("stage0", True),
    ("stage3", False)])   # stage 3: one window, no shifted block
@pytest.mark.parametrize("block", [False, True], ids=["attention", "block"])
def test_swin_kernel_matches_plain_on_card(cuda, block, shape, masked):
    x, attn, bias, mask, ln, mlp, heads = _swin_inputs(shape, masked, cuda)
    mod, name = (SB, "fused_swin_block") if block else \
        (SA, "fused_window_attention")
    mod.reset_launches()
    got = _swin_call(block, x, attn, bias, mask, ln, mlp, heads)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_BY_SHAPE == {(name, x.shape[1], x.shape[2], masked): 1}
    want = _swin_call(block, x, attn, bias, mask, ln, mlp, heads, False)
    assert got.dtype == want.dtype and got.shape == want.shape
    check = K.increment_agreement(got, want, x if block else torch.zeros(
        (), device=cuda))
    assert check["ok"], check


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["logits_zeroed", "mask_dropped",
                                   "bias_dropped"])
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
    else:
        bias = torch.zeros_like(bias)
    bad = _swin_call(block, x, attn, bias, mask, ln, mlp, heads)
    base = x if block else torch.zeros((), device=cuda)
    assert not K.increment_agreement(bad, want, base)["ok"]


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


@pytest.mark.cuda
@pytest.mark.parametrize("swin_block", [True, False])
def test_swin_model_raises_outside_the_kernels_shapes(cuda, swin_block):
    """A CLAP block whose windows the kernels do not take (window 12: 144
    tokens) reaches the wrapper on the card and raises: no plain fallback."""
    import dataclasses

    from wise_tpu_torch.models.clap import config as TC
    from wise_tpu_torch.models.clap import model as TM

    cfg = dataclasses.replace(TC.CLAPConfig(), dtype="bfloat16",
                              fused_block=True, fused_swin_block=swin_block)
    blk = TM.SwinBlock(32, 2, 12, 6, (24, 24), 4.0, cfg).to(cuda)
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        blk(torch.randn(2, 24 * 24, 32, device=cuda))


# ---------------------------------------------------------------------------
# The wide shapes (ViT-H/14's traits): head_dim 80, sequences over one
# 64-row query tile up to the 272-key limit, and the split MLP pair
# ---------------------------------------------------------------------------

#: (B, SP, n_valid, D, heads)
WIDE_SHAPES = {
    "vit_h": (3, 257, 257, 320, 4),      # head_dim 80, 257 tokens
    "masked": (2, 257, 250, 160, 2),     # keys masked inside the last tile
    "longest": (2, 272, 272, 160, 2),    # K and V fill the shared memory
    "tile+1": (2, 65, 65, 128, 2),       # one row into a second query tile
    "vit_b16": (2, 197, 197, 128, 2),    # head_dim 64 over 128 tokens
    "one": (2, 1, 1, 160, 2),
}


def _wide_inputs(shape, seed, device, stream, mlp=False):
    b, sp, _, d, _ = WIDE_SHAPES[shape]
    g = torch.Generator().manual_seed(seed)

    def w(*s, std=0.02):
        return (std * torch.randn(s, generator=g)).to(device)

    x = torch.randn((b, sp, d), generator=g).to(device, stream)
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
    with pytest.raises(ValueError, match="sequence"):   # over K/V's room
        K.fused_attn_block(*attn_args(273, 160), heads=2, n_valid=273)
    with pytest.raises(ValueError, match="sequence"):
        K.fused_attn_block_pooled(*attn_args(273, 160), heads=2, n_valid=273)
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
    (128, 2, 273, "sequence"),    # one key over the resident K and V
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

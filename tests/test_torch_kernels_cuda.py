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

"""The port's Swin ops (wise_tpu_torch/ops/swin_attention.py, swin_block.py)
against the JAX package's.

On the CPU the wrappers compute their plain PyTorch versions. Those are held
to the Pallas TPU kernels run in interpret mode, as tests/test_swin_fused.py
runs them:

- bf16 window batches: on each op's increment over its residual input (zero
  for window attention), per-token cosine >= 0.999 and max abs error <= 5%
  of the reference increment's max abs (``ops.block.increment_agreement``,
  the bar the port's block kernels are held to; the two round bf16 at other
  points and the TPU kernel's GELU uses an A&S erf);
- f32 window batches: 2e-5 abs (same math, f32 summation order and the A&S
  erf's 1.5e-7 only).

Masked (shifted) and unmasked blocks, with the mask's n_win both above the
TPU kernel's window group (the mask rides the grid, i % period) and below it
(the mask tiled up to the group). The check must fail three planted faults:
zeroed logits, the shift mask dropped, the relative bias dropped. The CUDA
kernels are held to these plain versions on the card in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops.swin_attention import fused_window_attention as j_attn
from wise_tpu.ops.swin_block import fused_swin_block as j_block
from wise_tpu_torch.models.clap.model import (relative_position_index,
                                              shift_attn_mask)
from wise_tpu_torch.ops import swin_attention as SA
from wise_tpu_torch.ops import swin_block as SB
from wise_tpu_torch.ops.block import increment_agreement

WINDOW, C, HEADS, FF, B = 4, 32, 2, 128, 2
L = WINDOW * WINDOW
RES = 8   # (RES / WINDOW)^2 = 4 windows per example
N_WIN = (RES // WINDOW) ** 2


def _inputs(seed, masked=True):
    """A window batch x ~ N(0, 1) of B examples; kernels at 1/sqrt(fan_in);
    the relative-bias table at std 1 (so that dropping it shows); biases
    and LayerNorm offsets N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    x = rng.standard_normal((B * N_WIN, L, C)).astype(np.float32)
    table = w((2 * WINDOW - 1) ** 2, HEADS, std=1.0)
    idx = relative_position_index(WINDOW).reshape(-1)
    bias = np.ascontiguousarray(
        table[idx].reshape(L, L, HEADS).transpose(2, 0, 1))
    mask = shift_attn_mask(RES, RES, WINDOW, WINDOW // 2) if masked else None
    attn = (w(C, 3 * C, std=C ** -0.5), w(3 * C), w(C, C, std=C ** -0.5),
            w(C))
    ln1, ln2 = (1.0 + w(C), w(C)), (1.0 + w(C), w(C))
    mlp = (w(C, FF, std=C ** -0.5), w(FF), w(FF, C, std=FF ** -0.5), w(C))
    return x, attn, bias, mask, ln1, ln2, mlp


def _call(fn, block, x, attn, bias, mask, ln1, ln2, mlp, **kw):
    if block:
        return fn(x, *ln1, *attn, bias, mask, *ln2, *mlp, heads=HEADS, **kw)
    return fn(x, *attn, bias, mask, heads=HEADS, **kw)


def _both(block, inputs, dtype, group):
    """(JAX TPU kernel in interpret mode, the port's wrapper on CPU)."""
    x, attn, bias, mask, ln1, ln2, mlp = inputs
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def j(a, dt=jdt):
        return None if a is None else jnp.asarray(a, dt)

    def t(a, dt=dtype):
        return None if a is None else torch.from_numpy(a).to(dt)

    want = _call(j_block if block else j_attn, block, j(x),
                 [j(a) for a in attn], j(bias, jnp.float32),
                 j(mask, jnp.float32), [j(a, jnp.float32) for a in ln1],
                 [j(a, jnp.float32) for a in ln2], [j(a) for a in mlp],
                 interpret=True, group=group)
    got = _call(SB.fused_swin_block if block else SA.fused_window_attention,
                block, t(x), [t(a) for a in attn], t(bias, torch.float32),
                t(mask, torch.float32), [t(a, torch.float32) for a in ln1],
                [t(a, torch.float32) for a in ln2], [t(a) for a in mlp])
    return np.asarray(want, np.float32), got.float().numpy()


#: (masked, TPU window group): unmasked; n_win 4 above the group 2 (the
#: mask indexed per grid step); n_win 4 below the group 8 (mask tiled)
CASES = [(False, 4), (True, 2), (True, 8)]


@pytest.mark.parametrize("masked,group", CASES)
@pytest.mark.parametrize("block", [False, True], ids=["attention", "block"])
def test_plain_matches_tpu_kernel_bf16(block, masked, group):
    inputs = _inputs(10 + group, masked)
    want, got = _both(block, inputs, torch.bfloat16, group)
    assert got.shape == want.shape == (B * N_WIN, L, C)
    base = torch.from_numpy(inputs[0]).to(torch.bfloat16) if block else \
        torch.zeros(())
    check = increment_agreement(torch.from_numpy(got),
                                torch.from_numpy(want), base)
    assert check["ok"], check


@pytest.mark.parametrize("masked,group", CASES)
@pytest.mark.parametrize("block", [False, True], ids=["attention", "block"])
def test_plain_matches_tpu_kernel_f32(block, masked, group):
    want, got = _both(block, _inputs(20 + group, masked), torch.float32,
                      group)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("fault", ["logits_zeroed", "mask_dropped",
                                   "bias_dropped"])
@pytest.mark.parametrize("block", [False, True], ids=["attention", "block"])
def test_increment_check_fails_a_planted_fault(block, fault):
    """The check must reject the op computed with its logits zeroed (q
    weights, bias and mask all zero: uniform attention), without the shift
    mask on a shifted block, or without the relative-position bias."""
    t = torch.from_numpy
    x, attn, bias, mask, ln1, ln2, mlp = _inputs(30)
    x, bias, mask = t(x), t(bias), t(mask)
    attn, ln1, ln2, mlp = ([t(a) for a in v] for v in (attn, ln1, ln2, mlp))
    fn = SB.fused_swin_block if block else SA.fused_window_attention
    want = _call(fn, block, x, attn, bias, mask, ln1, ln2, mlp)
    base = x if block else torch.zeros(())
    if fault == "logits_zeroed":
        wqkv, bqkv = attn[0].clone(), attn[1].clone()
        wqkv[:, :C], bqkv[:C] = 0, 0
        bad = _call(fn, block, x, [wqkv, bqkv, *attn[2:]],
                    torch.zeros_like(bias), None, ln1, ln2, mlp)
    elif fault == "mask_dropped":
        bad = _call(fn, block, x, attn, bias, None, ln1, ln2, mlp)
    else:
        bad = _call(fn, block, x, attn, torch.zeros_like(bias), mask, ln1,
                    ln2, mlp)
    assert increment_agreement(want, want, base)["ok"]
    assert not increment_agreement(bad, want, base)["ok"]


def test_cpu_wrappers_launch_no_kernel():
    SA.reset_launches()
    SB.reset_launches()
    x, attn, bias, mask, ln1, ln2, mlp = _inputs(40)
    t = torch.from_numpy
    SB.fused_swin_block(t(x), *map(t, ln1), *map(t, attn), t(bias), t(mask),
                        *map(t, ln2), *map(t, mlp), heads=HEADS)
    SA.fused_window_attention(t(x), *map(t, attn), t(bias), None,
                              heads=HEADS)
    assert not any(SA.LAUNCHES.values()) and not any(SB.LAUNCHES.values())


def test_supports_swin_kernels_gate():
    for c, heads in ((96, 4), (192, 8), (384, 16), (768, 32)):  # HTSAT
        assert SA.supports_swin_kernels(64, c, heads)
    assert SA.supports_swin_kernels(16, 32, 2)          # the tests' tiny
    assert not SA.supports_swin_kernels(144, 96, 4)     # window 12
    assert not SA.supports_swin_kernels(64, 96, 2)      # head_dim 48
    assert not SA.supports_swin_kernels(64, 80, 4)      # head_dim 20
    assert not SA.supports_swin_kernels(64, 40, 5)      # C % 32

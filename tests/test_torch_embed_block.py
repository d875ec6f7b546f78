"""The port's embed fold (wise_tpu_torch/ops/embed_block.py) against the JAX
package's (wise_tpu/ops/embed_block.py).

On the CPU ``fused_embed_attn_block`` computes ``plain_embed_attn``. That is
held to the Pallas TPU kernel in interpret mode (``interpret=True,
group=2``, as tests/test_embed_block.py runs it) and to the JAX package's
``plain_embed_attn``, at rows < n_valid (the rest are the kernel's to leave
undefined), with the stream in f32 and in bf16 (``bf16_out``): max abs
error <= 2e-2 (f32) / 5e-2 (bf16), the bars tests/test_embed_block.py holds
the kernel to against its plain version, and per-token cosine >= 0.999,
both on the whole output and on the first block's increment over the
stream that ``ln_pre`` gives (the stream dominates the output, so a block
that added nothing would pass on the whole output alone). The gate's truth
table is
tests/test_embed_block.py:58-70's on the port's table. The CUDA kernel is
held to the plain version on the card in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops import embed_block as JE
from wise_tpu_torch.ops import embed_block as E

#: tests/test_embed_block.py's shape: b 4, sp 16, p*p*3 48, d 128, 2 heads
B, SP, PD, D, HEADS, N_VALID = 4, 16, 48, 128, 2, 13


def _inputs(seed=0):
    """tests/test_embed_block.py's inputs, drawn with numpy: patch pixels
    ~ N(0, 1) with row 0 and rows >= n_valid zero, kern, posc, wqkv, wo at
    std 0.05 (posc zero from n_valid on), ln_pre 1 + N(0, 0.1) / N(0, 0.1),
    LN1 identity, zero biases; bf16 tensors as bf16 values."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    xp = bf(rng.standard_normal((B, SP, PD)))
    xp[:, 0] = 0
    xp[:, N_VALID:] = 0
    kern = bf(0.05 * rng.standard_normal((PD, D)))
    posc = (0.05 * rng.standard_normal((SP, D))).astype(np.float32)
    posc[N_VALID:] = 0
    lnp_s = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    lnp_b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    ln_s, ln_b = np.ones(D, np.float32), np.zeros(D, np.float32)
    wqkv = bf(0.05 * rng.standard_normal((D, 3 * D)))
    bqkv = np.zeros(3 * D, np.float32)
    wo = bf(0.05 * rng.standard_normal((D, D)))
    bo = np.zeros(D, np.float32)
    arrays = (xp, kern, posc, lnp_s, lnp_b, ln_s, ln_b, wqkv, bqkv, wo, bo)
    f32 = {2, 3, 4, 5, 6}  # posc and the LayerNorm parameters
    jargs = [jnp.asarray(a, jnp.float32 if i in f32 else jnp.bfloat16)
             for i, a in enumerate(arrays)]
    targs = [torch.from_numpy(a).to(torch.float32 if i in f32
                                    else torch.bfloat16)
             for i, a in enumerate(arrays)]
    return jargs, targs


def _agree(got, want):
    """(max abs error, min per-token cosine) at rows < n_valid, f32."""
    g, w = (t[:, :N_VALID].reshape(-1, D) for t in (got, want))
    cos = torch.nn.functional.cosine_similarity(g, w, dim=-1)
    return (g - w).abs().max().item(), cos.min().item()


@pytest.mark.parametrize("reference", ["tpu_kernel", "plain"])
@pytest.mark.parametrize("bf16_out", [False, True])
def test_embed_fold_matches_jax(bf16_out, reference):
    jargs, targs = _inputs()
    if reference == "tpu_kernel":
        want = JE.fused_embed_attn_block(
            *jargs, heads=HEADS, n_valid=N_VALID, bf16_out=bf16_out,
            interpret=True, group=2)
    else:
        want = JE.plain_embed_attn(*jargs, heads=HEADS, n_valid=N_VALID,
                                   bf16_out=bf16_out)
    got = E.fused_embed_attn_block(*targs, HEADS, N_VALID, bf16_out)
    assert got.dtype == (torch.bfloat16 if bf16_out else torch.float32)
    assert tuple(got.shape) == want.shape == (B, SP, D)
    got = got.float()
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    atol = 5e-2 if bf16_out else 2e-2
    err, cos = _agree(got, want)
    assert err <= atol and cos >= 0.999, (err, cos)
    # the attention block's increment over the ln_pre stream
    xp, kern, posc, lnp_s, lnp_b = targs[:5]
    stream = E.layer_norm_f32(xp.float() @ kern.float() + posc, lnp_s,
                              lnp_b).to(targs[7].dtype if bf16_out
                                        else torch.float32).float()
    err, cos = _agree(got - stream, want - stream)
    assert err <= atol and cos >= 0.999, (err, cos)


def test_embed_fold_takes_a_patch_width_off_the_k_step():
    """PD = 48 (like 588 at /14) is no multiple of the patch GEMM's K step:
    the plain version takes it as it is (the card's wrapper pads K with
    zeros, tests/test_torch_kernels_cuda.py)."""
    assert PD % E._K_STEP
    _, targs = _inputs(1)
    out = E.fused_embed_attn_block(*targs, HEADS, N_VALID)
    assert out.shape == (B, SP, D) and torch.isfinite(out[:, :N_VALID]).all()


def test_supports_gate_requires_calibration():
    """tests/test_embed_block.py:58-70 on the port: closed while the table
    is empty; with an entry, open for bf16 at head_dim 64 only. The
    reference's batch-divides-group term is a TPU term, not ported."""
    assert JE._CALIBRATED_EMBED == {} and E._CALIBRATED_EMBED == set()
    assert not E.supports_embed_fold(56, 768, 12, torch.bfloat16)
    assert not E.supports_embed_fold(50, 768, 12, torch.bfloat16)
    E._CALIBRATED_EMBED.add((50, 768))
    try:
        assert E.supports_embed_fold(50, 768, 12, torch.bfloat16)
        assert not E.supports_embed_fold(50, 768, 12, torch.float32)
        assert not E.supports_embed_fold(50, 768, 16, torch.bfloat16)
        assert not E.supports_embed_fold(50, 1024, 16, torch.bfloat16)
        assert not E.supports_embed_fold(50, 768, 0, torch.bfloat16)
    finally:
        E._CALIBRATED_EMBED.clear()

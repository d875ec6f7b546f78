"""The port's block ops (wise_tpu_torch/ops/block.py) against the JAX
package's.

On the CPU the wrappers compute their plain PyTorch versions. Those are held
to (a) the Pallas TPU kernels run in interpret mode on bf16 inputs, per-token
cosine >= 0.999 (the bar tests/test_block_kernels.py holds the kernels to:
bf16 rounding points differ between orderings), and (b) the JAX plain
references in f32 to 1e-5 abs (same math, f32 summation order only). The
CUDA kernels themselves are held to the plain versions on the card in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops import block as J
from wise_tpu_torch.ops import block as K

B, SP, D, HEADS, N_VALID = 8, 24, 128, 2, 20
ROWS = np.array([0, 5, 19, 12, 1, 23, 7, 19], np.int32)


def _inputs(seed, mlp=False):
    """x ~ N(0, 1); kernels at 1/sqrt(fan_in), as init_random_ draws them,
    so that each block adds about as much as x carries; biases and the
    LayerNorm offsets N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    x = rng.standard_normal((B, SP, D)).astype(np.float32)
    ln = (1.0 + w(D), w(D))
    f = 4 * D if mlp else D
    first = (D, 4 * D) if mlp else (D, 3 * D)
    return x, ln, (w(*first, std=D ** -0.5), w(first[1]),
                   w(f, D, std=f ** -0.5), w(D))


def _base(kind, x):
    """The residual input under a block's output: x, or x at the pooled
    rows."""
    if kind == "pooled":
        return x[:, 5]
    if kind == "dyn":
        return x[torch.arange(B), torch.from_numpy(ROWS).long()]
    return x


def _agree(kind, got, want, x):
    return K.increment_agreement(torch.from_numpy(got),
                                 torch.from_numpy(np.array(want)),
                                 _base(kind, x))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype) for a in arrs]


def _run(kind, causal, x, ln, w, jdt, tdt, interpret):
    """(JAX result, port result) for one block op."""
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jln, tln = _jax(ln, jnp.float32), _torch(ln, torch.float32)
    jw, tw = _jax(w, jdt), _torch(w, tdt)
    rows = torch.from_numpy(ROWS)
    if kind == "attn":
        fn = (J.fused_attn_block if interpret else J.plain_attn_block)
        kw = {"interpret": True} if interpret else {}
        got_j = fn(jx, *jln, *jw, heads=HEADS, n_valid=N_VALID,
                   causal=causal, **kw)
        got_t = K.fused_attn_block(tx, *tln, *tw, heads=HEADS,
                                   n_valid=N_VALID, causal=causal)
    elif kind == "mlp":
        act = "gelu_tanh" if causal else "gelu"
        if interpret:
            got_j = J.fused_mlp_block(jx, *jln, *jw, act=act, interpret=True)
        else:
            got_j = J.plain_mlp_block(jx, *jln, *jw, act=act)
        got_t = K.fused_mlp_block(tx, *tln, *tw, act=act)
    elif kind == "pooled":
        if interpret:
            got_j = J.fused_attn_block_pooled(
                jx, *jln, *jw, heads=HEADS, n_valid=N_VALID, pool_row=5,
                causal=causal, interpret=True, group=B)
        else:
            got_j = J._pooled_block_xla(jx, *jln, *jw, HEADS, N_VALID, 5,
                                        causal)
        got_t = K.fused_attn_block_pooled(tx, *tln, *tw, heads=HEADS,
                                          n_valid=N_VALID, pool_row=5,
                                          causal=causal)
    else:
        jrows = jnp.asarray(ROWS)
        if interpret:
            got_j = J.fused_attn_block_pooled_dyn(
                jx, jrows, *jln, *jw, heads=HEADS, n_valid=N_VALID,
                causal=causal, interpret=True, group=B)
        else:
            got_j = J._pooled_block_xla_dyn(jx, jrows, *jln, *jw, HEADS,
                                            N_VALID, causal)
        got_t = K.fused_attn_block_pooled_dyn(tx, rows, *tln, *tw,
                                              heads=HEADS, n_valid=N_VALID,
                                              causal=causal)
    return np.asarray(got_j, np.float32), got_t.float().numpy()


KINDS = ["attn", "mlp", "pooled", "dyn"]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_tpu_kernel_bf16(kind, causal):
    """bf16 stream and weights, n_valid < SP, per-example rows for the dyn
    block (causal=True runs the MLP with gelu_tanh)."""
    x, ln, w = _inputs(10 + KINDS.index(kind), mlp=kind == "mlp")
    want, got = _run(kind, causal, x, ln, w, jnp.bfloat16, torch.bfloat16,
                     interpret=True)
    assert got.shape == want.shape
    check = _agree(kind, got, want, torch.from_numpy(x).to(torch.bfloat16))
    assert check["ok"], check


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax_reference_f32(kind, causal):
    x, ln, w = _inputs(20 + KINDS.index(kind), mlp=kind == "mlp")
    want, got = _run(kind, causal, x, ln, w, jnp.float32, torch.float32,
                     interpret=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_f32_stream_with_bf16_weights():
    """The vision tower's working types: an f32 residual stream with bf16
    weights, the output in f32."""
    x, ln, w = _inputs(30)
    tx = torch.from_numpy(x)
    out = K.fused_attn_block(tx, *_torch(ln, torch.float32),
                             *_torch(w, torch.bfloat16), heads=HEADS,
                             n_valid=N_VALID)
    want = J.plain_attn_block(jnp.asarray(x), *_jax(ln, jnp.float32),
                              *_jax(w, jnp.bfloat16), heads=HEADS,
                              n_valid=N_VALID, causal=False)
    assert out.dtype == torch.float32
    check = _agree("attn", out.numpy(), want, tx)
    assert check["ok"], check


def _zero_q(w):
    """wqkv and bqkv with the q columns zeroed: every logit 0, so softmax
    attends uniformly over the unmasked keys."""
    wqkv, bqkv = w[0].copy(), w[1].copy()
    wqkv[:, :D] = 0
    bqkv[:D] = 0
    return (wqkv, bqkv, *w[2:])


@pytest.mark.parametrize("fault", ["logits_zeroed", "block_skipped"])
@pytest.mark.parametrize("kind", KINDS)
def test_increment_check_fails_a_planted_fault(kind, fault):
    """The check the kernels are held to must reject a block that skips its
    work (returns its residual input) or attends uniformly (for the MLP: drops
    its activation)."""
    x, ln, w = _inputs(40 + KINDS.index(kind), mlp=kind == "mlp")
    want = _run(kind, False, x, ln, w, jnp.float32, torch.float32,
                interpret=False)[1]
    if fault == "block_skipped":
        bad = _base(kind, torch.from_numpy(x)).numpy()
    elif kind == "mlp":
        bad = K.plain_mlp_block(*_torch([x], torch.float32),
                                *_torch(ln, torch.float32),
                                *_torch(w, torch.float32), act="none").numpy()
    else:
        bad = _run(kind, False, x, ln, _zero_q(w), jnp.float32,
                   torch.float32, interpret=False)[1]
    assert _agree(kind, want, want, torch.from_numpy(x))["ok"]
    assert not _agree(kind, bad, want, torch.from_numpy(x))["ok"]


def test_cpu_wrappers_launch_no_kernel():
    K.reset_launches()
    x, ln, w = _inputs(31)
    K.fused_attn_block(*_torch([x], torch.float32), *_torch(ln, torch.float32),
                       *_torch(w, torch.float32), heads=HEADS,
                       n_valid=N_VALID)
    assert not any(K.LAUNCHES.values())


def test_supports_fused_block_gate():
    assert K.supports_fused_block(50, 768, 12)     # ViT-B/32 vision
    assert K.supports_fused_block(77, 512, 8)      # CLIP text
    assert K.supports_fused_block(257, 1024, 16)   # ViT-L/14: 257 tokens
    assert K.supports_fused_block(257, 1280, 16)   # ViT-H/14: head_dim 80
    assert not K.supports_fused_block(577, 1024, 16)  # ViT-L/14 at 336 px
    assert not K.supports_fused_block(50, 576, 8)     # head_dim 72

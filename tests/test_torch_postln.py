"""The port's post-LN block ops (wise_tpu_torch/ops/postln_block.py) against
the JAX package's (wise_tpu/ops/postln_block.py).

On the CPU the wrappers compute their plain PyTorch versions. Those are held
to (a) the Pallas TPU kernels run in interpret mode on bf16 inputs
(``interpret=True`` with an explicit ``group``, as tests/test_postln_block.py
runs them): a block's output is a LayerNorm's, so it is compared whole, by
per-token cosine >= 0.999 and max abs error <= 2 bf16 ulps of the output's
max abs (the two round their bf16 GEMM results at different points); and
(b) the JAX plain references in f32 to 1e-5 abs. The key mask km masks a
different tail of each example. The CUDA kernels themselves are held to the
plain versions on the card in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wise_tpu.ops import postln_block as PB
from wise_tpu_torch.ops import postln_block as P

B, SP, D, HEADS, F = 4, 16, 128, 2, 512
KEPT = [16, 9, 1, 12]   # tokens each example keeps; the rest is padding


def _inputs(seed, mlp=False):
    """x ~ N(0, 1); kernels at 1/sqrt(fan_in); biases N(0, 0.02); the
    closing LayerNorm's scale 1 + N(0, 0.25) and bias N(0, 0.25)."""
    rng = np.random.default_rng(seed)

    def w(*s, std=0.02):
        return (std * rng.standard_normal(s)).astype(np.float32)

    x = rng.standard_normal((B, SP, D)).astype(np.float32)
    ln = (1.0 + w(D, std=0.25), w(D, std=0.25))
    f = F if mlp else D
    first = (D, F) if mlp else (D, 3 * D)
    km = np.where(np.arange(SP)[None, None, :] < np.array(KEPT)[:, None, None],
                  0.0, -np.inf).astype(np.float32)
    return x, km, ln, (w(*first, std=D ** -0.5), w(first[1]),
                       w(f, D, std=f ** -0.5), w(D))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype) for a in arrs]


def _np(a):
    return np.asarray(a, np.float32)


def _assert_bf16_agreement(got, want):
    """Whole outputs: per-token cosine >= 0.999, max abs error <= 2 bf16
    ulps of the output's max abs."""
    assert got.shape == want.shape
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                             * np.linalg.norm(w, axis=-1))
    assert cos.min() >= 0.999, cos.min()
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(g - w).max() <= 2 * ulp, (np.abs(g - w).max(), ulp)


def _attn_pair(seed, jdt, tdt, interpret):
    x, km, ln, w = _inputs(seed)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jln, tln = _jax(ln, jnp.float32), _torch(ln, torch.float32)
    jw, tw = _jax(w, jdt), _torch(w, tdt)
    if interpret:
        want = PB.fused_postln_attn_block(jx, jnp.asarray(km), *jln, *jw,
                                          heads=HEADS, interpret=True,
                                          group=2)
    else:
        want = PB.plain_postln_attn_block(jx, jnp.asarray(km), *jln, *jw,
                                          heads=HEADS)
    got = P.fused_postln_attn_block(tx, torch.from_numpy(km), *tln, *tw,
                                    HEADS)
    return _np(want), got.float().numpy()


def _mlp_pair(seed, variant, jdt, tdt, interpret):
    x, _, ln, w = _inputs(seed, mlp=True)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jln, tln = _jax(ln, jnp.float32), _torch(ln, torch.float32)
    jw, tw = _jax(w, jdt), _torch(w, tdt)
    if interpret:
        want = PB.fused_postln_mlp_block(jx, *jln, *jw, act="gelu",
                                         interpret=True, group=2,
                                         variant=variant)
    else:
        want = PB.plain_postln_mlp_block(jx, *jln, *jw, act="gelu")
    got = P.fused_postln_mlp_block(tx, *tln, *tw, "gelu", variant=variant)
    return _np(want), got.float().numpy()


def test_plain_postln_attention_matches_tpu_kernel_bf16():
    want, got = _attn_pair(70, jnp.bfloat16, torch.bfloat16, interpret=True)
    assert np.isfinite(got).all()
    _assert_bf16_agreement(got, want)


def test_plain_postln_attention_matches_jax_reference_f32():
    want, got = _attn_pair(71, jnp.float32, torch.float32, interpret=False)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["single", "split"])
def test_plain_postln_mlp_matches_tpu_kernel_bf16(variant):
    want, got = _mlp_pair(72, variant, jnp.bfloat16, torch.bfloat16,
                          interpret=True)
    _assert_bf16_agreement(got, want)


@pytest.mark.parametrize("variant", ["single", "split"])
def test_plain_postln_mlp_matches_jax_reference_f32(variant):
    want, got = _mlp_pair(73, variant, jnp.float32, torch.float32,
                          interpret=False)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_split_halves_compose_to_the_block():
    """fused_postln_fc then fused_postln_proj is the block, and h is what
    the reference's first kernel writes: act(fc(x)) in x's dtype."""
    x, _, ln, w = _inputs(74, mlp=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tln, tw = _torch(ln, torch.float32), _torch(w, torch.bfloat16)
    h = P.fused_postln_fc(tx, *tw[:2], "gelu")
    assert h.shape == (B, SP, F) and h.dtype == torch.bfloat16
    out = P.fused_postln_proj(h, *tw[2:], tx, *tln)
    want = P.plain_postln_mlp_block(tx, *tln, *tw, "gelu")
    assert torch.equal(out, want)
    assert torch.equal(P.plain_postln_proj(h, *tw[2:], tx, *tln), want)


def test_masked_keys_do_not_reach_the_output():
    """Changing x at an example's padded positions leaves its kept rows as
    they were: km takes those keys out."""
    x, km, ln, w = _inputs(75)
    tln, tw = _torch(ln, torch.float32), _torch(w, torch.float32)
    x2 = x.copy()
    x2[1, KEPT[1]:] += 3.0
    out = [P.plain_postln_attn_block(torch.from_numpy(a),
                                     torch.from_numpy(km), *tln, *tw, HEADS)
           for a in (x, x2)]
    assert torch.allclose(out[0][1, :KEPT[1]], out[1][1, :KEPT[1]],
                          atol=1e-6)
    assert not torch.allclose(out[0][1, KEPT[1]:], out[1][1, KEPT[1]:],
                              atol=1e-3)


def test_a_fully_masked_row_is_nan_as_in_the_reference():
    x, km, ln, w = _inputs(76)
    km[2] = -np.inf
    want = _np(PB.plain_postln_attn_block(
        jnp.asarray(x), jnp.asarray(km), *_jax(ln, jnp.float32),
        *_jax(w, jnp.float32), heads=HEADS))
    got = P.plain_postln_attn_block(
        torch.from_numpy(x), torch.from_numpy(km), *_torch(ln, torch.float32),
        *_torch(w, torch.float32), HEADS).numpy()
    assert np.isnan(want[2]).all() and np.isnan(got[2]).all()
    np.testing.assert_allclose(np.delete(got, 2, 0), np.delete(want, 2, 0),
                               atol=1e-5, rtol=0)


def test_postln_mlp_choice_and_counters():
    assert P.postln_mlp_choice(768) == "single"
    assert P.postln_mlp_choice(1024) == "split"
    assert set(P.LAUNCHES) == {"fused_postln_attn_block",
                               "fused_postln_mlp_block", "fused_postln_fc",
                               "fused_postln_proj"}
    x, _, ln, w = _inputs(77, mlp=True)
    P.reset_launches()
    P.fused_postln_mlp_block(torch.from_numpy(x), *_torch(ln, torch.float32),
                             *_torch(w, torch.float32))
    assert not any(P.LAUNCHES.values())   # a CPU tensor launches nothing
    with pytest.raises(ValueError, match="variant"):
        P.fused_postln_mlp_block(torch.from_numpy(x),
                                 *_torch(ln, torch.float32),
                                 *_torch(w, torch.float32), variant="both")


def test_output_agreement_holds_a_layernorm_output_to_bf16_ulps():
    """The yardstick the card's checks use on a post-LN block's whole output:
    one bf16 ulp off passes, a fifth of a typical value off fails (5% of the
    max would let it by), and the residual sum rounded to bf16 before the
    LayerNorm fails on inputs whose closing bias carries a common offset."""
    from wise_tpu_torch.ops import block as K

    x, _, ln, w = _inputs(78, mlp=True)
    bf = torch.bfloat16
    tx, tln, tw = torch.from_numpy(x).to(bf), _torch(ln, torch.float32), \
        _torch(w, bf)
    want = P.plain_postln_mlp_block(tx, *tln, *tw)
    top = want.float().abs().max().item()
    ulp = K.bf16_ulp(top)
    assert ulp == 2.0 ** (np.floor(np.log2(top)) - 7)
    assert K.output_agreement(want, want)["ok"]
    off = want.float()
    off[0, 0, 0] += ulp
    check = K.output_agreement(off, want)
    assert check["ok"] and check["err_bound"] == K.OUT_ULPS * ulp
    off[0, 0, 0] += 0.2
    assert 0.2 < 0.05 * top and not K.output_agreement(off, want)["ok"]

    tw[3] = (tw[3].float() + 200.0).to(bf)
    want = P.plain_postln_mlp_block(tx, *tln, *tw)
    h = P.plain_postln_fc(tx, *tw[:2])
    res = tx.float() + (h @ tw[2]).float() + tw[3].float()
    bad = K.layer_norm_f32(res.to(bf), *tln).to(bf)
    assert not K.output_agreement(bad, want)["ok"]

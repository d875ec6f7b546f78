"""The port's attention-middle training entry (wise_tpu_torch/ops/
attention.py ``fused_attention_trainable``) against the JAX package's
(wise_tpu/ops/attention.py:222, ``_fat_fwd`` / ``_fat_bwd``).

On the CPU the port's rule runs ``plain_short_attention`` forward (what the
wrapper computes on a CPU tensor) and autograd through it backward; the JAX
side runs its Pallas kernel in interpret mode forward (as
tests/test_fused_attention.py runs it) and ``jax.vjp`` of its masked XLA
attention backward. Cases: keys masked by ``n_valid < SP``, causal, both,
head_dim 80.

Tolerances. bf16: per-tensor gradient cosine >= 0.999 (the bar of
tests/test_torch_block_train.py: the two packages round p and the PV
product's operands at other points). f32: cosine >= 1 - 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.ops import attention as JA
from wise_tpu_torch.ops import attention as A

#: (B, SP, D, heads, n_valid, causal)
CASES = {
    "n_valid": (4, 16, 128, 2, 13, False),
    "causal": (4, 16, 128, 2, 16, True),
    "causal+n_valid": (4, 24, 128, 2, 19, True),
    "head_dim_80": (4, 16, 160, 2, 11, False),
}


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(JA, "fused_short_attention", functools.partial(
        JA.fused_short_attention, interpret=True))


def _qkv(case, seed):
    b, sp, d = CASES[case][:3]
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal((b, sp, d))).astype(np.float32)
            for _ in range(3)]


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_jax(interpret_kernel, case, bf16):
    """Every query row enters the loss, the padded ones too: both packages
    send them the caller's cotangent."""
    b, sp, d, heads, n_valid, causal = CASES[case]
    arrs = _qkv(case, 30)
    w = np.random.default_rng(31).standard_normal((b, sp, d)).astype(
        np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))

    def jloss(q, k, v):
        out = JA.fused_attention_trainable(q, k, v, heads, n_valid, causal)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in arrs))
    ta = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrs]
    out = A.fused_attention_trainable(*ta, heads, n_valid, causal)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), ta)
    for name, g, want_g in zip("qkv", got, want):
        g, want_g = g.float().numpy(), np.asarray(want_g, np.float32)
        assert g.shape == want_g.shape and np.isfinite(g).all(), name
        assert _cos(g, want_g) >= (0.999 if bf16 else 1 - 1e-6), (
            name, _cos(g, want_g))


def test_masked_key_columns_get_no_gradient_and_padded_rows_their_own():
    """Key columns >= n_valid get exactly 0 in k and v; a padded query row
    takes the cotangent it is sent (q's gradient there is not 0), as in the
    reference."""
    b, sp, d, heads, n_valid, _ = CASES["n_valid"]
    ta = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in _qkv("n_valid", 32)]
    out = A.fused_attention_trainable(*ta, heads, n_valid)
    gq, gk, gv = torch.autograd.grad(out.float().square().sum(), ta)
    assert float(gk[:, n_valid:].float().abs().sum()) == 0.0
    assert float(gv[:, n_valid:].float().abs().sum()) == 0.0
    assert float(gq[:, n_valid:].float().abs().max()) > 0.0
    assert float(gk[:, :n_valid].float().abs().max()) > 0.0


def test_rule_is_autograd_through_the_plain_attention():
    """f32 on the CPU: the rule's output is the plain attention's bit for
    bit and its gradients those of autograd through it (1e-6 abs)."""
    b, sp, d, heads, n_valid, causal = CASES["causal+n_valid"]
    ta = [torch.from_numpy(a).requires_grad_()
          for a in _qkv("causal+n_valid", 33)]
    w = torch.randn(b, sp, d, generator=torch.Generator().manual_seed(34))
    out = A.fused_attention_trainable(*ta, heads, n_valid, causal)
    plain = A.plain_short_attention(*ta, heads, n_valid, causal)
    assert torch.equal(out, plain)
    got = torch.autograd.grad((out * w).sum(), ta)
    want = torch.autograd.grad((plain * w).sum(), ta)
    for g, p in zip(got, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-6)


def test_trainable_is_the_serve_wrapper_without_a_gradient(monkeypatch):
    calls = []
    fn = A.fused_short_attention
    monkeypatch.setattr(A, "fused_short_attention", lambda *a, **kw: (
        calls.append(tuple(a[0].shape)), fn(*a, **kw))[1])
    ta = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in _qkv("causal", 35)]
    with torch.no_grad():
        got = A.fused_attention_trainable(*ta, 2, 16, True)
        assert torch.equal(got, fn(*ta, 2, 16, True))
    frozen = [t.detach() for t in ta]
    assert not A.fused_attention_trainable(*frozen, 2, 16).requires_grad
    assert calls == [(4, 16, 128)] * 2
    assert A.fused_attention_trainable(*ta, 2, 16).requires_grad
    assert calls == [(4, 16, 128)] * 3


@pytest.mark.parametrize("fault", ["mask_dropped", "q_zeroed"])
def test_backward_recomputes_with_the_mask_at_the_saved_inputs(monkeypatch,
                                                               fault):
    """A recompute that dropped the mask (n_valid and causal) or ignored the
    saved q would pass a check of the forward alone: each moves the
    gradients."""
    b, sp, d, heads, n_valid, causal = CASES["causal+n_valid"]
    ta = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in _qkv("causal+n_valid", 36)]
    w = torch.randn(b, sp, d, generator=torch.Generator().manual_seed(37))

    def grads():
        out = A.fused_attention_trainable(*ta, heads, n_valid, causal)
        return torch.autograd.grad((out.float() * w).sum(), ta)

    good = grads()
    real = A.plain_short_attention
    bad_fn = {
        "mask_dropped": lambda q, k, v, h, n, c, scale=None: real(
            q, k, v, h, q.shape[1], False),
        "q_zeroed": lambda q, k, v, *a: real(q * 0, k, v, *a)}[fault]
    # the forward on a CPU tensor is the plain version: it keeps the real
    # one, only the backward's recompute sees the fault
    monkeypatch.setattr(A, "fused_short_attention", real)
    monkeypatch.setattr(A, "plain_short_attention", bad_fn)
    bad = grads()
    assert min(_cos(g.float().numpy(), x.float().numpy())
               for g, x in zip(good, bad)) < 0.99

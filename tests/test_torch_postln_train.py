"""The port's post-LN training entries (wise_tpu_torch/ops/postln_block.py
``fused_postln_attn_block_train``, ``fused_postln_mlp_block_train``) against
the JAX package's (wise_tpu/ops/postln_block.py:468, :487).

On the CPU the port's rules run the wrappers' plain versions forward and
autograd through the plain block backward; the JAX side runs its Pallas
kernels in interpret mode forward (as tests/test_postln_block.py runs them)
and ``jax.vjp`` of its plain block backward. The key mask masks a different
tail of each example, one example keeps a single token.

Tolerances. bf16: per-tensor gradient cosine >= 0.999, the bar
tests/test_torch_block_train.py holds the block rules to (the two packages
round the plain blocks' bf16 products at other points). f32: cosine
>= 1 - 1e-6 (the same function; summation order only).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.ops import postln_block as PB
from wise_tpu_torch.ops import postln_block as P

B, SP, D, HEADS, F = 4, 16, 128, 2, 512
KEPT = [16, 9, 1, 12]   # tokens each example keeps; the rest is padding
ATTN = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wo", "bo")
MLP = ("x", "ln_s", "ln_b", "wfc", "bfc", "wproj", "bproj")


@pytest.fixture
def interpret_kernels(monkeypatch):
    """The JAX package's post-LN kernels in interpret mode, two examples a
    program; nothing in the package changes."""
    monkeypatch.setattr(PB, "fused_postln_attn_block", functools.partial(
        PB.fused_postln_attn_block, interpret=True, group=2))
    monkeypatch.setattr(PB, "fused_postln_mlp_block", functools.partial(
        PB.fused_postln_mlp_block, interpret=True, group=2))


def _km(kept):
    return np.where(np.arange(SP)[None, None, :]
                    < np.array(kept)[:, None, None], 0.0,
                    -np.inf).astype(np.float32)


def _inputs(seed, mlp=False):
    """x ~ N(0, 1); kernels at 1/sqrt(fan_in); biases N(0, 0.02); the
    closing LayerNorm's scale 1 + N(0, 0.25) and bias N(0, 0.25)."""
    rng = np.random.default_rng(seed)

    def w(*s, std=0.02):
        return (std * rng.standard_normal(s)).astype(np.float32)

    x = rng.standard_normal((B, SP, D)).astype(np.float32)
    first = (D, F) if mlp else (D, 3 * D)
    f = F if mlp else D
    return [x, 1.0 + w(D, std=0.25), w(D, std=0.25),
            w(*first, std=D ** -0.5), w(first[1]), w(f, D, std=f ** -0.5),
            w(D)]


def _both(arrs, bf16=True):
    """(jax arrays, torch leaves): x and the weights in bf16 (or all f32),
    LayerNorm parameters f32."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    jk = [jdt, jnp.float32, jnp.float32] + [jdt] * 4
    tk = [tdt, torch.float32, torch.float32] + [tdt] * 4
    return ([jnp.asarray(a, k) for a, k in zip(arrs, jk)],
            [torch.from_numpy(a).to(k).requires_grad_()
             for a, k in zip(arrs, tk)])


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _assert_grads(names, got, want, bar):
    for name, g, w in zip(names, got, want):
        g, w = g.detach().float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        assert np.all(np.isfinite(g)), name
        assert _cos(g, w) >= bar, (name, _cos(g, w))


def _weight(seed):
    return np.random.default_rng(seed).standard_normal(
        (B, SP, D)).astype(np.float32)


@pytest.mark.parametrize("bf16", [True, False])
def test_attn_train_grads_match_jax(interpret_kernels, bf16):
    """Every row enters the loss, the padded ones too: a padded query row
    attends to its example's real keys in both packages."""
    ja, ta = _both(_inputs(10), bf16)
    km = _km(KEPT)
    w = _weight(11)

    def jloss(x, *ts):
        out = PB.fused_postln_attn_block_train(x, jnp.asarray(km), *ts,
                                               HEADS)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*ja)
    out = P.fused_postln_attn_block_train(ta[0], torch.from_numpy(km),
                                          *ta[1:], HEADS)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), ta)
    _assert_grads(ATTN, got, want, 0.999 if bf16 else 1 - 1e-6)


@pytest.mark.parametrize("variant", ["single", "split"])
@pytest.mark.parametrize("bf16", [True, False])
def test_mlp_train_grads_match_jax(monkeypatch, bf16, variant):
    """The JAX forward as either of its kernels: the backward is one rule."""
    monkeypatch.setattr(PB, "fused_postln_mlp_block", functools.partial(
        PB.fused_postln_mlp_block, interpret=True, group=2, variant=variant))
    ja, ta = _both(_inputs(12, mlp=True), bf16)
    w = _weight(13)

    def jloss(*ts):
        out = PB.fused_postln_mlp_block_train(*ts, "gelu")
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*ja)
    out = P.fused_postln_mlp_block_train(*ta, "gelu")
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), ta)
    _assert_grads(MLP, got, want, 0.999 if bf16 else 1 - 1e-6)


def test_rules_are_autograd_through_the_plain_blocks():
    """In f32 on the CPU the rules' gradients are those of autograd through
    the plain blocks, to rounding (cosine >= 1 - 1e-9 and 1e-5 abs), and
    their outputs the plain blocks' bit for bit."""
    _, ta = _both(_inputs(14), bf16=False)
    km = torch.from_numpy(_km(KEPT))
    w = torch.from_numpy(_weight(15))
    out = P.fused_postln_attn_block_train(ta[0], km, *ta[1:], HEADS)
    plain = P.plain_postln_attn_block(ta[0], km, *ta[1:], HEADS)
    assert torch.equal(out, plain)
    got = torch.autograd.grad((out * w).sum(), ta)
    want = torch.autograd.grad((plain * w).sum(), ta)
    for name, g, p in zip(ATTN, got, want):
        assert _cos(g.numpy(), p.numpy()) >= 1 - 1e-9, name
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5,
                                   err_msg=name)
    _, tm = _both(_inputs(16, mlp=True), bf16=False)
    out = P.fused_postln_mlp_block_train(*tm)
    plain = P.plain_postln_mlp_block(*tm)
    assert torch.equal(out, plain)
    got = torch.autograd.grad((out * w).sum(), tm)
    want = torch.autograd.grad((plain * w).sum(), tm)
    for name, g, p in zip(MLP, got, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5,
                                   err_msg=name)


def test_key_mask_gets_no_gradient_and_masked_keys_send_none_back():
    """km, even when it requires a gradient, gets none; the -inf keys give
    finite gradients on every example with a real key, and the keys they
    mask receive nothing: x's gradient at a masked position is the one its
    own query row sends, so with the cotangent zeroed on the padded rows it
    is exactly 0 there."""
    _, ta = _both(_inputs(17))
    km = torch.from_numpy(_km(KEPT)).requires_grad_()
    w = torch.from_numpy(_weight(18))
    for i, kept in enumerate(KEPT):
        w[i, kept:] = 0
    out = P.fused_postln_attn_block_train(ta[0], km, *ta[1:], HEADS)
    grads = torch.autograd.grad((out.float() * w).sum(), [*ta, km],
                                allow_unused=True)
    assert grads[-1] is None
    assert all(bool(g.float().isfinite().all()) for g in grads[:-1])
    gx = grads[0].float()
    for i, kept in enumerate(KEPT):
        assert float(gx[i, kept:].abs().sum()) == 0.0, i
        assert float(gx[i, :kept].abs().max()) > 0.0, i


def test_a_fully_masked_row_stays_nan():
    """A softmax over nothing: the example whose keys are all masked comes
    out NaN through the rule as through the serve wrapper; the others stay
    finite, and so do their inputs' gradients."""
    _, ta = _both(_inputs(19))
    km = torch.from_numpy(_km([16, 0, 5, 9]))
    out = P.fused_postln_attn_block_train(ta[0], km, *ta[1:], HEADS)
    with torch.no_grad():
        serve = P.fused_postln_attn_block(ta[0], km, *ta[1:], HEADS)
    assert bool(out[1].isnan().all()) and bool(serve[1].isnan().all())
    keep = [0, 2, 3]
    assert bool(out[keep].isfinite().all())
    gx, = torch.autograd.grad(out[keep].float().sum(), ta[0])
    assert bool(gx[keep].float().isfinite().all())


def test_train_functions_are_the_serve_wrappers_without_a_gradient(
        monkeypatch):
    """No input requires a gradient, or autograd is off: the serve wrapper
    runs, with the same output; under a gradient the rule's forward calls
    the same wrapper once."""
    calls = []
    for name in ("fused_postln_attn_block", "fused_postln_mlp_block"):
        fn = getattr(P, name)
        monkeypatch.setattr(P, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    _, ta = _both(_inputs(20))
    _, tm = _both(_inputs(21, mlp=True))
    km = torch.from_numpy(_km(KEPT))
    with torch.no_grad():
        a = P.fused_postln_attn_block_train(ta[0], km, *ta[1:], HEADS)
        m = P.fused_postln_mlp_block_train(*tm)
        assert torch.equal(a, P.fused_postln_attn_block(ta[0], km, *ta[1:],
                                                        HEADS))
        assert torch.equal(m, P.fused_postln_mlp_block(*tm))
    frozen = [t.detach() for t in tm]
    assert not P.fused_postln_mlp_block_train(*frozen).requires_grad
    assert calls == ["fused_postln_attn_block", "fused_postln_mlp_block",
                     "fused_postln_attn_block", "fused_postln_mlp_block",
                     "fused_postln_mlp_block"]
    calls.clear()
    assert P.fused_postln_attn_block_train(ta[0], km, *ta[1:],
                                           HEADS).requires_grad
    assert P.fused_postln_mlp_block_train(*tm).requires_grad
    assert calls == ["fused_postln_attn_block", "fused_postln_mlp_block"]


def test_backward_recomputes_at_the_saved_inputs(monkeypatch):
    """A backward that ignored the saved x (the recompute at zeros) or the
    key mask (the recompute unmasked) would go unnoticed by a check of the
    output alone: each moves the gradients."""
    _, ta = _both(_inputs(22))
    km = torch.from_numpy(_km(KEPT))
    w = torch.from_numpy(_weight(23))

    def grads():
        out = P.fused_postln_attn_block_train(ta[0], km, *ta[1:], HEADS)
        return torch.autograd.grad((out.float() * w).sum(), ta)

    good = grads()
    real = P.plain_postln_attn_block
    faults = {
        "x_zeroed": lambda x, km_, *a: real(x * 0, km_, *a),
        "mask_dropped": lambda x, km_, *a: real(x, torch.zeros_like(km_),
                                                *a)}
    for name, fault in faults.items():
        # the forward is the serve wrapper, which on the CPU computes the
        # plain block: only the backward's recompute may see the fault
        monkeypatch.setattr(P, "fused_postln_attn_block", real)
        monkeypatch.setattr(P, "plain_postln_attn_block", fault)
        bad = grads()
        monkeypatch.undo()
        assert min(_cos(g.float().numpy(), b.float().numpy())
                   for g, b in zip(good, bad)) < 0.99, name

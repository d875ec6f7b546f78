"""The port's training forwards and autograd rules (wise_tpu_torch/ops/
block.py ``*_res``, ``*_train``) against the JAX package's.

On the CPU the ``*_res`` wrappers compute their plain versions and the
``*_train`` Functions run them in their forward, so what is held here is the
arithmetic around the kernels: the stage functions, the cut-point backward,
the cotangent zeroed at padded rows, the recompute backward of the pooled
blocks. The JAX side runs its Pallas kernels in interpret mode, as
tests/test_block_train.py does.

Tolerances. Outputs: ``increment_agreement`` (per-token cosine >= 0.999 and
max error <= 5% of the increment's max, the bar of tests/test_torch_block.py:
bf16 rounding points differ between the two packages). Residuals: whole
output, cosine >= 0.999 and 4 bf16 ulps (``output_agreement``). Gradients:
per-tensor cosine >= 0.999, the bar tests/test_block_train.py holds the JAX
rules to against their own plain references. In f32 the same gradients agree
to 1 - 1e-6: the rules are the same function, and bf16 is the only looseness.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.ops import block as J
from wise_tpu_torch.ops import block as K

B, SP, D, HEADS, N_VALID = 8, 16, 256, 4, 13
ROWS = np.array([0, 5, 12, 3, 1, 9, 12, 7], np.int32)
ATTN = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wo", "bo")
MLP = ("x", "ln_s", "ln_b", "wfc", "bfc", "wproj", "bproj")


@pytest.fixture
def interpret_kernels(monkeypatch):
    """The JAX package's kernels in interpret mode (what its own tests do on
    the CPU); nothing in the package changes."""
    for name in ("fused_attn_block", "fused_mlp_block", "fused_mlp_split",
                 "fused_attn_block_pooled", "fused_attn_block_pooled_dyn",
                 "fused_attn_block_res", "fused_mlp_block_res",
                 "fused_mlp_split_res"):
        monkeypatch.setattr(J, name, functools.partial(getattr(J, name),
                                                       interpret=True))


def _inputs(seed, mlp=False):
    """x ~ N(0, 1); kernels at 1/sqrt(fan_in); biases and LayerNorm offsets
    N(0, 0.02); numpy f32, the same arrays for both packages."""
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    x = rng.standard_normal((B, SP, D)).astype(np.float32)
    f = 4 * D if mlp else D
    first = (D, 4 * D) if mlp else (D, 3 * D)
    return [x, 1.0 + w(D), w(D), w(*first, std=D ** -0.5), w(first[1]),
            w(f, D, std=f ** -0.5), w(D)]


def _both(arrs, bf16=True):
    """(jax arrays, torch leaves): x and the weights in bf16 (or all f32),
    LayerNorm parameters f32."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    kinds = [jdt, jnp.float32, jnp.float32] + [jdt] * 4
    tkinds = [tdt, torch.float32, torch.float32] + [tdt] * 4
    ja = [jnp.asarray(a, k) for a, k in zip(arrs, kinds)]
    ta = [torch.from_numpy(a).to(k).requires_grad_()
          for a, k in zip(arrs, tkinds)]
    return ja, ta


def _np(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _assert_grads(names, got, want, bar=0.999):
    for name, g, w in zip(names, got, want):
        g, w = g.detach().float().numpy(), _np(w)
        assert g.shape == w.shape, name
        assert np.all(np.isfinite(g)), name
        assert _cos(g, w) > bar, (name, _cos(g, w))


# ---------------------------------------------------------------------------
# (a) the *_res forwards: output and residual
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_res_matches_the_pallas_kernel(causal):
    ja, ta = _both(_inputs(0))
    want, want_qkv = J.fused_attn_block_res(
        *ja, HEADS, N_VALID, causal, interpret=True)
    with torch.no_grad():
        got, got_qkv = K.fused_attn_block_res(*ta, HEADS, N_VALID, causal)
    assert got_qkv.shape == (B, SP, 3 * D) and got_qkv.dtype == torch.bfloat16
    # rows >= n_valid of the kernel's output are undefined by contract
    out = K.increment_agreement(got[:, :N_VALID],
                                torch.from_numpy(_np(want))[:, :N_VALID],
                                ta[0].detach()[:, :N_VALID])
    assert out["ok"], out
    res = K.output_agreement(got_qkv, torch.from_numpy(_np(want_qkv)))
    assert res["ok"], res


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("name", ["fused_mlp_block_res",
                                  "fused_mlp_split_res"])
def test_mlp_res_matches_the_pallas_kernels(name, act):
    ja, ta = _both(_inputs(1, mlp=True))
    want, want_h = getattr(J, name)(*ja, act, interpret=True)
    with torch.no_grad():
        got, got_h = getattr(K, name)(*ta, act)
    assert got_h.shape == (B, SP, 4 * D) and got_h.dtype == torch.bfloat16
    out = K.increment_agreement(got, torch.from_numpy(_np(want)),
                                ta[0].detach())
    assert out["ok"], out
    res = K.output_agreement(got_h, torch.from_numpy(_np(want_h)))
    assert res["ok"], res


def test_res_wrappers_keep_the_serve_output_and_save_the_pre_activation():
    """Each ``*_res`` output is its serve twin's, bit for bit; the MLP's
    residual is the value before the activation (a residual written after it
    would be fused_mlp_fc's h); the fc half alone returns (h, h_pre)."""
    with torch.no_grad():
        _, ta = _both(_inputs(2))
        out, qkv = K.fused_attn_block_res(*ta, HEADS, N_VALID, True)
        assert torch.equal(out, K.fused_attn_block(*ta, HEADS, N_VALID, True))
        assert torch.equal(qkv, K.qkv_stage(*ta[:5]))
        _, ta = _both(_inputs(3, mlp=True))
        for res, serve in ((K.fused_mlp_block_res, K.fused_mlp_block),
                           (K.fused_mlp_split_res, K.fused_mlp_split)):
            out, h_pre = res(*ta, "gelu")
            assert torch.equal(out, serve(*ta, "gelu"))
            assert torch.equal(h_pre, K.fc_stage(*ta[:5]))
        h, h_pre = K.fused_mlp_fc_res(*ta[:5], "gelu")
        assert torch.equal(h, K.fused_mlp_fc(*ta[:5], "gelu"))
        assert torch.equal(h, K.activation(h_pre.float(), "gelu").to(h.dtype))
        assert not torch.equal(h, h_pre)


# ---------------------------------------------------------------------------
# (b) the five autograd rules against jax.grad through the JAX wrappers
# ---------------------------------------------------------------------------


def _weights(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_train_grads_match_jax(interpret_kernels, causal):
    ja, ta = _both(_inputs(10))
    w = _weights((B, SP, D), 11)

    def jloss(*ts):
        out = J.fused_attn_block_train(*ts, HEADS, N_VALID, causal)
        return jnp.sum(out[:, :N_VALID].astype(jnp.float32) * w[:, :N_VALID])

    want = jax.grad(jloss, argnums=tuple(range(7)))(*ja)
    out = K.fused_attn_block_train(*ta, HEADS, N_VALID, causal)
    loss = (out[:, :N_VALID].float() * torch.from_numpy(w)[:, :N_VALID]).sum()
    _assert_grads(ATTN, torch.autograd.grad(loss, ta), want)


def test_attn_block_train_zeroes_the_cotangent_at_padded_rows(
        interpret_kernels):
    """n_valid < SP and a loss that reads the padded rows: both packages
    zero the cotangent there, so the gradients still agree, and differ from
    those of the plain block, which defines those rows."""
    ja, ta = _both(_inputs(12))
    w = _weights((B, SP, D), 13)

    def jloss(*ts):
        out = J.fused_attn_block_train(*ts, HEADS, N_VALID, False)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*ja)
    out = K.fused_attn_block_train(*ta, HEADS, N_VALID, False)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), ta)
    _assert_grads(ATTN, got, want)
    plain = K.plain_attn_block(*ta, HEADS, N_VALID, False)
    unzeroed = torch.autograd.grad(
        (plain.float() * torch.from_numpy(w)).sum(), ta)
    # x's gradient at the padded rows: nothing from the train rule (the
    # padded keys are masked and the cotangent is zero), w from the plain one
    assert float(got[0][:, N_VALID:].abs().max()) == 0.0
    assert float(unzeroed[0][:, N_VALID:].float().abs().max()) > 0.1


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("name", ["fused_mlp_block_train",
                                  "fused_mlp_split_train"])
def test_mlp_train_grads_match_jax(interpret_kernels, name, act):
    ja, ta = _both(_inputs(14, mlp=True))
    w = _weights((B, SP, D), 15)

    def jloss(*ts):
        return jnp.sum(getattr(J, name)(*ts, act).astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*ja)
    out = getattr(K, name)(*ta, act)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), ta)
    _assert_grads(MLP, got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_pooled_train_grads_match_jax(interpret_kernels, causal):
    ja, ta = _both(_inputs(16))
    w = _weights((B, D), 17)

    def jloss(*ts):
        out = J.fused_attn_block_pooled_train(*ts, HEADS, N_VALID, 5, causal)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*ja)
    out = K.fused_attn_block_pooled_train(*ta, HEADS, N_VALID, 5, causal)
    assert out.shape == (B, D)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), ta)
    _assert_grads(ATTN, got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_pooled_dyn_train_grads_match_jax(interpret_kernels, causal):
    ja, ta = _both(_inputs(18))
    w = _weights((B, D), 19)

    def jloss(x, *ts):
        out = J.fused_attn_block_pooled_dyn_train(
            x, jnp.asarray(ROWS), *ts, HEADS, N_VALID, causal)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*ja)
    rows = torch.from_numpy(ROWS)
    out = K.fused_attn_block_pooled_dyn_train(ta[0], rows, *ta[1:], HEADS,
                                              N_VALID, causal)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), ta)
    _assert_grads(ATTN, got, want)


def test_f32_rules_are_the_same_function(interpret_kernels):
    """With f32 weights nothing rounds, and the cut-point rules of the two
    packages agree to accumulation order (cosine > 1 - 1e-6): bf16 is the
    only looseness in the tests above."""
    w = _weights((B, SP, D), 21)
    ja, ta = _both(_inputs(20), bf16=False)
    want = jax.grad(lambda *ts: jnp.sum(J.fused_attn_block_train(
        *ts, HEADS, N_VALID, True)[:, :N_VALID] * w[:, :N_VALID]),
        argnums=tuple(range(7)))(*ja)
    out = K.fused_attn_block_train(*ta, HEADS, N_VALID, True)
    got = torch.autograd.grad(
        (out[:, :N_VALID] * torch.from_numpy(w)[:, :N_VALID]).sum(), ta)
    _assert_grads(ATTN, got, want, bar=1 - 1e-6)
    ja, ta = _both(_inputs(22, mlp=True), bf16=False)
    want = jax.grad(lambda *ts: jnp.sum(J.fused_mlp_block_train(
        *ts, "gelu") * w), argnums=tuple(range(7)))(*ja)
    got = torch.autograd.grad(
        (K.fused_mlp_block_train(*ta, "gelu") * torch.from_numpy(w)).sum(),
        ta)
    _assert_grads(MLP, got, want, bar=1 - 1e-6)


# ---------------------------------------------------------------------------
# the rules' own contracts
# ---------------------------------------------------------------------------


def test_train_functions_are_the_serve_wrappers_without_a_gradient(
        monkeypatch):
    """No input requires a gradient, or autograd is off: the serve wrapper
    runs and no residual is made."""
    calls = []
    for name in ("fused_attn_block", "fused_attn_block_res",
                 "fused_mlp_block", "fused_mlp_block_res", "fused_mlp_split",
                 "fused_mlp_split_res"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    _, ta = _both(_inputs(30))
    _, tm = _both(_inputs(31, mlp=True))
    with torch.no_grad():
        K.fused_attn_block_train(*ta, HEADS, N_VALID)
        K.fused_mlp_block_train(*tm)
        K.fused_mlp_split_train(*tm)
    frozen = [t.detach() for t in ta]
    assert not K.fused_attn_block_train(*frozen, HEADS, N_VALID).requires_grad
    assert calls == ["fused_attn_block", "fused_mlp_block",
                     "fused_mlp_split", "fused_attn_block"]
    calls.clear()
    assert K.fused_attn_block_train(*ta, HEADS, N_VALID).requires_grad
    assert K.fused_mlp_block_train(*tm).requires_grad
    assert K.fused_mlp_split_train(*tm).requires_grad
    assert calls == ["fused_attn_block_res", "fused_mlp_block_res",
                     "fused_mlp_split_res"]


def test_backward_uses_the_saved_residual(monkeypatch):
    """A backward that ignored the residual would not notice it changing:
    with the saved qkv (or h_pre) replaced by zeros the gradients move."""
    _, ta = _both(_inputs(32))
    w = torch.from_numpy(_weights((B, SP, D), 33))
    good = torch.autograd.grad(
        (K.fused_attn_block_train(*ta, HEADS, SP).float() * w).sum(), ta)
    real = K.fused_attn_block_res
    monkeypatch.setattr(K, "fused_attn_block_res", lambda *a, **kw: (
        lambda out, qkv: (out, torch.zeros_like(qkv)))(*real(*a, **kw)))
    bad = torch.autograd.grad(
        (K.fused_attn_block_train(*ta, HEADS, SP).float() * w).sum(), ta)
    assert _cos(good[3].float().numpy(), bad[3].float().numpy()) < 0.9


@pytest.mark.parametrize("causal", [False, True])
def test_rules_compose_with_checkpointing(causal):
    """torch.utils.checkpoint around a rule (``remat``): the forward runs
    again in the backward and the gradients stay those of the plain block."""
    from torch.utils.checkpoint import checkpoint

    _, ta = _both(_inputs(34))
    w = torch.from_numpy(_weights((B, SP, D), 35))
    out = checkpoint(lambda *ts: K.fused_attn_block_train(
        *ts, HEADS, SP, causal), *ta, use_reentrant=False)
    got = torch.autograd.grad((out.float() * w).sum(), ta)
    plain = K.plain_attn_block(*ta, HEADS, SP, causal)
    want = torch.autograd.grad((plain.float() * w).sum(), ta)
    for name, g, p in zip(ATTN, got, want):
        assert _cos(g.float().numpy(), p.float().numpy()) > 0.9999, name


def test_wrappers_refuse_a_gradient_on_the_card(monkeypatch):
    """``refuse_grad`` is what every kernel wrapper calls before it launches
    on CUDA tensors: it raises when autograd is on and an input requires a
    gradient, and names what differentiates."""
    from wise_tpu_torch.ops.build import refuse_grad

    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="cut from the autograd graph"):
        refuse_grad("fused_attn_block", (x, None), "call the _train rule")
    with torch.no_grad():
        refuse_grad("fused_attn_block", (x,), "")
    refuse_grad("fused_attn_block", (x.detach(), None), "")

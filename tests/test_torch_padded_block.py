"""The port's padded-head attention block (wise_tpu_torch/ops/block.py
``fused_ln_matmul``, ``fused_residual_matmul``, ``_pad_head_weights``,
``fused_attn_block_padded``, its gate and its training rule) against the
JAX package's (wise_tpu/ops/block.py:1255-1450, :1931).

On the CPU each wrapper computes its plain version. The JAX side runs its
Pallas kernels in interpret mode with ``group=1`` (``groups=(1, 1)`` for the
block), as tests/test_block_kernels.py does.

Tolerances. ``fused_ln_matmul`` has no residual under its output and is
held whole (``output_agreement``: per-token cosine >= 0.999, max abs error
<= 4 bf16 ulps of the reference's max abs): the port rounds LN(x) to bf16
for the product, the interpret-mode kernel keeps it in x's dtype.
``fused_residual_matmul`` and the block are held on their increment over x
(``increment_agreement``: cosine >= 0.999, max error <= 5% of the
increment's max), at rows < n_valid for the block. ``_pad_head_weights`` is
exact. Gradients of the training rule: per-tensor cosine >= 0.999, the bar
tests/test_block_train.py holds the JAX rule to. A tiny head_dim-80 tower
with the gate opened against the JAX package's XLA tower on one parameter
tree: embedding cosine >= 0.999, the bar of tests/test_fused_block_model.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.models.clip import model as JM
from wise_tpu.models.clip.extractor import production_clip_config as j_prod
from wise_tpu.ops import block as J
from wise_tpu_torch.models.clip import model as TM
from wise_tpu_torch.models.clip.config import production_clip_config as t_prod
from wise_tpu_torch.models.clip.convert import from_flax_params
from wise_tpu_torch.ops import block as K

#: tests/test_block_kernels.py:378's shape: head_dim 80
B, SP, D, HEADS, N_VALID = 4, 16, 160, 2, 13
OW = 256
#: x's dtype in each package
STREAMS = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}
NAMES = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wo", "bo")


def _to_bf16(a):
    """numpy f32 -> the bf16 value both packages see, as f32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _pair(a, stream):
    """One numpy array as a torch tensor and a jax array of the stream's
    dtype."""
    tdt, jdt = STREAMS[stream]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _np(t):
    """A jax array as a writable numpy f32 array."""
    return np.array(jnp.asarray(t, jnp.float32))


def _block_inputs(seed=20):
    """x ~ N(0, 1) in bf16 values; kernels at 1/sqrt(fan_in), biases and
    LayerNorm offsets N(0, 0.02); weights rounded to bf16."""
    rng = np.random.default_rng(seed)
    x = _to_bf16(rng.standard_normal((B, SP, D)).astype(np.float32))
    ln_s = (1.0 + 0.02 * rng.standard_normal(D)).astype(np.float32)
    ln_b = (0.02 * rng.standard_normal(D)).astype(np.float32)
    wqkv = _to_bf16(rng.standard_normal((D, 3 * D)) * D ** -0.5)
    bqkv = _to_bf16(0.02 * rng.standard_normal(3 * D))
    wo = _to_bf16(rng.standard_normal((D, D)) * D ** -0.5)
    bo = _to_bf16(0.02 * rng.standard_normal(D))
    return x, ln_s, ln_b, wqkv, bqkv, wo, bo


def _torch_args(arrays):
    x, ln_s, ln_b, *w = arrays
    return ([torch.from_numpy(x), torch.from_numpy(ln_s),
             torch.from_numpy(ln_b)]
            + [torch.from_numpy(a).to(torch.bfloat16) for a in w])


def _jax_args(arrays, x_dtype=jnp.bfloat16):
    x, ln_s, ln_b, *w = arrays
    return ([jnp.asarray(x, x_dtype), jnp.asarray(ln_s), jnp.asarray(ln_b)]
            + [jnp.asarray(a, jnp.bfloat16) for a in w])


@pytest.mark.parametrize("act", ["none", "gelu"])
@pytest.mark.parametrize("stream", list(STREAMS))
def test_ln_matmul_matches_tpu_kernel(stream, act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, SP, D)).astype(np.float32)
    ln_s = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    w = _to_bf16(rng.standard_normal((D, OW)) * D ** -0.5)
    b = _to_bf16(0.02 * rng.standard_normal(OW))
    tx, jx = _pair(x, stream)
    want = J.fused_ln_matmul(
        jx, jnp.asarray(ln_s), jnp.asarray(ln_b), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), act=act, interpret=True, group=1)
    got = K.fused_ln_matmul(tx, torch.from_numpy(ln_s),
                            torch.from_numpy(ln_b),
                            torch.from_numpy(w).bfloat16(),
                            torch.from_numpy(b).bfloat16(), act)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    check = K.output_agreement(got, torch.from_numpy(_np(want)))
    assert check["ok"], check


@pytest.mark.parametrize("stream", list(STREAMS))
def test_residual_matmul_matches_tpu_kernel(stream):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, SP, D)).astype(np.float32)
    h = _to_bf16(rng.standard_normal((B, SP, OW)))
    w = _to_bf16(rng.standard_normal((OW, D)) * OW ** -0.5)
    b = _to_bf16(0.02 * rng.standard_normal(D))
    tx, jx = _pair(x, stream)
    want = J.fused_residual_matmul(
        jx, jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), interpret=True, group=1)
    got = K.fused_residual_matmul(tx, torch.from_numpy(h).bfloat16(),
                                  torch.from_numpy(w).bfloat16(),
                                  torch.from_numpy(b).bfloat16())
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    check = K.increment_agreement(got, torch.from_numpy(_np(want)), tx)
    assert check["ok"], check


def test_pad_head_weights_match_exactly():
    _, _, _, wqkv, bqkv, wo, _ = _block_inputs(5)
    hd = D // HEADS
    want = J._pad_head_weights(jnp.asarray(wqkv, jnp.bfloat16),
                               jnp.asarray(bqkv, jnp.bfloat16),
                               jnp.asarray(wo, jnp.bfloat16), HEADS, hd, 128)
    got = K._pad_head_weights(torch.from_numpy(wqkv).bfloat16(),
                              torch.from_numpy(bqkv).bfloat16(),
                              torch.from_numpy(wo).bfloat16(), HEADS, hd, 128)
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = [t for pair in got[:3] for t in pair] + [got[3]]
    assert len(flat_w) == len(flat_g) == 7
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(), _np(w))
    assert flat_g[0].shape == (D, HEADS * 128)
    assert not flat_g[0].reshape(D, HEADS, 128)[..., hd:].any()
    assert not flat_g[-1].reshape(HEADS, 128, D)[:, hd:].any()


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_padded_matches_tpu_chain(causal, stream):
    arrays = _block_inputs()
    tdt, jdt = STREAMS[stream]
    targs = _torch_args(arrays)
    targs[0] = targs[0].to(tdt)
    want = J.fused_attn_block_padded(
        *_jax_args(arrays, jdt), heads=HEADS, n_valid=N_VALID, causal=causal,
        interpret=True, groups=(1, 1))
    got = K.fused_attn_block_padded(*targs, HEADS, N_VALID, causal)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    v = slice(0, N_VALID)
    check = K.increment_agreement(got[:, v], torch.from_numpy(_np(want))[:, v],
                                  targs[0][:, v])
    assert check["ok"], check
    # and the function is the attention block's: the padding is invisible
    plain = K.plain_attn_block(*targs, HEADS, N_VALID, causal)
    check = K.increment_agreement(got[:, v], plain[:, v], targs[0][:, v])
    assert check["ok"], check


def test_padded_gate_requires_calibration():
    """tests/test_block_kernels.py:396-418's truth table on the port's gate:
    closed while the table is empty; opened for a calibrated head_dim-80
    shape; never for head_dim 64 or 128, or a sequence the attention
    kernel does not take. The reference's table is empty too."""
    assert J._CALIBRATED_PAD == {} and K._CALIBRATED_PAD == set()
    assert not K.supports_fused_block_padded(257, 1280, 16)
    assert not K.supports_fused_block_padded(264, 1280, 16)
    try:
        K._CALIBRATED_PAD.update({(257, 1280), (56, 768), (257, 2048),
                                  (700, 1280)})
        assert K.supports_fused_block_padded(257, 1280, 16)
        assert not K.supports_fused_block_padded(257, 1024, 16)  # not in it
        assert not K.supports_fused_block_padded(56, 768, 12)    # head_dim 64
        assert not K.supports_fused_block_padded(257, 2048, 16)  # 128
        assert not K.supports_fused_block_padded(257, 1280, 0)
        assert not K.supports_fused_block_padded(700, 1280, 16)  # > MAX_SEQ
    finally:
        K._CALIBRATED_PAD.clear()
    # the JAX gate stays closed on the CPU whatever its table says
    assert not J.supports_fused_block_padded(128, 264, 1280, 16,
                                             jnp.bfloat16)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("causal", [False, True])
def test_padded_train_rule_grads_match_jax(monkeypatch, causal):
    """tests/test_block_train.py:352 on both packages: the gradients of a
    seeded loss on the valid rows through fused_attn_block_padded_train."""
    monkeypatch.setattr(J, "fused_attn_block_padded", functools.partial(
        J.fused_attn_block_padded, interpret=True, groups=(1, 1)))
    arrays = _block_inputs(21)
    weight = np.random.default_rng(27).standard_normal(
        (B, SP, D)).astype(np.float32)

    def jloss(*a):
        out = J.fused_attn_block_padded_train(*a, HEADS, N_VALID, causal)
        return jnp.sum(out[:, :N_VALID].astype(jnp.float32)
                       * weight[:, :N_VALID])

    want = jax.grad(jloss, argnums=tuple(range(7)))(*_jax_args(arrays))
    targs = [t.requires_grad_() for t in _torch_args(arrays)]
    targs[0] = targs[0].detach().bfloat16().requires_grad_()
    out = K.fused_attn_block_padded_train(*targs, HEADS, N_VALID, causal)
    loss = (out[:, :N_VALID].float()
            * torch.from_numpy(weight[:, :N_VALID])).sum()
    got = torch.autograd.grad(loss, targs)
    for n, g, w in zip(NAMES, got, want):
        assert g.dtype == targs[NAMES.index(n)].dtype, n
        assert np.isfinite(g.float().numpy()).all(), n
        assert _cos(g.float().numpy(), _np(w)) >= 0.999, n


def test_padded_train_rule_is_the_serve_block_without_a_gradient():
    targs = _torch_args(_block_inputs(22))
    with torch.no_grad():
        got = K.fused_attn_block_padded_train(*targs, HEADS, N_VALID)
    want = K.fused_attn_block_padded(*targs, HEADS, N_VALID)
    assert torch.equal(got, want)


TINY_H = dict(embed_dim=64, image_size=32, patch_size=8, vision_width=160,
              vision_heads=2, vision_layers=2, context_length=16,
              vocab_size=4096, text_width=128, text_heads=2, text_layers=2)


@pytest.fixture
def open_padded_gate(monkeypatch):
    """The port's counterpart of tests/test_fused_block_model.py's
    ``force_fused_block_padded``: the tiny tower's vision shape (17 tokens x
    160) enters the padded table and leaves the monolithic block's, for
    this test alone; every call of the padded rule is recorded."""
    calls = []
    real_rule, real_gate = (K.fused_attn_block_padded_train,
                            K.supports_fused_block)

    def rule(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real_rule(*a, **kw)

    monkeypatch.setattr(K, "fused_attn_block_padded_train", rule)
    monkeypatch.setattr(K, "supports_fused_block", lambda s, w, h: (
        (s, w) != (17, 160) and real_gate(s, w, h)))
    monkeypatch.setattr(K, "_CALIBRATED_PAD", {(17, 160)})
    return calls


@pytest.mark.parametrize("pool_last", [True, False])
def test_head_dim_80_tower_on_the_padded_block_matches_jax(
        monkeypatch, open_padded_gate, pool_last):
    """tests/test_fused_block_model.py:370 for the port: the bf16
    production tower at head_dim 80 takes the padded-head block in every
    full vision layer and agrees with the JAX package's XLA tower (its
    gates are closed on the CPU) on one parameter tree."""
    monkeypatch.setenv("WISE_CLIP_DTYPE", "bfloat16")
    monkeypatch.setenv("WISE_POOL_LAST", "1" if pool_last else "0")
    jc = dataclasses.replace(j_prod("ViT-H-14"), **TINY_H)
    tc = dataclasses.replace(t_prod("ViT-H-14"), **TINY_H)
    assert tc.fused_block and tc.vision_width // tc.vision_heads == 80
    jm = JM.CLIP(jc)
    params = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 16), jnp.int32)))()
    tm = TM.CLIP(tc).eval()
    tm.load_state_dict(from_flax_params(params))
    images = np.random.default_rng(4).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jm.apply(
        params, x, method=JM.CLIP.encode_image))(images))
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(images)).numpy()
    layers = tc.vision_layers - int(pool_last)
    assert open_padded_gate == [(4, 17, 160)] * layers
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert got.shape == want.shape and cos.min() >= 0.999, cos.min()


def test_towers_keep_the_monolithic_block_while_the_table_is_empty(
        monkeypatch):
    """With the table empty no tower takes the padded block: the head_dim-80
    tower's blocks pick fused_attn_block_train."""
    monkeypatch.setenv("WISE_CLIP_DTYPE", "bfloat16")
    tc = dataclasses.replace(t_prod("ViT-H-14"), **TINY_H)
    blk = TM.CLIP(tc).visual.transformer.resblocks[0]
    assert blk._fused_attn(17) is K.fused_attn_block_train
    K._CALIBRATED_PAD.add((17, 160))
    try:
        # the monolithic block takes head_dim 80: it keeps precedence
        assert blk._fused_attn(17) is K.fused_attn_block_train
    finally:
        K._CALIBRATED_PAD.clear()

"""The port's attention middle (wise_tpu_torch/ops/attention.py) against the
JAX package's (wise_tpu/ops/attention.py), and the CLIP towers that run it.

On the CPU ``fused_short_attention`` computes ``plain_short_attention``. That
is held to the Pallas TPU kernel run in interpret mode on bf16 inputs
(``interpret=True``, as tests/test_fused_attention.py runs it): per-token
cosine >= 0.999 and max abs error <= 1e-2 (outputs are averages of N(0, 1)
values; a bf16 ulp near 1 is 0.0078), with keys masked by ``n_valid``, the
causal mask, head_dim 80 and a ``scale`` override. A two-layer CLIP with
``fused_block`` off and ``fused_attention`` on (the production configuration
under WISE_FUSED_BLOCK=0) is held to the JAX model on the same parameter
tree in bf16 at cosine >= 0.9999; f32 towers never take the kernel. The CUDA
kernel itself is held to the plain version on the card in
tests/test_torch_kernels_cuda.py.
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
from wise_tpu.ops import attention as JA
from wise_tpu_torch.models.clip import model as TM
from wise_tpu_torch.models.clip.config import production_clip_config as t_prod
from wise_tpu_torch.models.clip.convert import from_flax_params
from wise_tpu_torch.ops import attention as A

#: (B, SP, D, heads, n_valid, causal, scale)
CASES = {
    "n_valid": (8, 16, 128, 2, 13, False, None),
    "causal": (8, 16, 128, 2, 16, True, None),
    "causal+n_valid": (4, 24, 128, 2, 19, True, None),
    "head_dim_80": (8, 16, 160, 2, 16, False, None),
    "scale": (8, 16, 128, 2, 16, False, 0.2),
    "vit_b32": (2, 56, 768, 12, 50, False, None),
}


def _qkv(case, seed=80):
    b, sp, d = CASES[case][:3]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, sp, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_short_attention_matches_tpu_kernel_bf16(case):
    _, _, d, heads, n_valid, causal, scale = CASES[case]
    qkv = _qkv(case)
    want = np.asarray(JA.fused_short_attention(
        *[jnp.asarray(t, jnp.bfloat16) for t in qkv], heads=heads,
        n_valid=n_valid, causal=causal, interpret=True, scale=scale),
        np.float32)
    got = A.fused_short_attention(
        *[torch.from_numpy(t).to(torch.bfloat16) for t in qkv], heads,
        n_valid, causal, scale)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    g, w = got.reshape(-1, d), want.reshape(-1, d)
    cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                             * np.linalg.norm(w, axis=-1))
    assert cos.min() >= 0.999, cos.min()
    assert np.abs(g - w).max() <= 1e-2


@pytest.mark.parametrize("case", ["n_valid", "causal", "head_dim_80"])
def test_plain_short_attention_matches_xla_attention_f32(case):
    """f32 on both sides: the reference's XLA path with the additive mask
    the kernel applies natively, to 1e-5."""
    _, sp, _, heads, n_valid, causal, _ = CASES[case]
    qkv = _qkv(case, seed=81)
    want = np.asarray(JA.xla_attention(
        *[jnp.asarray(t) for t in qkv], heads=heads,
        mask=JA._pad_causal_mask(sp, n_valid, causal)))
    got = A.plain_short_attention(*[torch.from_numpy(t) for t in qkv], heads,
                                  n_valid, causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_packed_views_and_separate_tensors_agree():
    """q, k and v as column ranges of one packed in-projection (how the
    model hands them over) or as three tensors: the same result."""
    rng = np.random.default_rng(82)
    qkv = torch.from_numpy(rng.standard_normal((2, 9, 384)).astype(
        np.float32)).to(torch.bfloat16)
    views = qkv.split(128, dim=-1)
    a = A.fused_short_attention(*views, 2, 9)
    b = A.fused_short_attention(*[v.contiguous() for v in views], 2, 9)
    assert torch.equal(a, b)


def test_cpu_tensors_launch_nothing():
    A.reset_launches()
    q = torch.zeros(1, 4, 64, dtype=torch.bfloat16)
    A.fused_short_attention(q, q, q, 1, 4)
    assert A.LAUNCHES == {"fused_short_attention": 0}
    assert not A.LAUNCHES_BY_SHAPE


# ---------------------------------------------------------------------------
# the towers under WISE_FUSED_BLOCK=0
# ---------------------------------------------------------------------------

TINY = dict(embed_dim=64, image_size=32, patch_size=8, vision_width=128,
            vision_heads=2, vision_layers=2, context_length=16,
            vocab_size=4096, text_width=128, text_heads=2, text_layers=2)


@functools.lru_cache(maxsize=None)
def _params():
    jm = JM.CLIP(dataclasses.replace(JM.get_clip_config("ViT-B-32"), **TINY))
    return jax.jit(lambda: jm.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 16), jnp.int32)))()


def _data():
    rng = np.random.default_rng(6)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 4000, (4, 16)).astype(np.int32)
    for i, n in enumerate([3, 16, 7, 1]):   # EOT (the max id) ends each text
        tokens[i, n - 1] = 4095
        tokens[i, n:] = 0
    return images, tokens


def _cos(a, b):
    return ((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
            / np.linalg.norm(b, axis=-1)).min()


def test_production_config_reads_both_switches(monkeypatch):
    for name in ("WISE_CLIP_DTYPE", "WISE_FUSED_BLOCK", "WISE_FUSED_ATTN"):
        monkeypatch.delenv(name, raising=False)
    cfg = t_prod("ViT-B-32")
    assert cfg.fused_block and cfg.fused_attention
    assert cfg.fused_attention == j_prod("ViT-B-32").fused_attention
    monkeypatch.setenv("WISE_FUSED_BLOCK", "0")
    cfg = t_prod("ViT-B-32")
    assert not cfg.fused_block and cfg.fused_attention
    monkeypatch.setenv("WISE_FUSED_ATTN", "0")
    cfg = t_prod("ViT-B-32")
    assert not cfg.fused_block and not cfg.fused_attention
    monkeypatch.delenv("WISE_FUSED_ATTN")
    monkeypatch.setenv("WISE_CLIP_DTYPE", "float32")
    cfg = t_prod("ViT-B-32")   # f32 towers never take a kernel
    assert not cfg.fused_block and not cfg.fused_attention
    assert cfg.fused_attention == j_prod("ViT-B-32").fused_attention


@pytest.mark.parametrize("pool_last", [True, False])
def test_hybrid_towers_match_jax_bf16(monkeypatch, pool_last):
    """fused_block off, fused_attention on: every non-pooled layer calls
    fused_short_attention, and the embeddings follow the JAX model's."""
    monkeypatch.setenv("WISE_CLIP_DTYPE", "bfloat16")
    monkeypatch.setenv("WISE_FUSED_BLOCK", "0")
    monkeypatch.delenv("WISE_FUSED_ATTN", raising=False)
    monkeypatch.setenv("WISE_POOL_LAST", "1" if pool_last else "0")
    jc = dataclasses.replace(j_prod("ViT-B-32"), **TINY)
    tc = dataclasses.replace(t_prod("ViT-B-32"), **TINY)
    assert tc.fused_attention and not tc.fused_block

    calls = []
    plain = A.fused_short_attention
    monkeypatch.setattr(A, "fused_short_attention", lambda *a, **kw: (
        calls.append(tuple(a[0].shape)), plain(*a, **kw))[1])
    params = _params()
    jm = JM.CLIP(jc)
    tm = TM.CLIP(tc).eval()
    tm.load_state_dict(from_flax_params(params))
    images, tokens = _data()
    want_i = np.asarray(jax.jit(lambda x: jm.apply(
        params, x, method=JM.CLIP.encode_image))(images))
    want_t = np.asarray(jax.jit(lambda x: jm.apply(
        params, x, method=JM.CLIP.encode_text))(tokens))
    with torch.no_grad():
        got_i = tm.encode_image(torch.from_numpy(images)).numpy()
        got_t = tm.encode_text(torch.from_numpy(tokens).long()).numpy()
    layers = 2 - int(pool_last)   # the pooled last layer is plain
    assert calls == [(4, 17, 128)] * layers + [(4, 16, 128)] * layers
    assert _cos(got_i, want_i) >= 0.9999
    assert _cos(got_t, want_t) >= 0.9999


def test_f32_and_plain_towers_never_take_the_attention_kernel(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("fused_short_attention called")

    monkeypatch.setattr(A, "fused_short_attention", boom)
    for dtype, attn, block in (("float32", True, False),
                               ("bfloat16", False, False),
                               ("bfloat16", True, True)):
        blk = TM.ResidualAttentionBlock(
            128, 2, "gelu", {"float32": torch.float32,
                             "bfloat16": torch.bfloat16}[dtype],
            fused_block=block, fused_attention=attn)
        TM.init_random_(blk, seed=0)
        out = blk(torch.randn(2, 5, 128), n_valid=5)
        assert out.shape == (2, 5, 128) and bool(torch.isfinite(out).all())

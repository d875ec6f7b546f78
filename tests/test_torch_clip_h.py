"""The port's CLIP towers at ViT-H/14's traits against the JAX package's.

A tiny tower with the traits that set ViT-H/14 apart (vision head_dim 80:
width 160 with 2 heads; 17 tokens from a 32 px image at patch 8) runs from
one Flax parameter tree through ``from_flax_params``: f32 embeddings agree
to 2e-4 abs, the bf16 production config (bf16 GEMMs, f32 LayerNorm and
vision stream) to cosine >= 0.9999, with the last layer pooled and
unpooled. The vocabulary is 4,096 so that the port's embedding lookup takes
every id (the JAX gather would clamp an id outside a smaller one). The
full-width ViT-H-14 config is built on the ``meta`` device only: parameter
count and key set against the reference's, no allocation.
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
from wise_tpu_torch.models.clip import model as TM
from wise_tpu_torch.models.clip.config import production_clip_config as t_prod
from wise_tpu_torch.models.clip.convert import from_flax_params
from wise_tpu_torch.ops import block as K

TINY_H = dict(embed_dim=64, image_size=32, patch_size=8, vision_width=160,
              vision_heads=2, vision_layers=2, context_length=16,
              vocab_size=4096, text_width=128, text_heads=2, text_layers=2)


def _configs(monkeypatch, dtype, pool_last):
    monkeypatch.setenv("WISE_CLIP_DTYPE", dtype)
    monkeypatch.setenv("WISE_POOL_LAST", "1" if pool_last else "0")
    return (dataclasses.replace(j_prod("ViT-H-14"), **TINY_H),
            dataclasses.replace(t_prod("ViT-H-14"), **TINY_H))


@functools.lru_cache(maxsize=None)
def _params():
    jm = JM.CLIP(dataclasses.replace(JM.get_clip_config("ViT-H-14"),
                                     **TINY_H))
    return jax.jit(lambda: jm.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 16), jnp.int32)))()


def _data():
    rng = np.random.default_rng(4)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 4000, (4, 16)).astype(np.int32)
    for i, n in enumerate([3, 16, 7, 1]):   # EOT (the max id) ends each text
        tokens[i, n - 1] = 4095
        tokens[i, n:] = 0
    return images, tokens


def _cos(a, b):
    return ((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
            / np.linalg.norm(b, axis=-1)).min()


@pytest.mark.parametrize("pool_last", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_80_towers_match_jax(monkeypatch, dtype, pool_last):
    jc, tc = _configs(monkeypatch, dtype, pool_last)
    assert tc.vision_width // tc.vision_heads == 80
    assert tc.pool_last_block is pool_last
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
    assert got_i.shape == want_i.shape == (4, 64)
    assert got_t.shape == want_t.shape == (4, 64)
    if dtype == "float32":
        np.testing.assert_allclose(got_i, want_i, atol=2e-4, rtol=0)
        np.testing.assert_allclose(got_t, want_t, atol=2e-4, rtol=0)
    else:
        assert _cos(got_i, want_i) >= 0.9999
        assert _cos(got_t, want_t) >= 0.9999


def test_wide_towers_pick_the_split_mlp(monkeypatch):
    """A bf16 tower over width 768 routes its MLP to fused_mlp_split, a
    narrower one to fused_mlp_block; the attention block either way."""
    calls = []
    for name in ("fused_attn_block", "fused_mlp_block", "fused_mlp_split"):
        plain = getattr(K, name)
        monkeypatch.setattr(
            K, name, lambda *a, _n=name, _f=plain, **kw: (calls.append(_n),
                                                          _f(*a, **kw))[1])
    for width, want in ((128, "fused_mlp_block"), (1024, "fused_mlp_split")):
        calls.clear()
        blk = TM.ResidualAttentionBlock(width, width // 64, "gelu",
                                        torch.bfloat16, fused_block=True)
        TM.init_random_(blk, seed=0)
        x = torch.randn(2, 5, width, dtype=torch.bfloat16)
        out = blk(x, n_valid=5)
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
        assert calls == ["fused_attn_block", want]


def test_vit_h_14_builds_at_full_width_on_meta(monkeypatch):
    """The production ViT-H-14 config: the reference's parameter count and
    key set, shapes the kernels take in both towers."""
    monkeypatch.delenv("WISE_CLIP_DTYPE", raising=False)
    cfg = t_prod("ViT-H-14")
    assert (cfg.vision_width, cfg.vision_heads, cfg.vision_layers,
            cfg.text_width, cfg.text_heads, cfg.text_layers,
            cfg.embed_dim) == (1280, 16, 32, 1024, 16, 24, 1024)
    assert cfg.dtype == "bfloat16" and cfg.fused_block
    with torch.device("meta"):
        tm = TM.CLIP(cfg)
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}

    # the reference's tree, key for key: its abstract init at full width
    jm = JM.CLIP(JM.get_clip_config("ViT-H-14"))
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32),
        jnp.zeros((1, 77), jnp.int32)))
    flat = from_flax_params(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), tree))
    assert {k: tuple(v.shape) for k, v in flat.items()} == shapes
    assert sum(int(np.prod(s)) for s in shapes.values()) == 986_109_441

    for blk, seq in ((tm.visual.transformer.resblocks[0], 257),
                     (tm.text.transformer.resblocks[0], 77)):
        assert blk.fused_block
        assert K.supports_fused_block(seq, blk.width, blk.heads)
        assert K.mlp_choice(blk.width) == "split"

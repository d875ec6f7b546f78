"""The port's CLIP towers and preprocessing against the JAX package's.

One parameter tree drives both: the JAX CLIP initialises it, and
``from_flax_params`` carries it onto the port. f32 embeddings agree to 2e-4
abs (README's torch-parity bar; same math, f32 summation order only). The
bf16 production config (bf16 GEMMs, f32 LayerNorm and vision stream, pooled
last layer) rounds at other points in the two frameworks: cosine >= 0.9999.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.models.clip import model as JM
from wise_tpu.models.clip import preprocess as JP
from wise_tpu.models.clip.extractor import production_clip_config as j_prod
from wise_tpu_torch.models.clip import model as TM
from wise_tpu_torch.models.clip import preprocess as TP
from wise_tpu_torch.models.clip.config import production_clip_config as t_prod
from wise_tpu_torch.models.clip.convert import (
    from_flax_params,
    load_openclip_state_dict,
)

#: ViT-Test-Tiny as registered, and at head_dim 64 (the width the block
#: kernels take; the JAX tower then pads the token axis and masks it)
SHAPES = {
    "tiny": {},
    "tiny-hd64": dict(vision_width=128, vision_heads=2, text_width=128,
                      text_heads=2),
}


@functools.lru_cache(maxsize=None)
def _params(shape):
    """The parameter tree of a shape (f32 whatever the compute dtype)."""
    jm = JM.CLIP(dataclasses.replace(JM.get_clip_config("ViT-Test-Tiny"),
                                     **SHAPES[shape]))
    return jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 16), jnp.int32)))()


def _towers(monkeypatch, shape, dtype):
    """(JAX encode_image, JAX encode_text, port CLIP) on one tree."""
    monkeypatch.setenv("WISE_CLIP_DTYPE", dtype)
    jm = JM.CLIP(dataclasses.replace(j_prod("ViT-Test-Tiny"), **SHAPES[shape]))
    params = _params(shape)
    tm = TM.CLIP(dataclasses.replace(t_prod("ViT-Test-Tiny"),
                                     **SHAPES[shape])).eval()
    tm.load_state_dict(from_flax_params(params))
    enc_i = jax.jit(lambda x: jm.apply(params, x,
                                       method=JM.CLIP.encode_image))
    enc_t = jax.jit(lambda x: jm.apply(params, x, method=JM.CLIP.encode_text))
    return enc_i, enc_t, tm


def _data():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 1000, (4, 16)).astype(np.int32)
    for i, n in enumerate([3, 16, 7, 1]):   # EOT (the max id) ends each text
        tokens[i, n - 1] = 1023
        tokens[i, n:] = 0
    return images, tokens


def _cos(a, b):
    return ((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
            / np.linalg.norm(b, axis=-1)).min()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_towers_match_jax(monkeypatch, shape, dtype):
    enc_i, enc_t, tm = _towers(monkeypatch, shape, dtype)
    images, tokens = _data()
    want_i, want_t = np.asarray(enc_i(images)), np.asarray(enc_t(tokens))
    with torch.no_grad():
        got_i = tm.encode_image(torch.from_numpy(images)).numpy()
        got_t = tm.encode_text(torch.from_numpy(tokens).long()).numpy()
    assert got_i.shape == want_i.shape and got_t.shape == want_t.shape
    if dtype == "float32":
        np.testing.assert_allclose(got_i, want_i, atol=2e-4, rtol=0)
        np.testing.assert_allclose(got_t, want_t, atol=2e-4, rtol=0)
    else:
        assert _cos(got_i, want_i) >= 0.9999
        assert _cos(got_t, want_t) >= 0.9999


def test_unpooled_last_layer_matches_pooled(monkeypatch):
    """WISE_POOL_LAST=0 runs the full last layer and slices the pooled row
    afterwards: the same embeddings."""
    *_, pooled = _towers(monkeypatch, "tiny-hd64", "float32")
    monkeypatch.setenv("WISE_POOL_LAST", "0")
    *_, full = _towers(monkeypatch, "tiny-hd64", "float32")
    images, tokens = _data()
    with torch.no_grad():
        for enc, arg in (("encode_image", torch.from_numpy(images)),
                         ("encode_text", torch.from_numpy(tokens).long())):
            np.testing.assert_allclose(getattr(full, enc)(arg).numpy(),
                                       getattr(pooled, enc)(arg).numpy(),
                                       atol=1e-5, rtol=0)


def test_openclip_state_dict_loads_strictly():
    from tests.test_convert_published_keysets import openclip_clip_keyset
    from wise_tpu.models.clip.model import get_clip_config

    cfg = get_clip_config("ViT-Test-Tiny")
    rng = np.random.default_rng(0)
    sd = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
          for k, v in openclip_clip_keyset(cfg).items()}
    tm = TM.CLIP(t_prod("ViT-Test-Tiny"))
    tm.load_state_dict(load_openclip_state_dict(sd, cfg))  # strict
    dt = tm.visual.conv1.kernel.dtype

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    # torch conv (out, in, kh, kw) -> HWIO; Linear (out, in) -> x @ W
    conv = sd["visual.conv1.weight"].transpose(2, 3, 1, 0)
    assert torch.equal(tm.visual.conv1.kernel, t(conv).to(dt))
    blk = tm.visual.transformer.resblocks[1]
    assert torch.equal(
        blk.attn.in_proj.kernel,
        t(sd["visual.transformer.resblocks.1.attn.in_proj_weight"].T).to(dt))
    assert torch.equal(tm.visual.ln_pre.scale, t(sd["visual.ln_pre.weight"]))


@pytest.mark.parametrize("src,dst", [(48, 32), (64, 224), (256, 224),
                                     (224, 224), (7, 3)])
def test_resize_weights_match_jax(src, dst):
    np.testing.assert_allclose(TP.resize_weights(src, dst),
                               JP._resize_weights(src, dst), atol=1e-6,
                               rtol=0)


def test_preprocess_matches_jax():
    frames = np.random.default_rng(2).integers(0, 256, (3, 48, 64, 3),
                                               dtype=np.uint8)
    want = np.asarray(JP.preprocess_images(jnp.asarray(frames), 32))
    got = TP.preprocess_images(torch.from_numpy(frames), 32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # bf16 GEMM path: the bf16 intermediate may round the other way where
    # f32 sums differ in the last bit — one bf16 ulp of a [0, 1] pixel
    # (2^-8) over the smallest channel std is 0.0146
    want = np.asarray(JP.preprocess_images_gemm(jnp.asarray(frames), 32))
    got = TP.preprocess_images_gemm(torch.from_numpy(frames), 32).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 0.015 and diff.mean() < 1e-3

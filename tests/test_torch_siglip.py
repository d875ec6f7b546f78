"""The port's SigLIP towers, and the registry entries they open, against the
JAX package's.

SigLIP's traits: a MAP-pooled vision tower (a biased patch embed, no class
token and no ``ln_pre``, every layer whole, ``ln_post`` over all tokens, then
the attention-pool head) and a bidirectional text tower pooled at its last
token with a biased head. One Flax parameter tree drives both packages:
the JAX module initialises it, ``from_flax_params`` carries it onto the
port. f32 embeddings agree to 2e-4 abs; the bf16 production config (bf16
GEMMs and stream, f32 LayerNorm and softmax) rounds at other points in the
two frameworks: cosine >= 0.9999. The JAX package runs its plain XLA path on
the CPU, as its own tests do; the port runs its kernels' plain versions on
CPU tensors. Inputs come from seeded numpy generators.
"""

import dataclasses
import functools
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_convert_published_keysets import openclip_siglip_keyset
from wise_tpu.models.clip import convert as JC
from wise_tpu.models.clip import model as JM
from wise_tpu.models.clip.extractor import production_clip_config as j_prod
from wise_tpu_torch.models.clip import config as TC
from wise_tpu_torch.models.clip import model as TM
from wise_tpu_torch.models.clip.config import production_clip_config as t_prod
from wise_tpu_torch.models.clip.convert import (
    from_flax_params,
    load_openclip_state_dict,
)
from wise_tpu_torch.ops import block as K

#: a tiny SigLIP at head_dim 64 (the width the block kernels take): 16
#: patches of a 64 px image, 12 text tokens
TINY = dict(embed_dim=96, image_size=64, patch_size=16, vision_width=128,
            vision_heads=2, vision_layers=2, context_length=12,
            vocab_size=4096, text_width=128, text_heads=2, text_layers=2)
MODEL = "ViT-L-16-SigLIP-384"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return ((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
            / np.linalg.norm(b, axis=-1)).min()


def _agree(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    else:
        assert _cos(got, want) >= 0.9999


def _configs(monkeypatch, dtype, pool_last=True):
    monkeypatch.setenv("WISE_CLIP_DTYPE", dtype)
    monkeypatch.setenv("WISE_POOL_LAST", "1" if pool_last else "0")
    return (dataclasses.replace(j_prod(MODEL), **TINY),
            dataclasses.replace(t_prod(MODEL), **TINY))


@functools.lru_cache(maxsize=None)
def _clip_params():
    """The tiny SigLIP CLIP's tree (f32 whatever the compute dtype), with
    every bias and LayerNorm parameter drawn at random as well: the
    initialiser leaves them at 0 and 1, where a port that dropped one would
    agree all the same."""
    jm = JM.CLIP(dataclasses.replace(JM.get_clip_config(MODEL), **TINY))
    tree = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3), jnp.float32),
        jnp.zeros((1, 12), jnp.int32)))()
    rng = np.random.default_rng(6)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "bias" in name or "scale" in name and "logit" not in name:
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _images(n=4, size=64, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _tokens(n=5, seed=2):
    """Hash-tokenizer-like rows: ids, then zero padding, of lengths 1 to 12
    (the last row full, so that the pooled row holds a real token)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 4096, (n, 12)).astype(np.int32)
    for i, length in enumerate([3, 1, 7, 11, 12][:n]):
        tokens[i, length:] = 0
    return tokens


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_map_head_matches_jax(dtype):
    """MAPHead alone on (B, S, D) tokens in the compute dtype: the probe's
    one-query attention, out-proj, pre-LN MLP residual."""
    jdt, tdt = DTYPES[dtype]
    width, heads = 128, 2
    head = JM.MAPHead(width, heads, act="gelu_tanh", dtype=jdt)
    tokens = np.random.default_rng(3).standard_normal(
        (3, 16, width)).astype(np.float32)
    params = head.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, width)))
    params = jax.tree_util.tree_map(
        lambda v: v + 0.05 * np.random.default_rng(v.size).standard_normal(
            v.shape).astype(np.float32), params)
    want = head.apply(params, jnp.asarray(tokens, jdt))
    th = TM.MAPHead(width, heads, "gelu_tanh", tdt).eval()
    th.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        got = th(torch.from_numpy(tokens).to(tdt))
    assert got.shape == (3, width) and got.dtype == tdt
    _agree(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_map_vision_tower_matches_jax(monkeypatch, dtype):
    """The MAP vision tower on its own tree: no class token, no ln_pre, a
    biased patch embed, the stream in the compute dtype."""
    jc, tc = _configs(monkeypatch, dtype)
    params = {"params": _clip_params()["params"]["visual"]}
    want = JM.VisionTransformer(jc).apply(params, _images())
    tv = TM.VisionTransformer(tc).eval()
    tv.load_state_dict(from_flax_params(params))
    assert not hasattr(tv, "class_embedding") and not hasattr(tv, "ln_pre")
    assert tuple(tv.positional_embedding.shape) == (16, 128)
    with torch.no_grad():
        got = tv(torch.from_numpy(_images()))
    _agree(got.numpy(), want, dtype)


@pytest.mark.parametrize("pool_last", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_last_pooled_text_tower_matches_jax(monkeypatch, dtype, pool_last):
    """The bidirectional text tower pooled at its last row, biased head;
    with the last layer pooled (static row 11) and run whole."""
    jc, tc = _configs(monkeypatch, dtype, pool_last)
    params = {"params": _clip_params()["params"]["text"]}
    want = JM.TextTransformer(jc).apply(params, _tokens())
    tt = TM.TextTransformer(tc).eval()
    tt.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        got = tt(torch.from_numpy(_tokens()).long())
    _agree(got.numpy(), want, dtype)


def test_text_tower_is_bidirectional_and_biased(monkeypatch):
    """An early token reaches the pooled last row (no causal mask), and the
    head's bias is added after the projection."""
    _, tc = _configs(monkeypatch, "float32")
    tt = TM.TextTransformer(tc).eval()
    tt.load_state_dict(from_flax_params(
        {"params": _clip_params()["params"]["text"]}))
    a = _tokens(5)
    b = a.copy()
    b[4, 0] = (b[4, 0] % 4095) + 1   # the first token of a full row
    with torch.no_grad():
        fa, fb = (tt(torch.from_numpy(t).long()).numpy() for t in (a, b))
        assert not np.allclose(fa[4], fb[4], atol=1e-4)
        np.testing.assert_array_equal(fa[:4], fb[:4])
        unbiased = fa - tt.text_projection_bias.numpy()
        tt.text_projection_bias.zero_()
        np.testing.assert_allclose(
            tt(torch.from_numpy(a).long()).numpy(), unbiased, atol=1e-6)


@pytest.mark.parametrize("pool_last", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_siglip_clip_matches_jax(monkeypatch, dtype, pool_last):
    """The whole tiny SigLIP CLIP in the production config, weights carried
    across by from_flax_params: both towers' embeddings, and the top-3
    images of every text the same in both packages."""
    jc, tc = _configs(monkeypatch, dtype, pool_last)
    params = _clip_params()
    jm = JM.CLIP(jc)
    tm = TM.CLIP(tc).eval()
    tm.load_state_dict(from_flax_params(params))
    assert tc.fused_block is (dtype == "bfloat16")
    images, tokens = _images(8, seed=7), _tokens()
    want_i = np.asarray(jax.jit(lambda x: jm.apply(
        params, x, method=JM.CLIP.encode_image))(images))
    want_t = np.asarray(jax.jit(lambda x: jm.apply(
        params, x, method=JM.CLIP.encode_text))(tokens))
    with torch.no_grad():
        got_i = tm.encode_image(torch.from_numpy(images)).numpy()
        got_t = tm.encode_text(torch.from_numpy(tokens).long()).numpy()
    assert got_i.shape == (8, 96) and got_t.shape == (5, 96)
    _agree(got_i, want_i, dtype)
    _agree(got_t, want_t, dtype)
    np.testing.assert_allclose(np.linalg.norm(got_i, axis=-1), 1, atol=1e-5)
    rank = lambda t, i: np.argsort(-(t @ i.T), axis=-1)[:, :3]  # noqa: E731
    np.testing.assert_array_equal(rank(got_t, got_i), rank(want_t, want_i))


def test_siglip_blocks_take_the_kernel_wrappers(monkeypatch):
    """A bf16 SigLIP tower calls the block kernels' wrappers in every layer,
    the text tower too (non-causal, the last layer at static row 11); the
    vision tower never calls the pooled block."""
    calls = []

    def record(name, fn):
        sig = inspect.signature(fn)

        def wrapper(*a, **kw):
            got = sig.bind(*a, **kw).arguments
            calls.append((name, got.get("causal"), got.get("pool_row")))
            return fn(*a, **kw)
        return wrapper

    for name in ("fused_attn_block", "fused_mlp_block", "fused_mlp_split",
                 "fused_attn_block_pooled", "fused_attn_block_pooled_dyn"):
        monkeypatch.setattr(K, name, record(name, getattr(K, name)))
    _, tc = _configs(monkeypatch, "bfloat16")
    tm = TM.init_random_(TM.CLIP(tc), seed=1).eval()
    with torch.no_grad():
        tm.encode_image(torch.from_numpy(_images()))
        assert calls == [("fused_attn_block", False, None),
                         ("fused_mlp_block", None, None)] * 2
        calls.clear()
        tm.encode_text(torch.from_numpy(_tokens()).long())
    assert calls == [("fused_attn_block", False, None),
                     ("fused_mlp_block", None, None),
                     ("fused_attn_block_pooled", False, 11)]


def test_init_random_families():
    """init_random_ on a SigLIP CLIP: the probe N(0, 0.02), the patch
    embed's and the text head's biases zero, as the reference initialises
    them."""
    tm = TM.init_random_(TM.CLIP(dataclasses.replace(
        TC.get_clip_config(MODEL), **TINY)), seed=0)
    sd = tm.state_dict()
    assert not sd["visual.conv1.bias"].any()
    assert not sd["text.text_projection_bias"].any()
    assert 0.01 < float(sd["visual.attn_pool.probe"].float().std()) < 0.03
    assert bool((sd["visual.attn_pool.norm.scale"] == 1).all())


def _synthetic_siglip_sd(cfg):
    rng = np.random.default_rng(8)
    return {k: (0.05 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in openclip_siglip_keyset(cfg).items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_converted_siglip_checkpoint_matches_jax(monkeypatch, dtype):
    """A synthetic open_clip / timm SigLIP state dict with the published key
    set, converted by both packages and loaded strictly into both: the same
    features. The converter writes ``proj`` as the identity."""
    jc, tc = _configs(monkeypatch, dtype)
    sd = _synthetic_siglip_sd(jc)
    params = {"params": JC.convert_openclip_state_dict(sd, jc)}
    tm = TM.CLIP(tc).eval()
    tm.load_state_dict(load_openclip_state_dict(sd, tc))  # strict
    assert torch.equal(tm.visual.proj.float(), torch.eye(128, 96))
    assert torch.equal(tm.text.text_projection_bias.float(), torch.from_numpy(
        sd["text.text_projection.bias"]).to(tm.text.text_projection.dtype)
        .float())
    jm = JM.CLIP(jc)
    images, tokens = _images(seed=9), _tokens()
    want_i = jm.apply(params, images, method=JM.CLIP.encode_image)
    want_t = jm.apply(params, tokens, method=JM.CLIP.encode_text)
    with torch.no_grad():
        got_i = tm.encode_image(torch.from_numpy(images)).numpy()
        got_t = tm.encode_text(torch.from_numpy(tokens).long()).numpy()
    _agree(got_i, want_i, dtype)
    _agree(got_t, want_t, dtype)


def _full_width_shapes(name, context):
    """(the port's state_dict shapes on ``meta``, the reference's abstract
    init carried through from_flax_params) at the production config."""
    cfg = t_prod(name)
    with torch.device("meta"):
        tm = TM.CLIP(cfg)
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    jc = JM.get_clip_config(name)
    jm = JM.CLIP(jc)
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, jc.image_size, jc.image_size, 3), jnp.float32),
        jnp.zeros((1, context), jnp.int32)))
    flat = from_flax_params(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), tree))
    return cfg, tm, shapes, {k: tuple(v.shape) for k, v in flat.items()}


@pytest.mark.parametrize("name,seq,ctx,params", [
    ("ViT-L-16-SigLIP-384", 576, 64, 502_372_353),
    ("ViT-B-16-SigLIP-256", 256, 64, 203_791_873),
    ("ViT-L-14-336", 577, 77, 427_944_193)])
def test_full_width_configs_build_on_meta(monkeypatch, name, seq, ctx,
                                          params):
    """The registry entries this slice opens, at full width on ``meta``: the
    reference's key set and shapes, and token counts the kernels take (576
    for SigLIP-384: 24 x 24 patches and no class token)."""
    for var in ("WISE_CLIP_DTYPE", "WISE_FUSED_BLOCK", "WISE_POOL_LAST"):
        monkeypatch.delenv(var, raising=False)
    cfg, tm, shapes, ref = _full_width_shapes(name, ctx)
    assert shapes == ref
    assert sum(int(np.prod(s)) for s in shapes.values()) == params
    assert cfg.dtype == "bfloat16" and cfg.fused_block
    vis = tm.visual
    assert vis.positional_embedding.shape[0] == seq
    for blk, n in ((vis.transformer.resblocks[0], seq),
                   (tm.text.transformer.resblocks[0], ctx)):
        assert blk.fused_block
        assert K.supports_fused_block(n, blk.width, blk.heads)


def test_registry_covers_the_reference():
    """Every entry of the reference's CLIP_CONFIGS, field for field, ViT-g-14
    and ViT-bigG-14 (vision head dims 88 and 104) among them; every vision
    and text head dim of the registry's OpenCLIP towers (ViT-Test-Tiny, a
    16-wide test tower, aside) is one the kernels take."""
    assert not hasattr(TC, "PENDING")
    assert set(TC.CLIP_CONFIGS) == set(JM.CLIP_CONFIGS)
    for name, ref in JM.CLIP_CONFIGS.items():
        got = TC.get_clip_config(name)
        if (got.vision_pool == "cls" and got.text_tower == "clip"
                and name != "ViT-Test-Tiny"):
            assert got.vision_width // got.vision_heads in K.HEAD_DIMS, name
            assert got.text_width // got.text_heads in K.HEAD_DIMS, name
        for field in dataclasses.fields(got):
            if field.name != "dtype":
                assert getattr(got, field.name) == getattr(ref, field.name), (
                    name, field.name)
    with pytest.raises(ValueError, match="unknown CLIP model"):
        TC.get_clip_config("ViT-Q-99")


def test_gate_takes_the_new_towers():
    """The gate raised to ten key tiles, equal in the wrappers and the
    kernel source: 576 and 577 tokens pass, one past MAX_SEQ does not."""
    src = (Path(K.__file__).parents[1] / "csrc" / "attention.cuh").read_text()
    assert int(re.search(r"kMaxSeq = (\d+);", src).group(1)) == K.MAX_SEQ
    assert K.MAX_SEQ == 640
    assert K.supports_fused_block(576, 1024, 16)
    assert K.supports_fused_block(577, 1024, 16)
    assert K.supports_fused_block(K.MAX_SEQ, 1280, 16)
    assert not K.supports_fused_block(K.MAX_SEQ + 1, 1024, 16)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_extractors_serve_a_siglip_checkpoint(tmp_path, monkeypatch, dtype):
    """Both packages' OpenClipExtractor on one staged SigLIP checkpoint
    (the synthetic published key set as ``.npz``), under a tiny model
    registered in both registries: uint8 frames at the model's size through
    the device preprocess and the MAP tower, and text through the hash
    tokenizer (no sentencepiece vocabulary staged) with the reference's
    bucket padding (3 queries ride a batch of 8)."""
    from wise_tpu.models.clip.extractor import OpenClipExtractor as JE
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor as TE
    from wise_tpu_torch.models.clip.tokenizer import HashTokenizer

    name = "ViT-Test-SigLIP"
    monkeypatch.setitem(JM.CLIP_CONFIGS, name, dataclasses.replace(
        JM.get_clip_config(MODEL), **TINY))
    monkeypatch.setitem(TC.CLIP_CONFIGS, name, dataclasses.replace(
        TC.get_clip_config(MODEL), **TINY))
    ckpt = tmp_path / name / "webli"
    ckpt.mkdir(parents=True)
    np.savez(ckpt / "open_clip_model.npz",
             **_synthetic_siglip_sd(JM.CLIP_CONFIGS[name]))
    monkeypatch.setenv("WISE_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("WISE_CLIP_DTYPE", dtype)
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    fid = f"mlfoundations/open_clip/{name}/webli"
    je, te = JE(fid), TE(fid)
    assert isinstance(te.tokenizer, HashTokenizer)
    assert te.input_size == (64, 64) and te.output_dim == 96
    frames = np.random.default_rng(10).integers(0, 256, (3, 64, 64, 3),
                                                dtype=np.uint8)
    queries = ["a dog on the beach", "snow", "people cooking in a kitchen"]
    np.testing.assert_array_equal(te.tokenizer(queries),
                                  je.tokenizer(queries))
    _agree(te.extract_image_features(frames),
           je.extract_image_features(frames), dtype)
    _agree(te.extract_text_features(queries),
           je.extract_text_features(queries), dtype)

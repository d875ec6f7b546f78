"""The port's XLM-RoBERTa text tower (wise_tpu_torch/models/clip/hf_text.py)
against the JAX package's (wise_tpu/models/clip/hf_text.py).

One Flax parameter tree (from ``XLMRobertaTextTower.init``) goes through
``from_flax_params`` into the port's tower; the same token ids, with ragged
padding, go through both. f32: the un-normalised outputs agree to 2e-4 abs,
for both projection heads. bf16: the tower on the post-LN wrappers
(``fused_block``, their plain versions on CPU tensors) against its own
layers with ``fused_block`` off, and against the JAX tower, at cosine >=
0.9999. The
converter's tree is held to the JAX converter's on a synthetic state dict,
and ``CLIP(config)`` with the HF tower to the JAX ``CLIP``. The vocabulary is
4,096 so that the hash tokenizer's ids fit. The full-width default backbone
is built on the ``meta`` device only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.models.clip import hf_text as JH
from wise_tpu.models.clip import model as JM
from wise_tpu_torch.models.clip import hf_text as TH
from wise_tpu_torch.models.clip import model as TM
from wise_tpu_torch.models.clip.config import (get_clip_config,
                                               production_clip_config)
from wise_tpu_torch.models.clip.convert import (convert_openclip_state_dict,
                                                from_flax_params)
from wise_tpu_torch.ops import postln_block as P

TINY = dict(vocab_size=4096, width=128, layers=2, heads=2, intermediate=512,
            max_positions=40, embed_dim=32)
#: ragged padding (pad id 1): full, short, one token, and a bucket-pad row
#: (one real token at column 0)
TOKENS = np.ones((4, 16), np.int32)
TOKENS[0] = np.random.default_rng(0).integers(2, 4000, 16)
TOKENS[1, :5] = [4094, 17, 250, 3999, 4095]
TOKENS[2, :2] = [4094, 4095]
TOKENS[3, 0] = 4095


def _configs(proj_type, dtype="float32", fused_block=False):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return (JH.HFTextConfig(proj_type=proj_type, dtype=jdt, **TINY),
            TH.HFTextConfig(proj_type=proj_type, dtype=dtype,
                            fused_block=fused_block, **TINY))


@functools.lru_cache(maxsize=None)
def _params(proj_type):
    jt = JH.XLMRobertaTextTower(_configs(proj_type)[0])
    return jax.jit(lambda: jt.init(jax.random.PRNGKey(7),
                                   jnp.asarray(TOKENS)))()


def _towers(proj_type, dtype="float32", fused_block=False):
    jc, tc = _configs(proj_type, dtype, fused_block)
    tt = TH.XLMRobertaTextTower(tc).eval()
    tt.load_state_dict(from_flax_params(_params(proj_type)))
    return JH.XLMRobertaTextTower(jc), tt


def _cos(a, b):
    return ((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
            / np.linalg.norm(b, axis=-1)).min()


@pytest.mark.parametrize("proj_type", ["linear", "mlp"])
def test_tower_matches_jax_f32(proj_type):
    jt, tt = _towers(proj_type)
    want = np.asarray(jt.apply(_params(proj_type), jnp.asarray(TOKENS)))
    with torch.no_grad():
        got = tt(torch.from_numpy(TOKENS).long()).numpy()
    assert got.shape == want.shape == (4, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_state_dict_is_the_reference_tree_with_qkv_packed():
    """from_flax_params covers every parameter, and a layer's query | key |
    value become the columns of one qkv Dense."""
    tree = _params("mlp")["params"]
    flat = from_flax_params(tree)
    _, tt = _towers("mlp")
    assert set(flat) == set(tt.state_dict())
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in tt.state_dict().items()}
    sa = tree["layer_1"]["self"]
    np.testing.assert_array_equal(
        flat["layer_1.qkv.kernel"].numpy(),
        np.concatenate([np.asarray(sa[n]["kernel"])
                        for n in ("query", "key", "value")], axis=1))
    np.testing.assert_array_equal(
        flat["layer_1.qkv.bias"].numpy(),
        np.concatenate([np.asarray(sa[n]["bias"])
                        for n in ("query", "key", "value")]))


def test_padding_invariance():
    """Mean pooling and the key mask take the padding out: a row's embedding
    does not depend on how many pad columns follow it or on its batch."""
    _, tt = _towers("linear")
    toks = torch.from_numpy(TOKENS).long()
    with torch.no_grad():
        full = tt(toks)
        short = tt(toks[1:2, :8])     # fewer pad columns, alone in a batch
        other = toks.clone()
        other[1, 2] = 251
        changed = tt(other)
    np.testing.assert_allclose(short[0].numpy(), full[1].numpy(), atol=1e-5)
    assert not np.allclose(changed[1].numpy(), full[1].numpy(), atol=1e-4)
    np.testing.assert_allclose(changed[0].numpy(), full[0].numpy(), atol=1e-6)


@pytest.mark.parametrize("proj_type", ["linear", "mlp"])
def test_bf16_tower_on_the_wrappers_matches_its_plain_layers(monkeypatch,
                                                             proj_type):
    """With ``fused_block`` the layers call the wrappers, without it their
    plain versions: on CPU tensors the same arithmetic. Both follow the JAX
    tower (its XLA layers on the CPU) in bf16."""
    calls = []
    for name in ("fused_postln_attn_block", "fused_postln_mlp_block"):
        fn = getattr(P, name)
        monkeypatch.setattr(P, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    jt, fused = _towers(proj_type, "bfloat16", fused_block=True)
    _, plain = _towers(proj_type, "bfloat16", fused_block=False)
    toks = torch.from_numpy(TOKENS).long()
    with torch.no_grad():
        got = fused(toks).numpy()
        assert calls == ["fused_postln_attn_block",
                         "fused_postln_mlp_block"] * 2
        calls.clear()
        own = plain(toks).numpy()
        assert not calls
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _cos(got, own) >= 0.9999
    want = np.asarray(jt.apply(_params(proj_type), jnp.asarray(TOKENS)))
    assert _cos(got, want) >= 0.9999
    assert _cos(own, want) >= 0.9999


def test_f32_tower_never_takes_the_wrappers(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a post-LN wrapper was called")

    monkeypatch.setattr(P, "fused_postln_attn_block", boom)
    monkeypatch.setattr(P, "fused_postln_mlp_block", boom)
    _, tt = _towers("linear", "float32", fused_block=True)
    with torch.no_grad():
        assert tt(torch.from_numpy(TOKENS).long()).shape == (4, 32)


def test_mlp_variant_reaches_the_wrapper(monkeypatch):
    """The layer names no variant, as the reference's does not: the wrapper
    takes ``postln_mlp_choice`` of the width ("single" up to 768, "split"
    above, the reference's table)."""
    assert not hasattr(TH.HFTextConfig(), "mlp_variant")
    seen = []
    fn = P.fused_postln_mlp_block
    monkeypatch.setattr(P, "fused_postln_mlp_block", lambda *a, **kw: (
        seen.append((a[0].shape[-1], kw.get("variant"))), fn(*a, **kw))[1])
    layer = TH.BertLayer(TH.HFTextConfig(
        dtype="bfloat16", fused_block=True, **TINY))
    TM.init_random_(layer, seed=0)
    x = torch.randn(2, 4, 128).to(torch.bfloat16)
    layer(x, torch.zeros(2, 1, 4))
    assert seen == [(128, None)]
    assert P.postln_mlp_choice(128) == P.postln_mlp_choice(768) == "single"
    assert P.postln_mlp_choice(1024) == "split"


# ---------------------------------------------------------------------------
# the checkpoint converter
# ---------------------------------------------------------------------------


def _fake_hf_state_dict(c, mlp):
    rng = np.random.default_rng(1)
    sd = {}

    def w(name, *shape):
        sd[name] = (0.02 * rng.standard_normal(shape)).astype(np.float32)

    b = "text.transformer"
    w(f"{b}.embeddings.word_embeddings.weight", c.vocab_size, c.width)
    w(f"{b}.embeddings.position_embeddings.weight", c.max_positions, c.width)
    w(f"{b}.embeddings.token_type_embeddings.weight", 1, c.width)
    w(f"{b}.embeddings.LayerNorm.weight", c.width)
    w(f"{b}.embeddings.LayerNorm.bias", c.width)
    for i in range(c.layers):
        lp = f"{b}.encoder.layer.{i}"
        for name, dout, din in (
                ("attention.self.query", c.width, c.width),
                ("attention.self.key", c.width, c.width),
                ("attention.self.value", c.width, c.width),
                ("attention.output.dense", c.width, c.width),
                ("intermediate.dense", c.intermediate, c.width),
                ("output.dense", c.width, c.intermediate)):
            w(f"{lp}.{name}.weight", dout, din)
            w(f"{lp}.{name}.bias", dout)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            w(f"{lp}.{name}.weight", c.width)
            w(f"{lp}.{name}.bias", c.width)
    if mlp:
        hidden = (c.width + c.embed_dim) // 2
        w("text.proj.0.weight", hidden, c.width)
        w("text.proj.2.weight", c.embed_dim, hidden)
    else:
        w("text.proj.weight", c.embed_dim, c.width)
    return sd


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)


@pytest.mark.parametrize("proj_type", ["linear", "mlp"])
def test_converter_matches_the_jax_converter(proj_type):
    """With the token-type row at zero the two converters agree exactly; a
    row that is not zero the port folds into the positions (ROADMAP Queue
    C 6, tests/test_torch_xlmr_train.py holds it to transformers)."""
    jc, tc = _configs(proj_type)
    sd = _fake_hf_state_dict(tc, proj_type == "mlp")
    sd["text.transformer.embeddings.token_type_embeddings.weight"][:] = 0
    want = JH.convert_hf_text_state_dict(sd, jc)
    got = TH.convert_hf_text_state_dict(sd, tc)
    _assert_trees_equal(got, want)
    # and the converted tree runs: the same output from both towers
    jt = JH.XLMRobertaTextTower(jc)
    tt = TH.XLMRobertaTextTower(tc).eval()
    tt.load_state_dict(from_flax_params(got))
    ref = np.asarray(jt.apply({"params": want}, jnp.asarray(TOKENS)))
    with torch.no_grad():
        out = tt(torch.from_numpy(TOKENS).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_converter_raises_on_either_projection_mismatch():
    _, linear = _configs("linear")
    _, mlp = _configs("mlp")
    with pytest.raises(KeyError, match="MLP text projection"):
        TH.convert_hf_text_state_dict(_fake_hf_state_dict(mlp, True), linear)
    with pytest.raises(KeyError, match="linear text projection"):
        TH.convert_hf_text_state_dict(_fake_hf_state_dict(linear, False), mlp)


# ---------------------------------------------------------------------------
# CLIP with the HF text tower
# ---------------------------------------------------------------------------

TINY_CLIP = dict(embed_dim=32, image_size=32, patch_size=8, vision_width=128,
                 vision_heads=2, vision_layers=2, context_length=16,
                 vocab_size=4096, text_width=128, text_heads=2, text_layers=2,
                 text_tower="hf_xlm_roberta", hf_proj_type="mlp")


@functools.lru_cache(maxsize=None)
def _clip_params():
    jm = JM.CLIP(JM.CLIPConfig(**TINY_CLIP))
    return jax.jit(lambda: jm.init(
        jax.random.PRNGKey(8), jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.asarray(TOKENS[:1])))()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_with_the_hf_tower_matches_jax(dtype):
    from wise_tpu_torch.models.clip.config import CLIPConfig

    bf16 = dtype == "bfloat16"
    jc = JM.CLIPConfig(dtype=jnp.bfloat16 if bf16 else jnp.float32,
                       fused_block=bf16, pool_last_block=True, **TINY_CLIP)
    tc = CLIPConfig(dtype=dtype, fused_block=bf16, pool_last_block=True,
                    **TINY_CLIP)
    params = _clip_params()
    jm = JM.CLIP(jc)
    tm = TM.CLIP(tc).eval()
    assert isinstance(tm.text, TH.XLMRobertaTextTower)
    assert tm.text.config.intermediate == 512
    assert tm.text.config.proj_type == "mlp"
    tm.load_state_dict(from_flax_params(params))
    images = np.random.default_rng(9).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    want_i = np.asarray(jax.jit(lambda x: jm.apply(
        params, x, method=JM.CLIP.encode_image))(images))
    want_t = np.asarray(jax.jit(lambda x: jm.apply(
        params, x, method=JM.CLIP.encode_text))(TOKENS))
    with torch.no_grad():
        got_i = tm.encode_image(torch.from_numpy(images)).numpy()
        got_t = tm.encode_text(torch.from_numpy(TOKENS).long()).numpy()
    if bf16:
        assert _cos(got_i, want_i) >= 0.9999
        assert _cos(got_t, want_t) >= 0.9999
    else:
        np.testing.assert_allclose(got_i, want_i, atol=2e-4, rtol=0)
        np.testing.assert_allclose(got_t, want_t, atol=2e-4, rtol=0)


def test_openclip_checkpoint_with_an_hf_text_tower_loads():
    """convert_openclip_state_dict dispatches the text side to the HF
    converter; the result loads into CLIP."""
    from tests.test_convert_published_keysets import openclip_clip_keyset
    from wise_tpu_torch.models.clip.config import CLIPConfig

    tc = CLIPConfig(**TINY_CLIP)
    rng = np.random.default_rng(10)
    sd = {k: (0.02 * rng.standard_normal(np.shape(v))).astype(np.float32)
          for k, v in openclip_clip_keyset(
              dataclasses.replace(tc, text_tower="clip")).items()
          if k.startswith("visual.") or k == "logit_scale"}
    hf = dataclasses.replace(TH.hf_text_config(tc), max_positions=514)
    sd.update(_fake_hf_state_dict(hf, mlp=True))
    tm = TM.CLIP(tc)
    tm.load_state_dict(from_flax_params(convert_openclip_state_dict(sd, tc)))
    np.testing.assert_array_equal(
        tm.text.layer_0.output.kernel.detach().numpy(),
        sd["text.transformer.encoder.layer.0.output.dense.weight"].T)


def test_init_random_covers_the_hf_names():
    from wise_tpu_torch.models.clip.config import CLIPConfig

    tm = TM.init_random_(TM.CLIP(CLIPConfig(**TINY_CLIP)), seed=0)
    sd = tm.text.state_dict()
    assert abs(sd["word_embeddings"].std().item() - 0.02) < 1e-3
    assert abs(sd["position_embeddings"].std().item() - 0.02) < 2e-3
    assert abs(sd["proj_fc"].std().item() - 0.02) < 2e-3
    assert abs(sd["proj_out"].std().item() - 0.02) < 2e-3
    for name, fan_in in (("layer_0.qkv", 128), ("layer_1.attn_out", 128),
                         ("layer_0.intermediate", 128),
                         ("layer_1.output", 512)):
        assert abs(sd[f"{name}.kernel"].std().item()
                   - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name
        assert not sd[f"{name}.bias"].any()
    for name in ("emb_ln", "layer_0.attn_ln", "layer_1.out_ln"):
        assert bool((sd[f"{name}.scale"] == 1).all())
        assert not sd[f"{name}.bias"].any()


def test_default_backbone_builds_at_full_width_on_meta(monkeypatch):
    """xlm-roberta-large-ViT-H-14 in the production config: the reference's
    fields and parameter count, shapes the post-LN kernels take."""
    for name in ("WISE_CLIP_DTYPE", "WISE_FUSED_BLOCK"):
        monkeypatch.delenv(name, raising=False)
    name = "xlm-roberta-large-ViT-H-14"
    cfg = production_clip_config(name)
    ref = JM.get_clip_config(name)
    for field in dataclasses.fields(get_clip_config(name)):
        if field.name != "dtype":
            assert getattr(get_clip_config(name), field.name) == getattr(
                ref, field.name), field.name
    assert cfg.dtype == "bfloat16" and cfg.fused_block
    with torch.device("meta"):
        tm = TM.CLIP(cfg)
    hf = tm.text.config
    assert (hf.vocab_size, hf.width, hf.layers, hf.heads, hf.intermediate,
            hf.max_positions, hf.embed_dim, hf.proj_type) == (
        250002, 1024, 24, 16, 4096, 514, 1024, "mlp")
    assert tm.text.layer_0.fused_block
    assert tm.text.word_embeddings.dtype == torch.bfloat16
    assert tm.text.proj_fc.dtype == torch.float32
    assert P.postln_mlp_choice(hf.width) == "split"

    # the reference's abstract init at full width: the same parameter count
    jm = JM.CLIP(ref)
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32),
        jnp.zeros((1, 64), jnp.int32)))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in tm.parameters()) == want == 1_193_013_761

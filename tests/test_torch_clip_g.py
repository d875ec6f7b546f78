"""The port's CLIP towers at ViT-g-14's and ViT-bigG-14's traits against the
JAX package's.

The two towers set apart by their vision head dims, 88 (ViT-g-14, 1408 / 16)
and 104 (ViT-bigG-14, 1664 / 16), which the attention kernels carry
zero-filled to 96 / 112 columns and the pooled kernel as strided words. A
tiny tower at each (width 352 or 416 with 4 heads: the wrappers take widths
that are multiples of 32; 17 tokens from a 32 px image at patch 8) runs from
one Flax parameter tree through ``from_flax_params``: f32 embeddings agree
to 2e-4 abs, the bf16 production config (bf16 GEMMs, f32 LayerNorm and
vision stream, the block kernels' wrappers, which compute their plain
versions on CPU tensors) to cosine >= 0.9999, with the last layer pooled and
unpooled. A training step at head_dim 88 through the block kernels' rules
is held against its plain twin. The full-width configs are built on the
``meta`` device only: parameter count and key set against the reference's.
A published checkpoint's wider MLP is refused (ROADMAP Queue C 11).
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
from wise_tpu_torch.models.clip.config import CLIPConfig, get_clip_config
from wise_tpu_torch.models.clip.config import production_clip_config as t_prod
from wise_tpu_torch.models.clip.convert import (from_flax_params,
                                                load_openclip_state_dict)
from wise_tpu_torch.ops import attention as A
from wise_tpu_torch.ops import block as K
from wise_tpu_torch.parallel import train as TT

#: head_dim -> the reference model whose trait it is, and a tiny tower at it
TINY = {
    88: ("ViT-g-14", dict(vision_width=352)),
    104: ("ViT-bigG-14", dict(vision_width=416)),
}
COMMON = dict(embed_dim=64, image_size=32, patch_size=8, vision_heads=4,
              vision_layers=2, context_length=16, vocab_size=4096,
              text_width=128, text_heads=2, text_layers=2)


def _tiny(hd):
    return {**COMMON, **TINY[hd][1]}


def _configs(monkeypatch, hd, dtype, pool_last):
    monkeypatch.setenv("WISE_CLIP_DTYPE", dtype)
    monkeypatch.setenv("WISE_POOL_LAST", "1" if pool_last else "0")
    name = TINY[hd][0]
    return (dataclasses.replace(j_prod(name), **_tiny(hd)),
            dataclasses.replace(t_prod(name), **_tiny(hd)))


@functools.lru_cache(maxsize=None)
def _params(hd):
    jm = JM.CLIP(dataclasses.replace(JM.get_clip_config(TINY[hd][0]),
                                     **_tiny(hd)))
    return jax.jit(lambda: jm.init(
        jax.random.PRNGKey(hd), jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 16), jnp.int32)))()


def _data(n=4, seed=4):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 4000, (n, 16)).astype(np.int32)
    for i, length in enumerate([3, 16, 7, 1, 9, 12, 5, 16][:n]):
        tokens[i, length - 1] = 4095  # EOT (the max id) ends each text
        tokens[i, length:] = 0
    return images, tokens


def _cos(a, b):
    return ((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
            / np.linalg.norm(b, axis=-1)).min()


@pytest.mark.parametrize("pool_last", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [88, 104])
def test_wide_head_towers_match_jax(monkeypatch, hd, dtype, pool_last):
    jc, tc = _configs(monkeypatch, hd, dtype, pool_last)
    assert tc.vision_width // tc.vision_heads == hd
    assert tc.pool_last_block is pool_last
    assert tc.fused_block is (dtype == "bfloat16")
    params = _params(hd)
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


@pytest.mark.parametrize("hd", [88, 104])
def test_the_gates_take_the_wide_head_dims(hd):
    """The block kernels' wrappers, their ``*_res`` training forwards and
    the attention middle (``fused_attention_trainable``) share one gate,
    HEAD_DIMS; the shapes of both full-width towers pass it, and a head
    dim next to them does not."""
    assert hd in K.HEAD_DIMS and hd in A.HEAD_DIMS
    width = 16 * hd
    assert K.supports_fused_block(257, width, 16)
    assert not K.supports_fused_block(257, 16 * (hd + 8), 16)
    b, sp, d = 2, 5, 4 * hd
    bf = torch.bfloat16
    args = (torch.zeros(b, sp, d), torch.ones(d), torch.zeros(d),
            torch.zeros(d, 3 * d, dtype=bf), torch.zeros(3 * d, dtype=bf),
            torch.zeros(d, d, dtype=bf), torch.zeros(d, dtype=bf))
    assert K._check_attn(*args, 4, sp, "gate") == (b, sp, d)
    with pytest.raises(ValueError, match="head_dim"):
        K._check_attn(*args, 8, sp, "gate")  # head_dim hd / 2


def _grads(cfg, tree, images, tokens, calls=None):
    model = TM.CLIP(cfg, param_dtype=torch.float32)
    model.load_state_dict(from_flax_params(tree))
    loss = TT.clip_loss(*model(torch.from_numpy(images),
                               torch.from_numpy(tokens).long()))
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach().clone()
                                  for k, p in model.named_parameters()}


def test_training_step_at_head_dim_88_matches_its_plain_twin(monkeypatch):
    """One step's loss and gradients through the block kernels' training
    rules (``fused_attn_block_res``, ``fused_mlp_block_res`` forwards, the
    pooled rule at the last layer) against the plain twin (``fused_block``
    and ``pool_last_block`` off) from one f32 master tree: loss within 1e-2,
    every gradient leaf at cosine >= 0.999 (the two round bf16 at the same
    points; the pooled last layer sums in another order)."""
    calls = []
    for name in ("fused_attn_block_res", "fused_mlp_block_res",
                 "fused_attn_block_pooled", "fused_attn_block_pooled_dyn"):
        plain = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _n=name, _f=plain, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    tree = jax.tree.map(np.asarray, _params(88))
    images, tokens = _data(n=8, seed=5)
    base = CLIPConfig(**_tiny(88), dtype="bfloat16")
    rules = dataclasses.replace(base, fused_block=True, pool_last_block=True)
    loss_r, g_r = _grads(rules, tree, images, tokens)
    assert calls.count("fused_attn_block_res") == 2  # 1 vision + 1 text
    assert calls.count("fused_attn_block_pooled") == 1
    assert calls.count("fused_attn_block_pooled_dyn") == 1
    calls.clear()
    loss_p, g_p = _grads(base, tree, images, tokens)
    assert not calls
    assert abs(loss_r - loss_p) < 1e-2
    checked = 0
    for k, g in g_p.items():
        assert bool(torch.isfinite(g_r[k]).all()), k
        if float(g.norm()) < 1e-7:
            continue
        cos = float(torch.nn.functional.cosine_similarity(
            g_r[k].flatten(), g.flatten(), dim=0))
        assert cos >= 0.999, (k, cos)
        checked += 1
    assert checked > 40


#: name -> (vision (width, heads, layers), text (width, heads, layers),
#: embed_dim, the reference's parameter count)
FULL = {
    "ViT-g-14": ((1408, 16, 40), (1024, 16, 24), 1024),
    "ViT-bigG-14": ((1664, 16, 48), (1280, 20, 32), 1280),
}


@functools.lru_cache(maxsize=None)
def _reference_shapes(name):
    jm = JM.CLIP(JM.get_clip_config(name))
    tree = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32),
        jnp.zeros((1, 77), jnp.int32)))
    flat = from_flax_params(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), tree))
    return {k: tuple(v.shape) for k, v in flat.items()}


@pytest.mark.parametrize("name", list(FULL))
def test_full_width_config_builds_on_meta(monkeypatch, name):
    """The production config at full width: the reference's key set and
    shapes, ~1.31 B (ViT-g-14) and ~2.29 B (ViT-bigG-14) parameters, the
    kernels' gate passing both towers' blocks, the split MLP."""
    monkeypatch.delenv("WISE_CLIP_DTYPE", raising=False)
    cfg = t_prod(name)
    (vw, vh, vl), (tw, th, tl), embed = FULL[name]
    assert (cfg.vision_width, cfg.vision_heads, cfg.vision_layers,
            cfg.text_width, cfg.text_heads, cfg.text_layers,
            cfg.embed_dim) == (vw, vh, vl, tw, th, tl, embed)
    assert cfg.dtype == "bfloat16" and cfg.fused_block
    with torch.device("meta"):
        tm = TM.CLIP(cfg)
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes == _reference_shapes(name)
    count = sum(int(np.prod(s)) for s in shapes.values())
    assert count == {"ViT-g-14": 1_308_986_113,
                     "ViT-bigG-14": 2_294_126_593}[name]
    mlp = shapes["visual.transformer.resblocks.0.mlp_fc.kernel"]
    assert mlp == (vw, 4 * vw)  # the reference's MLP (Queue C 11)
    for blk, seq in ((tm.visual.transformer.resblocks[0], 257),
                     (tm.text.transformer.resblocks[0], 77)):
        assert blk.fused_block
        assert K.supports_fused_block(seq, blk.width, blk.heads)
        assert K.mlp_choice(blk.width) == "split"


def _openclip_sd(cfg, vision_mlp, text_mlp):
    """A synthetic open_clip state dict at ``cfg``'s shapes (zeros), the
    vision and text MLPs ``vision_mlp`` / ``text_mlp`` wide."""
    sd = {
        "visual.conv1.weight": np.zeros((cfg.vision_width, 3, 8, 8)),
        "visual.class_embedding": np.zeros(cfg.vision_width),
        "visual.positional_embedding": np.zeros((17, cfg.vision_width)),
        "visual.proj": np.zeros((cfg.vision_width, cfg.embed_dim)),
        "token_embedding.weight": np.zeros((cfg.vocab_size,
                                            cfg.text_width)),
        "positional_embedding": np.zeros((cfg.context_length,
                                          cfg.text_width)),
        "text_projection": np.zeros((cfg.text_width, cfg.embed_dim)),
        "logit_scale": np.zeros(()),
    }
    for ln in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        w = cfg.text_width if ln == "ln_final" else cfg.vision_width
        sd[f"{ln}.weight"], sd[f"{ln}.bias"] = np.ones(w), np.zeros(w)
    for prefix, w, f, layers in (
            ("visual.transformer", cfg.vision_width, vision_mlp,
             cfg.vision_layers),
            ("transformer", cfg.text_width, text_mlp, cfg.text_layers)):
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            for ln in ("ln_1", "ln_2"):
                sd[f"{p}.{ln}.weight"] = np.ones(w)
                sd[f"{p}.{ln}.bias"] = np.zeros(w)
            sd[f"{p}.attn.in_proj_weight"] = np.zeros((3 * w, w))
            sd[f"{p}.attn.in_proj_bias"] = np.zeros(3 * w)
            sd[f"{p}.attn.out_proj.weight"] = np.zeros((w, w))
            sd[f"{p}.attn.out_proj.bias"] = np.zeros(w)
            sd[f"{p}.mlp.c_fc.weight"] = np.zeros((f, w))
            sd[f"{p}.mlp.c_fc.bias"] = np.zeros(f)
            sd[f"{p}.mlp.c_proj.weight"] = np.zeros((w, f))
            sd[f"{p}.mlp.c_proj.bias"] = np.zeros(w)
    return sd


@pytest.mark.parametrize("ratio,tower", [(48 / 11, "vision"),
                                         (64 / 13, "vision"),
                                         (5.0, "text")],
                         ids=["vit-g-vision", "vit-bigG-vision", "text"])
def test_a_wider_published_mlp_is_refused(ratio, tower):
    """A checkpoint whose MLP is not 4 x width (the published ViT-g-14's
    6,144 / 1,408 = 48 / 11 and bigG's 8,192 / 1,664 = 64 / 13, at the tiny
    width) raises naming Queue C 11 before any shape error; the 4 x width
    checkpoint loads into the tower."""
    cfg = CLIPConfig(**_tiny(88))
    wide = int(round(ratio * (cfg.vision_width if tower == "vision"
                              else cfg.text_width)))
    good = 4 * cfg.vision_width, 4 * cfg.text_width
    sd = _openclip_sd(cfg, *((wide, good[1]) if tower == "vision"
                             else (good[0], wide)))
    with pytest.raises(ValueError, match=rf"{tower} MLP is {wide} wide.*C 11"):
        load_openclip_state_dict(sd, cfg)
    state = load_openclip_state_dict(_openclip_sd(cfg, *good), cfg)
    TM.CLIP(cfg).load_state_dict(state)


def test_random_init_is_one_host_draw(monkeypatch, tmp_path):
    """An extractor without weights takes init_random_'s seed-0 draw on the
    host, weight for weight, whatever its device; the trainer draws its f32
    masters the same way, so its seed 0 cast to the serving dtype is the
    extractor's. init_random_ follows the parameters' device, and on the
    CPU that is the same draw."""
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.models.clip.model import init_random_
    from wise_tpu_torch.parallel.train import CLIPTrainer

    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WISE_CHECKPOINT_DIR", str(tmp_path))
    fe = OpenClipExtractor("mlfoundations/open_clip/ViT-Test-Tiny/none")
    served = fe.model.state_dict()
    again = init_random_(TM.CLIP(get_clip_config("ViT-Test-Tiny")), seed=0)
    assert again.state_dict().keys() == served.keys()
    assert all(torch.equal(v.to(served[k].dtype), served[k])
               for k, v in again.state_dict().items())
    masters = CLIPTrainer(fe.config, device="cpu").init(seed=0).params
    assert masters.keys() == served.keys()
    assert all(torch.equal(v.to(served[k].dtype), served[k])
               for k, v in masters.items())

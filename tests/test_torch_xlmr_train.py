"""Fine-tuning the default backbone (``xlm-roberta-large-ViT-H-14``: an
OpenCLIP ViT-H/14 vision tower, head_dim 80, beside the XLM-RoBERTa text
tower) in the port, against the JAX package, on the CPU.

A tower of the same kind at narrow widths (two vision layers at head_dim 80,
two post-LN text layers at head_dim 64, the "mlp" projection head) starts
from one flax tree in both packages (``convert.from_flax_params``) and takes
three steps on the same numpy batches, the captions tokenised as the train
CLI tokenises them for this tower (pad id 1). The port's bf16 runs go through
its training entries (the block rules for the vision tower, the post-LN
rules for the text tower; with ``fused_block`` off and ``fused_attention``
on, ``fused_attention_trainable``), which compute their plain versions on CPU
tensors; the JAX package runs its XLA layers on the CPU. Tolerances are
those of tests/test_torch_train.py: f32 losses to 1e-4 relative and every
parameter to 5e-5 abs (summation order); bf16 losses to 2e-2 relative, every
parameter within twice the sum of the learning rates so far (AdamW turns a
gradient near zero into a step of either sign), and the whole update's
cosine >= 0.9.

Also here: the train CLI's tokenizer for this tower (pad id 1, as the
extractor serves; no gradient reaches the pad row of the word table), the
CLI end to end on a tiny registry entry with the extractor serving its
checkpoint, the full-width training configuration on ``meta``, and the
converter's token-type row held to ``transformers``' XLM-R (ROADMAP Queue
C 6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.models.clip import hf_text as JH
from wise_tpu.models.clip import model as JM
from wise_tpu.parallel import train as JT
from wise_tpu_torch.cli import train as TC
from wise_tpu_torch.models.clip import hf_text as TH
from wise_tpu_torch.models.clip import model as TM
from wise_tpu_torch.models.clip.config import CLIPConfig
from wise_tpu_torch.models.clip.convert import from_flax_params
from wise_tpu_torch.parallel import train as TT

#: the default backbone's kind at narrow widths
TINY_H = dict(
    embed_dim=32, image_size=32, patch_size=8, vision_width=160,
    vision_layers=2, vision_heads=2, context_length=16, vocab_size=4096,
    text_width=128, text_heads=2, text_layers=2,
    text_tower="hf_xlm_roberta", hf_proj_type="mlp",
)
LR, WD, WARMUP, TOTAL, CLIP_NORM = 1e-3, 0.01, 2, 10, 0.5
CAPTIONS = ["a dog running on the beach", "zwei Katzen schlafen",
            "un chef cuisine la nuit", "a red car in the snow and the rain"]


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    images = rng.random((n, 32, 32, 3)).astype(np.float32)
    tokens = TC.training_tokenizer(CLIPConfig(**TINY_H))(
        [CAPTIONS[(seed + i) % len(CAPTIONS)] + f" take {seed}"
         for i in range(n)])
    return images, tokens


def _flax_tree(seed=0):
    model = JM.CLIP(JM.CLIPConfig(**TINY_H))
    images, tokens = _batch(0, 1)
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(images),
                                        jnp.asarray(tokens)))()
    return jax.tree.map(np.asarray, params)


def _jax_steps(dtype, tree, batches, **kw):
    import optax

    model = JM.CLIP(JM.CLIPConfig(**TINY_H, dtype=jnp.dtype(dtype), **kw))
    tx = JT.build_optimizer(LR, WD, WARMUP, TOTAL, CLIP_NORM)
    params = jax.tree.map(jnp.asarray, tree)
    state = tx.init(params)

    @jax.jit
    def step(params, state, images, tokens):
        loss, grads = jax.value_and_grad(lambda p: JT.clip_loss(
            *model.apply(p, images, tokens)))(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for images, tokens in batches:
        params, state, loss = step(params, state, jnp.asarray(images),
                                   jnp.asarray(tokens))
        losses.append(float(loss))
    return losses, from_flax_params(jax.tree.map(np.asarray, params))


#: (dtype, the port's kernel flags, the JAX model's): the training config,
#: the WISE_FUSED_BLOCK=0 config, and f32 (no kernel)
RUNS = {
    "kernels-bf16": ("bfloat16", dict(fused_block=True,
                                      pool_last_block=True),
                     dict(fused_block=True, pool_last_block=True)),
    "attention-middle-bf16": ("bfloat16", dict(fused_attention=True,
                                               pool_last_block=True),
                              dict(fused_attention=True,
                                   pool_last_block=True)),
    "f32": ("float32", {}, {}),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_three_steps_match_the_jax_trainer(monkeypatch, run):
    """Losses and every parameter after three steps; the rules the config
    names must run (counted where the layers call them)."""
    from wise_tpu_torch.ops import attention as A
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops import postln_block as P

    dtype, kw, jkw = RUNS[run]
    calls = {}
    for mod, names in ((K, ("fused_attn_block_train", "fused_mlp_block_train",
                            "fused_attn_block_pooled_train")),
                       (P, ("fused_postln_attn_block_train",
                            "fused_postln_mlp_block_train")),
                       (A, ("fused_attention_trainable",))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k: (
                calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a, **k))[1])
    tree = _flax_tree()
    batches = [_batch(s) for s in range(3)]
    assert all((b[1] == 1).any() and not (b[1] == 0).any() for b in batches)
    want_losses, want = _jax_steps(dtype, tree, batches, **jkw)
    trainer = TT.CLIPTrainer(
        CLIPConfig(**TINY_H, dtype=dtype, **kw), device="cpu",
        learning_rate=LR, weight_decay=WD, warmup_steps=WARMUP,
        total_steps=TOTAL, grad_clip=CLIP_NORM).init(
        params=from_flax_params(tree))
    start = {k: v.clone() for k, v in trainer.params.items()}
    assert all(v.dtype == torch.float32 for v in start.values())
    got_losses = [float(trainer.train_step(*b)) for b in batches]
    got = trainer.params
    assert set(got) == set(want)
    # a step: each tower's first layer whole, the vision tower's last pooled
    expected = {
        "kernels-bf16": {"fused_attn_block_train": 3,
                         "fused_mlp_block_train": 3,
                         "fused_attn_block_pooled_train": 3,
                         "fused_postln_attn_block_train": 6,
                         "fused_postln_mlp_block_train": 6},
        "attention-middle-bf16": {"fused_attention_trainable": 3},
        "f32": {}}[run]
    assert calls == expected
    if dtype == "float32":
        assert got_losses == pytest.approx(want_losses, rel=1e-4)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=5e-5, rtol=0, err_msg=k)
        return
    assert got_losses == pytest.approx(want_losses, rel=2e-2)
    sched = TT.warmup_cosine_schedule(LR, WARMUP, TOTAL)
    moved = 2 * sum(sched(i) for i in range(3)) + 1e-6
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= moved, k
    du = torch.cat([(got[k] - start[k]).flatten() for k in want])
    dw = torch.cat([(want[k] - start[k]).flatten() for k in want])
    cos = float(torch.nn.functional.cosine_similarity(du, dw, dim=0))
    assert cos >= 0.9, cos


def test_clip_builds_the_xlmr_tower_with_f32_masters():
    """``CLIP(config, param_dtype=torch.float32)``: every parameter f32 (no
    refusal), used in bf16 at each layer, and the gradient reaches every
    master through the casts and the post-LN rules."""
    cfg = CLIPConfig(**TINY_H, dtype="bfloat16", fused_block=True,
                     pool_last_block=True)
    model = TM.CLIP(cfg, param_dtype=torch.float32)
    assert isinstance(model.text, TH.XLMRobertaTextTower)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.text.layer_0.fused_block
    assert model.text.layer_0.qkv.weights()[0].dtype == torch.bfloat16
    TM.init_random_(model, seed=3)
    images, tokens = _batch(5)
    loss = TT.clip_loss(*model(torch.from_numpy(images),
                               torch.from_numpy(tokens).long()))
    loss.backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert bool(p.grad.isfinite().all()), name
    text = dict(model.text.named_parameters())
    for name in ("layer_0.qkv.kernel", "layer_1.output.bias",
                 "layer_1.out_ln.scale", "proj_fc", "word_embeddings"):
        assert float(text[name].grad.abs().max()) > 0, name
    # the serving model keeps bf16 tables and matrices
    serve = TM.CLIP(cfg)
    assert serve.text.word_embeddings.dtype == torch.bfloat16
    assert serve.text.layer_0.qkv.kernel.dtype == torch.bfloat16


def test_training_tokenizer_pads_the_xlmr_tower_with_its_pad_id():
    """The train CLI pads the XLM-R tower's captions with 1, the tower's
    ``pad_token_id`` and what the extractor pads its queries with; CLIP
    towers keep the reference's 0. With 1 no gradient reaches the pad rows
    of the word and position tables, which padding with 0 would feed as a
    real token (ROADMAP Queue C 10)."""
    from wise_tpu_torch.models.clip.tokenizer import HashTokenizer

    cfg = CLIPConfig(**TINY_H)
    tok = TC.training_tokenizer(cfg)
    assert isinstance(tok, HashTokenizer) and tok.pad_id == 1
    ids = tok(["short", "a somewhat longer caption than that"])
    assert ids[0, 3:].tolist() == [1] * 13 and 0 not in ids
    assert TC.training_tokenizer(dataclasses.replace(
        cfg, text_tower="clip")).pad_id == 0

    images, tokens = _batch(7)
    model = TM.init_random_(TM.CLIP(dataclasses.replace(cfg, dtype="float32"),
                                    param_dtype=torch.float32), seed=4)
    grads = {}
    for pad in (1, 0):
        t = torch.from_numpy(np.where(tokens == 1, pad, tokens)).long()
        model.zero_grad()
        TT.clip_loss(*model(torch.from_numpy(images), t)).backward()
        grads[pad] = (model.text.word_embeddings.grad.clone(),
                      model.text.position_embeddings.grad.clone())
    word, pos = grads[1]
    assert float(word[1].abs().max()) == 0.0
    assert float(pos[1].abs().max()) == 0.0
    assert float(word[0].abs().max()) == 0.0
    # the reference's padding: id 0 counts as a token, its row learns
    assert float(grads[0][0][0].abs().max()) > 0.0


def test_cli_trains_the_xlmr_tower_and_the_extractor_serves_it(
        monkeypatch, tmp_path):
    """``python -m wise_tpu_torch.cli.train --model
    xlm-roberta-large-ViT-H-14`` with a tiny configuration of the same kind
    in the port's registry, its captions' frames made by a seeded stand-in
    for the decoder: three bf16 steps on the kernels' training entries, a
    checkpoint, and the port's extractor loads it into its serving model
    (every tensor the checkpoint's, cast to bf16) and serves finite unit
    text embeddings that differ from the seed-0 weights'."""
    from wise_tpu_torch.models.clip import config as TCfg
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.ops import postln_block as P
    from wise_tpu_torch.parallel.train import restore_train_checkpoint
    from wise_tpu_torch.pipeline import train_data

    name = "xlm-roberta-large-ViT-H-14"
    monkeypatch.setitem(TCfg.CLIP_CONFIGS, name, CLIPConfig(**TINY_H))
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    for var in ("WISE_FUSED_BLOCK", "WISE_POOL_LAST", "WISE_FUSED_ATTN"):
        monkeypatch.delenv(var, raising=False)
    segments = [(f"clip{i}.mp4", 0.5 + i, CAPTIONS[i % 4] + f" {i}")
                for i in range(8)]
    monkeypatch.setattr(train_data, "load_caption_segments",
                        lambda *a: segments)
    monkeypatch.setattr(train_data, "sample_frame", lambda path, t, size: (
        np.random.default_rng(int(t)).integers(
            0, 256, (size, size, 3), dtype=np.uint8)))
    seen = []
    fn = P.fused_postln_attn_block_train
    monkeypatch.setattr(P, "fused_postln_attn_block_train", lambda *a: (
        seen.append(a[0].requires_grad and 1 in a[1].shape), fn(*a))[1])
    (tmp_path / "proj").mkdir()
    ckpt = tmp_path / "ckpt" / name / "finetuned"
    assert TC.main(["--project-dir", str(tmp_path / "proj"),
                    "--metadata-id", "S/syn/train", "--caption-column",
                    "caption", "--model", name, "--steps", "3",
                    "--batch-size", "4", "--learning-rate", "1e-3",
                    "--checkpoint-dir", str(ckpt)]) == 0
    assert seen and all(seen)
    step, params, _ = restore_train_checkpoint(ckpt)
    assert step == 3 and all(v.dtype == torch.float32
                             for v in params.values())
    monkeypatch.setenv("WISE_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    served = OpenClipExtractor(f"mlfoundations/open_clip/{name}/finetuned",
                               device="cpu")
    state = served.model.state_dict()
    assert set(state) == set(params)
    for k, v in params.items():
        assert torch.equal(state[k], v.to(state[k].dtype)), k
    seed0 = OpenClipExtractor(f"mlfoundations/open_clip/{name}/none",
                              device="cpu")
    got = served.extract_text_features(CAPTIONS)
    base = seed0.extract_text_features(CAPTIONS)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-3)
    assert float(np.abs(got - base).max()) > 1e-3


def test_default_backbone_trains_on_the_kernels_at_full_width_on_meta(
        monkeypatch):
    """``training_clip_config("xlm-roberta-large-ViT-H-14")``: the kernels
    by default (block kernels for ViT-H/14, the post-LN kernels for XLM-R),
    the attention middle under WISE_FUSED_BLOCK=0; the f32 master tree holds
    the reference's 1,193,013,761 parameters."""
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops import postln_block as P

    for var in ("WISE_FUSED_BLOCK", "WISE_POOL_LAST", "WISE_FUSED_ATTN"):
        monkeypatch.delenv(var, raising=False)
    name = "xlm-roberta-large-ViT-H-14"
    cfg = TC.training_clip_config(name)
    assert cfg.dtype == "bfloat16" and cfg.fused_block
    assert cfg.pool_last_block and cfg.fused_attention
    assert K.supports_fused_block(257, cfg.vision_width, cfg.vision_heads)
    assert P.postln_mlp_choice(cfg.text_width) == "split"
    with torch.device("meta"):
        model = TM.CLIP(cfg, param_dtype=torch.float32)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == 1_193_013_761
    assert model.text.layer_23.fused_block
    assert model.text.word_embeddings.shape == (250002, 1024)
    monkeypatch.setenv("WISE_FUSED_BLOCK", "0")
    off = TC.training_clip_config(name)
    assert not off.fused_block and off.fused_attention
    blk = TM.ResidualAttentionBlock(
        1280, 16, "gelu", torch.bfloat16, off.fused_block,
        off.fused_attention)
    assert blk.fused_attention and not blk.fused_block


def _hf_model(token_type_std):
    """A tiny random ``transformers`` XLM-R (HF's own initialisation, seed
    0) whose token-type row is N(0, std)."""
    from transformers import XLMRobertaConfig, XLMRobertaModel

    torch.manual_seed(0)
    hf = XLMRobertaModel(XLMRobertaConfig(
        vocab_size=4096, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=512,
        max_position_embeddings=40, type_vocab_size=1, layer_norm_eps=1e-5,
        pad_token_id=1, hidden_act="gelu"), add_pooling_layer=False).eval()
    with torch.no_grad():
        hf.embeddings.token_type_embeddings.weight.normal_(
            0.0, token_type_std)
    return hf


def _open_clip_text_keys(hf, proj):
    sd = {f"text.transformer.{k}": v.numpy()
          for k, v in hf.state_dict().items()
          if not k.endswith("position_ids")}
    sd["text.proj.weight"] = proj.T.copy()
    return sd


def test_converter_folds_the_token_type_row_as_transformers_adds_it():
    """ROADMAP Queue C 6: HF's RoBERTa adds token type 0's row to every
    token. The port's converter folds it into the position table, so the
    port's f32 tower equals ``transformers``' XLM-R (mean pooled over the
    real tokens, then the projection) to 2e-5 abs with the row at N(0,
    0.5); without the fold it would be off by more than 1e-2. With the row
    at zero the port's tree is the JAX converter's."""
    cfg = TH.HFTextConfig(vocab_size=4096, width=128, layers=2, heads=2,
                          intermediate=512, max_positions=40, embed_dim=32)
    tokens = np.ones((3, 12), np.int64)
    tokens[0] = np.random.default_rng(1).integers(2, 4000, 12)
    tokens[1, :5] = [4094, 17, 250, 3999, 4095]
    tokens[2, :1] = [4095]
    proj = np.random.default_rng(2).standard_normal((128, 32)).astype(
        np.float32) * 0.05
    hf = _hf_model(0.5)
    sd = _open_clip_text_keys(hf, proj)
    tower = TH.XLMRobertaTextTower(cfg).eval()
    tower.load_state_dict(from_flax_params(
        TH.convert_hf_text_state_dict(sd, cfg)))
    t = torch.from_numpy(tokens)
    mask = (t != 1).long()
    with torch.no_grad():
        hidden = hf(input_ids=t, attention_mask=mask).last_hidden_state
        pooled = (hidden * mask[..., None]).sum(1) / mask.sum(1,
                                                             keepdim=True)
        want = (pooled @ torch.from_numpy(proj)).numpy()
        got = tower(t).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    dropped = dict(sd)
    dropped["text.transformer.embeddings.token_type_embeddings.weight"] = (
        np.zeros_like(dropped[
            "text.transformer.embeddings.token_type_embeddings.weight"]))
    tower.load_state_dict(from_flax_params(
        TH.convert_hf_text_state_dict(dropped, cfg)))
    with torch.no_grad():
        assert float(np.abs(tower(t).numpy() - want).max()) > 1e-2
    jcfg = JH.HFTextConfig(vocab_size=4096, width=128, layers=2, heads=2,
                           intermediate=512, max_positions=40, embed_dim=32)
    jtree = JH.convert_hf_text_state_dict(dropped, jcfg)
    ttree = TH.convert_hf_text_state_dict(dropped, cfg)
    flat = jax.tree_util.tree_leaves_with_path
    want_leaves = {jax.tree_util.keystr(p): v for p, v in flat(jtree)}
    got_leaves = {jax.tree_util.keystr(p): v for p, v in flat(ttree)}
    assert set(got_leaves) == set(want_leaves)
    for k, v in want_leaves.items():
        np.testing.assert_array_equal(np.asarray(got_leaves[k]),
                                      np.asarray(v), err_msg=k)

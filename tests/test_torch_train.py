"""The port's trainer (wise_tpu_torch/parallel/train.py) against the JAX
package's (wise_tpu/parallel/train.py), on the CPU.

Both start from one flax tree (``convert.from_flax_params`` carries it across
as f32) and see the same numpy batches. Tolerances are stated where they are
used: f32 runs differ by summation order only; bf16 runs round at other
places in XLA and in PyTorch, and AdamW turns a gradient near zero into a
step of either sign, so a parameter may be off by a few learning rates while
the tree as a whole moves the same way.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from wise_tpu.models.clip import model as JM
from wise_tpu.ops import block as JB
from wise_tpu.parallel import train as JT
from wise_tpu_torch.models.clip.config import CLIPConfig
from wise_tpu_torch.models.clip.convert import from_flax_params
from wise_tpu_torch.models.clip.model import CLIP
from wise_tpu_torch.parallel import train as TT

#: the tiny config of tests/test_train_checkpoint.py
TINY = dict(
    embed_dim=16, image_size=32, patch_size=16, vision_width=32,
    vision_layers=1, vision_heads=2, context_length=8, vocab_size=64,
    text_width=32, text_heads=2, text_layers=1,
)
#: a tiny config the block kernels' rules take (head_dim 64), two layers so
#: that a full block and the pooled last layer both run
FUSED = dict(
    embed_dim=64, image_size=64, patch_size=16, vision_width=256,
    vision_layers=2, vision_heads=4, context_length=16, vocab_size=128,
    text_width=128, text_heads=2, text_layers=2,
)
LR, WD, WARMUP, TOTAL, CLIP_NORM = 1e-3, 0.01, 2, 10, 0.5


def _batch(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random((n, cfg["image_size"], cfg["image_size"], 3)).astype(
        np.float32)
    tokens = rng.integers(1, cfg["vocab_size"] - 1,
                          (n, cfg["context_length"])).astype(np.int32)
    return images, tokens


def _flax_tree(cfg, seed=0):
    model = JM.CLIP(JM.CLIPConfig(**cfg))
    images, tokens = _batch(cfg, 1)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(images),
                        jnp.asarray(tokens))
    return jax.tree.map(np.asarray, params)


def _across(tree):
    return from_flax_params(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# (c) the optimizer against optax
# ---------------------------------------------------------------------------


def test_schedule_matches_optax():
    for lr, warm, total in ((1e-3, 2, 10), (1e-5, 0, 7), (3e-4, 5, 5),
                            (1e-3, 3, 0)):
        want = optax.warmup_cosine_decay_schedule(
            0.0, lr, max(warm, 1), max(total, warm + 1), lr * 0.01)
        got = TT.warmup_cosine_schedule(lr, warm, total)
        for count in range(14):
            # f32 on the optax side
            assert got(count) == pytest.approx(float(want(count)), rel=2e-6,
                                               abs=1e-12), (lr, warm, count)


def test_build_optimizer_matches_optax_over_20_steps():
    """20 AdamW steps on a random tree with random gradients: warm-up,
    cosine decay, weight decay on every leaf, and a clip that bites (the
    gradients' norm is ~10x the bound) and one step where it does not. f32
    on both sides: max abs difference <= 2e-6 on parameters of size ~1."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2), "scale": ()}
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    tx = JT.build_optimizer(LR * 10, 0.1, 3, 20, grad_clip=1.0)
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}
    opt = TT.build_optimizer(tp.values(), LR * 10, 0.1, 3, 20, grad_clip=1.0)
    for step in range(20):
        amp = 0.01 if step == 4 else 1.0  # step 4: under the bound, no clip
        grads = {k: (amp * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
        assert (norm < 1.0) == (step == 4)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=2e-6, rtol=0,
                                       err_msg=f"{k} at step {step}")
    assert opt.count == 20


def test_constant_rate_without_a_schedule():
    p = torch.nn.Parameter(torch.ones(3))
    opt = TT.build_optimizer([p], 0.5, 0.0)
    assert [opt.schedule(i) for i in (0, 1, 100)] == [0.5, 0.5, 0.5]


def test_clip_loss_matches_the_reference():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((6, 16)).astype(np.float32)
    txt = rng.standard_normal((6, 16)).astype(np.float32)
    want = float(JT.clip_loss(jnp.asarray(img), jnp.asarray(txt), 14.3))
    got = float(TT.clip_loss(torch.from_numpy(img), torch.from_numpy(txt),
                             torch.tensor(14.3)))
    assert got == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# (d) three trainer steps from one tree
# ---------------------------------------------------------------------------


def _jax_steps(cfg, dtype, tree, batches, remat=False):
    model = JM.CLIP(JM.CLIPConfig(**cfg, dtype=jnp.dtype(dtype),
                                  remat=remat))
    tx = JT.build_optimizer(LR, WD, WARMUP, TOTAL, CLIP_NORM)
    params = jax.tree.map(jnp.asarray, tree)
    state = tx.init(params)

    def loss_fn(p, images, tokens):
        return JT.clip_loss(*model.apply(p, images, tokens))

    @jax.jit
    def step(params, state, images, tokens):
        loss, grads = jax.value_and_grad(loss_fn)(params, images, tokens)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for images, tokens in batches:
        params, state, loss = step(params, state, jnp.asarray(images),
                                   jnp.asarray(tokens))
        losses.append(float(loss))
    return losses, _across(params)


def _trainer(cfg, dtype, tree, **kw):
    return TT.CLIPTrainer(
        CLIPConfig(**cfg, dtype=dtype, **kw), device="cpu", learning_rate=LR,
        weight_decay=WD, warmup_steps=WARMUP, total_steps=TOTAL,
        grad_clip=CLIP_NORM).init(params=from_flax_params(tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_the_jax_trainer(dtype):
    """Losses and every parameter after three steps. f32: losses to 1e-4
    relative, parameters to 5e-5 abs (summation order; an AdamW step is
    ~LR = 1e-3). bf16: losses to 2e-2 relative, every parameter within the
    sum of the learning rates so far (a step of the other sign on a gradient
    near zero), and the whole update's cosine >= 0.9."""
    tree = _flax_tree(TINY)
    batches = [_batch(TINY, seed=s) for s in range(3)]
    want_losses, want = _jax_steps(TINY, dtype, tree, batches)
    trainer = _trainer(TINY, dtype, tree)
    start = {k: v.clone() for k, v in trainer.params.items()}
    assert all(v.dtype == torch.float32 for v in start.values())
    got_losses = [float(trainer.train_step(*b)) for b in batches]
    got = trainer.params
    assert set(got) == set(want)
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


def test_remat_gives_the_same_gradients():
    """``remat`` recomputes blocks in the backward: the first step's loss and
    gradients are those without it (f32, to 1e-6), and match the JAX
    package's remat run."""
    tree = _flax_tree(TINY)
    batch = _batch(TINY)
    grads = {}
    for remat in (False, True):
        tr = _trainer(TINY, "float32", tree, remat=remat)
        loss = tr.loss(torch.from_numpy(batch[0]),
                       torch.from_numpy(batch[1]).long())
        loss.backward()
        grads[remat] = (float(loss.detach()), {k: p.grad.clone() for k, p
                                      in tr.model.named_parameters()})
    assert grads[True][0] == pytest.approx(grads[False][0], rel=1e-6)
    for k, g in grads[False][1].items():
        np.testing.assert_allclose(grads[True][1][k].numpy(), g.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
    want_losses, want = _jax_steps(TINY, "float32", tree, [batch], remat=True)
    tr = _trainer(TINY, "float32", tree, remat=True)
    assert float(tr.train_step(*batch)) == pytest.approx(want_losses[0],
                                                         rel=1e-4)
    for k in want:
        np.testing.assert_allclose(tr.params[k].numpy(), want[k].numpy(),
                                   atol=5e-5, rtol=0, err_msg=k)


def test_checkpoint_round_trip_and_identical_continuation(tmp_path):
    tree = _flax_tree(TINY)
    batch = _batch(TINY)
    trainer = _trainer(TINY, "float32", tree)
    trainer.train_step(*batch)
    path = trainer.save_checkpoint(tmp_path, 1)
    assert path.name == "step_00000001" and (path / TT.STATE_FILE).is_file()
    trainer.save_checkpoint(tmp_path, 7)
    assert TT.checkpoint_steps(tmp_path) == [1, 7]

    fresh = TT.CLIPTrainer(CLIPConfig(**TINY), device="cpu", learning_rate=LR,
                           weight_decay=WD, warmup_steps=WARMUP,
                           total_steps=TOTAL, grad_clip=CLIP_NORM).init(seed=1)
    assert fresh.restore_checkpoint(tmp_path, step=1) == 1
    for k, v in trainer.params.items():
        assert torch.equal(v, fresh.params[k]), k
    assert fresh.optimizer.count == 1
    # the restored state continues identically: same loss, same parameters
    assert float(trainer.train_step(*batch)) == float(
        fresh.train_step(*batch))
    for k, v in trainer.params.items():
        assert torch.equal(v, fresh.params[k]), k
    assert fresh.restore_checkpoint(tmp_path) == 7  # the latest by default
    with pytest.raises(FileNotFoundError):
        fresh.restore_checkpoint(tmp_path / "none")


def test_master_weights_keep_an_update_bf16_would_lose():
    """At the train CLI's default learning rate of 1e-5 a step moves a
    weight of size ~0.1 by less than half its bf16 ulp (2^-11 ~ 4.9e-4): the
    f32 master changes, its bf16 cast (nearly everywhere) does not. A trainer
    over bf16 parameters would learn nothing."""
    tree = _flax_tree(TINY)
    trainer = TT.CLIPTrainer(CLIPConfig(**TINY, dtype="bfloat16"),
                             device="cpu", learning_rate=1e-5).init(
        params=from_flax_params(tree))
    key = "visual.transformer.resblocks.0.mlp_fc.kernel"
    before = trainer.params[key].clone()
    assert before.dtype == torch.float32
    trainer.train_step(*_batch(TINY))
    after = trainer.params[key]
    big = before.abs() > 0.05
    assert bool(big.any())
    delta = (after - before).abs()[big]
    assert 0 < float(delta.max()) < 5e-5
    assert float((delta > 0).float().mean()) > 0.9
    # ... except where a weight sat within 1e-5 of a bf16 rounding boundary
    flipped = after.bfloat16()[big] != before.bfloat16()[big]
    assert float(flipped.float().mean()) < 0.1


# ---------------------------------------------------------------------------
# the slice as a whole on the kernels' rules
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_kernels_forced(monkeypatch):
    """The JAX package's fused_block path on the CPU, as
    tests/test_block_train.py forces it: kernels in interpret mode, the
    shape gates opened for head_dim 64."""
    for name in ("fused_attn_block", "fused_mlp_block", "fused_mlp_split",
                 "fused_attn_block_pooled", "fused_attn_block_pooled_dyn",
                 "fused_attn_block_res", "fused_mlp_block_res",
                 "fused_mlp_split_res"):
        monkeypatch.setattr(JB, name, functools.partial(getattr(JB, name),
                                                        interpret=True))

    def gate(b, sp, w, h, dt):
        return jnp.dtype(dt) == jnp.bfloat16 and w // h == 64 and sp % 8 == 0

    monkeypatch.setattr(JB, "supports_fused_block", gate)
    monkeypatch.setattr(JB, "supports_fused_block_pooled", gate)


def test_clip_gradients_on_the_block_rules_match_jax(jax_kernels_forced):
    """The training configuration (bf16, fused_block, pool_last_block): the
    loss and every parameter's gradient through the port's ``*_train`` rules
    against jax.grad through the JAX model on its interpreted kernels. Loss
    to 2e-2 abs; per-leaf cosine >= 0.98 on leaves with a gradient (the bars
    of tests/test_block_train.py's model-level tests). The text tower pads 16
    tokens to 16, the vision tower 17 to 24 in JAX only: the port's kernels
    take any length, so padded rows exist on one side alone."""
    kw = dict(fused_block=True, pool_last_block=True)
    tree = _flax_tree(FUSED, seed=2)
    images, tokens = _batch(FUSED, n=8, seed=3)
    jmodel = JM.CLIP(JM.CLIPConfig(**FUSED, dtype=jnp.bfloat16, **kw))

    def jloss(p):
        return JT.clip_loss(*jmodel.apply(p, jnp.asarray(images),
                                          jnp.asarray(tokens)))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, tree))
    want = _across(want)
    model = CLIP(CLIPConfig(**FUSED, dtype="bfloat16", **kw),
                 param_dtype=torch.float32)
    model.load_state_dict(from_flax_params(tree))
    loss = TT.clip_loss(*model(torch.from_numpy(images),
                               torch.from_numpy(tokens).long()))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < 2e-2
    checked = 0
    for k, p in model.named_parameters():
        g, w = p.grad.float().flatten(), want[k].flatten()
        assert p.grad.dtype == torch.float32 and bool(torch.isfinite(g).all())
        if float(w.norm()) < 1e-7:
            continue  # dead leaves (unused embedding rows, masked positions)
        cos = float(torch.nn.functional.cosine_similarity(g, w, dim=0))
        assert cos > 0.98, (k, cos)
        checked += 1
    assert checked > 40


def test_forward_returns_what_the_flax_model_returns():
    tree = _flax_tree(TINY)
    images, tokens = _batch(TINY)
    want = JM.CLIP(JM.CLIPConfig(**TINY)).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(images),
        jnp.asarray(tokens))
    model = CLIP(CLIPConfig(**TINY))
    model.load_state_dict(from_flax_params(tree))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(tokens).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-5)
    assert float(got[2]) == pytest.approx(1 / 0.07, rel=1e-5)


def test_token_ids_outside_the_vocabulary_raise():
    """Where the JAX towers clamp such ids without a word, the port raises
    and names the range and the vocabulary (ROADMAP Queue C 5)."""
    model = CLIP(CLIPConfig(**TINY))
    ok = torch.randint(1, 63, (2, 8))
    model.encode_text(ok)
    for bad in (64, 1000, -1):
        tokens = ok.clone()
        tokens[1, 3] = bad
        with pytest.raises(ValueError, match=r"vocabulary \[0, 64\)"):
            model.encode_text(tokens)

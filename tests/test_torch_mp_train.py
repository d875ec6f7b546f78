"""Tensor parallelism in the port (``--mp``: parallel/train.py's sharding rule
and trainer, parallel/distributed.py's groups and Megatron functions, the
head-split block forms of ops/block.py and models/clip/model.py) against the
port's single-process trainer and the JAX package's ``CLIPTrainer`` on a
``get_mesh(dp=1, mp=2)``, on the CPU.

One spawn of two gloo ranks serves the tests that need ranks: the train CLI
at ``--mp 2`` starts them, and each rank runs the CLI's own rank entry
(three steps of a tiny registry model on seeded stand-in captions and
frames), then, in the same process group, the trainer's checks
(``_trainer_checks``): three steps of a tiny CLIP, f32, from one flax tree
on the global batch of 8 (the 'mp' ranks see the same rows), the first step
again with a planted fault, and a bf16 first step through the block
kernels' training rules (their plain versions on the CPU). What is held:

- the ranks against the single-process trainer: losses, the first step's
  gradients (gathered whole) and the f32 parameters after three steps within
  1e-5 (``key_bias_apart``: the key third of an in-projection's bias, whose
  gradient is zero in exact arithmetic, within the learning rate a step);
  each rank's gradient of a sharded leaf equal to its slice of the single
  process's, of a replicated leaf equal on both ranks;
- the ranks against the JAX trainer on the dp = 1, mp = 2 mesh at
  tests/test_torch_dp_train.py's tolerances (losses 1e-4 relative,
  parameters 5e-5);
- the planted fault: the head-split blocks without the ``all_reduce`` of
  LN(x)'s cotangent (``TensorParallel.reduce_cotangent`` the identity)
  leave every leaf below the first block's LayerNorm off, on the plain forms
  and on the training rules alike;
- the CLI at ``--mp 2``: one ``step_00000003`` checkpoint in the
  one-process format, equal to the single-process CLI's within 1e-5, which
  a trainer at ``--mp 1`` restores, and the ranks at ``--mp 2`` too.

Without ranks: the shard / gather pair round trips bit for bit; the sharded
key set is the reference's for ViT-B/32 and the default backbone; each
head-split plain form, its ranks' partials summed, is the whole block's
plain form; a block whose heads do not divide refuses.

JAX is imported inside the fixture and the tests: the ranks import this
module by name and need none of it.
"""

import os
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_dp_train import (CLIP_NORM, LR, TINY, TOTAL, WARMUP, WD,
                                 _batches, _cli_args, _close, _stand_ins)
from wise_tpu_torch.models.clip.config import CLIPConfig
from wise_tpu_torch.parallel import distributed as TD
from wise_tpu_torch.parallel import train as TT

RANKS, TOL = 2, 1e-5
OUT_ENV = "WISE_TEST_MP_DIR"
#: the bf16 training rules' first gradients against the one process's:
#: relative error of each leaf (the two sum the heads' bf16 products in
#: another order)
BF16_REL = 2e-2


def key_bias_apart(got, want, grads, steps, lr, tol=TOL) -> list:
    """The keys of ``want`` off ``got`` by more than ``tol``, but for the
    key third of each in-projection's bias, held apart: a per-head constant
    added to every logit leaves the softmax as it is, so that third's
    gradient is zero in exact arithmetic and rounding noise in any run
    (``grads``, the first step's: under 1e-5 of the q third's there), and
    AdamW scales the noise to steps of up to ``lr``, so two runs part there
    by up to ``lr`` a step."""
    bad = []
    for key in want:
        if not key.endswith("attn.in_proj.bias"):
            if float((got[key] - want[key]).abs().max()) > tol:
                bad.append(key)
            continue
        q, k, v = got[key].chunk(3)
        wq, wk, wv = want[key].chunk(3)
        gq, gk, _ = grads[key].chunk(3)
        if (float(torch.cat([q - wq, v - wv]).abs().max()) > tol
                or float((k - wk).abs().max()) > steps * lr
                or not float(gk.abs().max()) < 1e-5 * float(gq.abs().max())):
            bad.append(key)
    return bad


def _trainer(params, clip=CLIP_NORM, mp=1, **config):
    cfg = CLIPConfig(**{**TINY, "dtype": "float32", **config})
    return TT.CLIPTrainer(cfg, device="cpu", learning_rate=LR,
                          weight_decay=WD, warmup_steps=WARMUP,
                          total_steps=TOTAL, grad_clip=clip,
                          mp=mp).init(params=params)


def _run(trainer, batches):
    """Steps over ``batches``: the losses, the whole parameters after, the
    first step's whole gradients (after the clip) and the rank's own."""
    losses, grads, local = [], None, None
    for i, (images, tokens) in enumerate(batches):
        losses.append(float(trainer.train_step(images, tokens)))
        if i == 0:
            local = {k: g.detach().clone()
                     for k, g in trainer.grads().items()}
            grads = trainer.whole(local)
    return {"losses": losses, "params": trainer.whole(trainer.params),
            "grads": grads, "local": local}


def _first_grads(trainer, batch):
    """The whole first-step gradients of ``trainer`` on ``batch``, clipped as
    its optimizer clips them, no step."""
    trainer.optimizer.zero_grad()
    trainer.loss(*batch).backward()
    if trainer.optimizer.grad_clip:
        with torch.no_grad():
            trainer.optimizer._clip()
    return trainer.whole(trainer.grads())


BF16 = dict(dtype="bfloat16", fused_block=True, pool_last_block=True)


def _trainer_checks(out_dir) -> None:
    """In a rank, after the CLI's run: three f32 steps at ``CLIP_NORM``, the
    first step's gradients with the planted fault, and the bf16 kernel
    rules' first gradients with and without it; the results in
    ``out_dir``."""
    import torch.distributed as dist

    state = torch.load(out_dir / "inputs.pt", weights_only=True)
    batches = list(zip(state["images"], state["tokens"]))
    trainer = _trainer(state["params"], mp=RANKS)
    assert (trainer.world, trainer.mp, trainer.dp, dist.get_backend()) == (
        RANKS, RANKS, 1, "gloo")
    out = _run(trainer, batches)
    bf16 = _trainer(state["params"], 0.0, RANKS, **BF16)
    out["bf16_grads"] = _first_grads(bf16, batches[0])
    real = TD.TensorParallel.reduce_cotangent
    TD.TensorParallel.reduce_cotangent = lambda self, g: g
    try:
        out["fault_grads"] = _first_grads(_trainer(state["params"], mp=RANKS),
                                          batches[0])
        out["bf16_fault_grads"] = _first_grads(bf16, batches[0])
    finally:
        TD.TensorParallel.reduce_cotangent = real
    # the CLI's whole checkpoint back onto the ranks' shards
    from test_torch_dp_train import SLICE

    back = TT.CLIPTrainer(CLIPConfig(**SLICE, dtype="float32"), device="cpu",
                          mp=RANKS).init(seed=1)
    out["restored_step"] = back.restore_checkpoint(out_dir / "mp")
    out["restored"] = back.whole(back.params)
    out["restored_count"] = back.optimizer.count
    torch.save(out, out_dir / f"rank{trainer.rank}.pt")


def _cli_rank(argv) -> None:
    from wise_tpu_torch.cli import train

    _stand_ins(dict.__setitem__, setattr)
    train._rank_main(argv)
    _trainer_checks(Path(os.environ[OUT_ENV]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One flax tree from the JAX trainer on a dp = 1, mp = 2 mesh. The CLI
    at --mp 2 (whose ranks then run the trainer's checks) runs in a thread
    while the JAX trainer steps the tree here and the port's single-process
    trainers and CLI run beside it.""" 
    import jax
    import jax.numpy as jnp

    from wise_tpu.models.clip import model as JM
    from wise_tpu.parallel import train as JT
    from wise_tpu.parallel.mesh import get_mesh
    from wise_tpu_torch.cli import train
    from wise_tpu_torch.models.clip.convert import from_flax_params

    tmp = tmp_path_factory.mktemp("mp")
    (tmp / "p").mkdir()
    mesh = get_mesh(dp=1, mp=2, devices=jax.devices()[:2])
    jt = JT.CLIPTrainer(JM.CLIPConfig(**TINY, dtype=jnp.float32), mesh,
                        learning_rate=LR, weight_decay=WD,
                        warmup_steps=WARMUP, total_steps=TOTAL,
                        grad_clip=CLIP_NORM)
    object.__setattr__(jt.model, "init", jax.jit(jt.model.init))
    params, opt_state = jt.init(jax.random.PRNGKey(0))
    tree = from_flax_params(jax.tree.map(np.asarray, params))
    batches = _batches()
    torch.save({"params": tree, "images": [b[0] for b in batches],
                "tokens": [b[1] for b in batches]}, tmp / "inputs.pt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WISE_TORCH_DEVICE", "cpu")
        mp.setenv(OUT_ENV, str(tmp))
        _stand_ins(mp.setitem, mp.setattr)
        mp.setattr(train, "_rank_main", _cli_rank)
        with ThreadPoolExecutor(1) as pool:
            mp_cli = pool.submit(train.main,
                                 _cli_args(tmp / "mp", "--mp", "2"))
            step = jt.make_train_step()
            jax_losses = []
            for images, tokens in batches:
                params, opt_state, loss = step(params, opt_state,
                                               jnp.asarray(images.numpy()),
                                               jnp.asarray(tokens.numpy()))
                jax_losses.append(float(loss))
            one = _run(_trainer(tree), batches)
            one["bf16_grads"] = _first_grads(_trainer(tree, 0.0, **BF16),
                                             batches[0])
            assert train.main(_cli_args(tmp / "one", "--mp", "1")) == 0
            refused = train.main(_cli_args(tmp / "mppp", "--mp", "2",
                                           "--pp", "2"))
            assert mp_cli.result() == 0
    return {"jax": (jax_losses,
                    from_flax_params(jax.tree.map(np.asarray, params))),
            "one": one, "start": tree, "tmp": tmp, "refused": refused,
            "ranks": [torch.load(tmp / f"rank{r}.pt", weights_only=True)
                      for r in range(RANKS)]}


def test_ranks_hold_one_model(runs):
    """Both ranks compute the global loss; a replicated leaf's gradient is
    the same on both, a sharded leaf's is the rank's slice of the single
    process's."""
    r0, r1 = runs["ranks"]
    want = runs["one"]["grads"]
    assert r0["losses"] == r1["losses"]
    assert r1["params"] is None and r1["grads"] is None   # rank 0 gathers
    sharded = 0
    for key, g0 in r0["local"].items():
        if not TT._spec_for_path(key, g0):
            assert torch.equal(g0, r1["local"][key]), key
            continue
        sharded += 1
        for r, rec in enumerate(runs["ranks"]):
            piece = TT._shard_leaf(key, want[key], TD.TensorParallel(2, r))
            assert not _close({key: rec["local"][key]}, {key: piece}), key
    assert sharded == 8   # 4 matrices a block, a block a tower


def test_two_ranks_match_one_process(runs):
    """Losses, whole first gradients and the parameters after three steps
    against the single-process trainer at the same batch."""
    got, want = runs["ranks"][0], runs["one"]
    assert got["losses"] == pytest.approx(want["losses"], rel=0, abs=TOL)
    assert not _close(got["grads"], want["grads"])
    assert not key_bias_apart(got["params"], want["params"], want["grads"], 3,
                              LR)
    moved = _close(got["params"], runs["start"])
    assert len(moved) > len(got["params"]) // 2, "the steps moved nothing"


def test_two_ranks_match_the_jax_trainer_on_an_mp2_mesh(runs):
    want_losses, want = runs["jax"]
    got = runs["ranks"][0]
    assert got["losses"] == pytest.approx(want_losses, rel=1e-4)
    assert set(got["params"]) == set(want)
    assert not _close(got["params"], want, tol=5e-5)


def test_the_ln_cotangent_must_be_summed_over_the_ranks(runs):
    """Without the all_reduce of LN(x)'s cotangent, the gradient of every
    leaf the blocks' inputs depend on (embeddings, the pre-LN, the blocks'
    own LayerNorms) misses the other rank's heads: the check that passes on
    the real sum (the first gradients, clipped) fails there, and on the bf16
    training rules too."""
    want = runs["one"]["grads"]
    got = runs["ranks"][0]
    assert not _close(got["grads"], want)
    bad = _close(got["fault_grads"], want)
    for key in ("visual.class_embedding", "visual.ln_pre.scale",
                "visual.transformer.resblocks.0.ln_1.scale",
                "text.token_embedding",
                "text.transformer.resblocks.0.ln_2.bias"):
        assert key in bad, key
    rel = _rel(got["bf16_grads"], runs["one"]["bf16_grads"])
    assert max(rel.values()) <= BF16_REL, max(rel, key=rel.get)
    rel = _rel(got["bf16_fault_grads"], runs["one"]["bf16_grads"])
    assert rel["visual.ln_pre.scale"] > 10 * BF16_REL
    assert rel["text.token_embedding"] > 10 * BF16_REL


def _rel(got, want) -> dict:
    return {k: float((got[k] - want[k]).norm() / want[k].norm().clamp_min(
        1e-12)) for k in want if float(want[k].norm()) > 1e-6}


def test_train_cli_at_mp_2_writes_the_whole_tree(runs):
    """``--mp 2``: one step-3 checkpoint in the one-process format, the
    single-process CLI's within 1e-5; a trainer at --mp 1 restores it, the
    AdamW moments whole, and so do the ranks at --mp 2 (gathered whole
    again, bit for bit). ``--mp 2 --pp 2`` is refused."""
    from wise_tpu_torch.parallel.train import (checkpoint_steps,
                                               restore_train_checkpoint)
    from test_torch_dp_train import SLICE

    tmp = runs["tmp"]
    assert checkpoint_steps(tmp / "mp") == [3]
    _, got, opt = restore_train_checkpoint(tmp / "mp")
    _, want, _ = restore_train_checkpoint(tmp / "one")
    assert not _close(got, want)
    restored = TT.CLIPTrainer(CLIPConfig(**SLICE, dtype="float32"),
                              device="cpu").init(seed=1)
    assert restored.restore_checkpoint(tmp / "mp") == 3
    assert not _close(restored.params, got, tol=0.0)
    names = [n for n, _ in restored.model.named_parameters()]
    for i, st in opt["adamw"]["state"].items():
        assert st["exp_avg"].shape == got[names[i]].shape, names[i]
    assert runs["refused"] == 1 and not (tmp / "mppp").exists()
    # and back onto the shards of --mp 2, gathered whole again
    rank0 = runs["ranks"][0]
    assert (rank0["restored_step"], rank0["restored_count"]) == (3, 3)
    assert not _close(rank0["restored"], got, tol=0.0)


def test_the_extractor_serves_the_mp_checkpoint_as_written(runs,
                                                           monkeypatch):
    """The port's extractor loads the ``--mp 2`` CLI's checkpoint directory
    as it is (every tensor the checkpoint's) and serves unit embeddings."""
    from test_torch_dp_train import MODEL, SLICE
    from wise_tpu_torch.models.clip import config as TC
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    tmp = runs["tmp"]
    _, params, _ = TT.restore_train_checkpoint(tmp / "mp")
    served = tmp / "served" / MODEL / "finetuned"
    served.parent.mkdir(parents=True)
    (tmp / "mp").rename(served)
    monkeypatch.setitem(TC.CLIP_CONFIGS, MODEL, TC.CLIPConfig(**SLICE))
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WISE_CHECKPOINT_DIR", str(tmp / "served"))
    monkeypatch.setenv("WISE_CLIP_DTYPE", "float32")
    try:
        extractor = OpenClipExtractor(
            f"mlfoundations/open_clip/{MODEL}/finetuned")
    finally:
        served.rename(tmp / "mp")
    state = extractor.model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in params.items())
    feats = extractor.extract_text_features(["a dog", "a red car"])
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1, atol=1e-5)


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------


def _state(cfg):
    from wise_tpu_torch.models.clip.model import CLIP, init_random_

    return init_random_(CLIP(cfg, param_dtype=torch.float32), 3).state_dict()


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_and_gather_round_trip(mp):
    """A tiny CLIP and a tiny SigLIP tree (MAPHead's split leaves) through
    ``shard_clip_params`` on every rank and ``gather_clip_params``: the
    tree, bit for bit; the in-projection's shard holds the rank's heads of
    q, of k and of v."""
    for cfg in (CLIPConfig(**{**TINY, "vision_heads": 4, "text_heads": 4}),
                CLIPConfig(**{**TINY, "vision_heads": 4, "text_heads": 4,
                              "vision_pool": "map", "text_pool": "last",
                              "text_causal": False})):
        whole = _state(cfg)
        shards = [TT.shard_clip_params(whole, TD.TensorParallel(mp, r))
                  for r in range(mp)]
        back = TT.gather_clip_params(shards)
        assert list(back) == list(whole)
        assert all(torch.equal(back[k], whole[k]) for k in whole)
    key = "visual.transformer.resblocks.0.attn.in_proj.kernel"
    d, e = 32, 32 // mp
    for r in range(mp):
        got = shards[r][key]
        for part in range(3):
            np.testing.assert_array_equal(
                got[:, part * e:(part + 1) * e],
                whole[key][:, part * d + r * e:part * d + (r + 1) * e])


@pytest.mark.parametrize("model", ["ViT-B-32", "xlm-roberta-large-ViT-H-14"])
def test_sharded_keys_are_the_references(model):
    """The keys ``clip_param_shardings`` splits over 'mp' are the state_dict
    keys of the leaves the reference's shards (abstract trees: jax's
    eval_shape and a CLIP on the meta device), at the published widths and
    two layers a tower (the rule is a layer's, the same at every depth);
    the XLM-R tower's none."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from wise_tpu.models.clip import model as JM
    from wise_tpu.parallel import train as JT
    from wise_tpu.parallel.mesh import get_mesh
    from wise_tpu_torch.models.clip.config import get_clip_config
    from wise_tpu_torch.models.clip.model import CLIP

    cut = dict(vision_layers=2, text_layers=2)
    c = dataclasses.replace(JM.get_clip_config(model), **cut)
    shapes = jax.eval_shape(
        lambda *a: JM.CLIP(c).init(*a), jax.random.PRNGKey(0),
        jnp.zeros((1, c.image_size, c.image_size, 3), jnp.float32),
        jnp.zeros((1, c.context_length), jnp.int32))
    specs = JT.clip_param_shardings(
        shapes, get_mesh(dp=1, mp=2, devices=jax.devices()[:2]))
    want = set()
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        if s.spec != P():
            keys = [str(getattr(p, "key", p)) for p in path][1:]
            want.add(".".join(re.sub(r"^resblocks_(\d+)$", r"resblocks.\1",
                                     k) for k in keys))
    with torch.device("meta"):
        sd = CLIP(dataclasses.replace(get_clip_config(model), **cut),
                  param_dtype=torch.float32).state_dict()
    got = {k for k, spec in TT.clip_param_shardings(sd).items() if spec}
    assert got == want and got
    assert not any(k.startswith("text.") for k in got) or model == "ViT-B-32"


def _block_weights(seed, d=64, heads=4, f=256):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=0.1):
        return torch.randn(*shape, generator=g) * s

    return dict(ln_s=1 + r(d), ln_b=r(d), wqkv=r(d, 3 * d), bqkv=r(3 * d),
                wo=r(d, d), bo=r(d), wfc=r(d, f), bfc=r(f), wproj=r(f, d),
                bproj=r(d), x=r(3, 10, d, s=1.0))


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("causal,n_valid", [(False, 10), (True, 10),
                                            (False, 7)])
def test_split_plain_forms_sum_to_the_whole_block(mp, causal, n_valid):
    """Each rank's partial (its heads, its MLP columns, no collective), the
    partials summed and closed (``mp_close`` with no group), against the
    whole block's plain form: the attention block, the MLP block and the
    pooled block at static and per-example rows, f32 at 1e-5."""
    from wise_tpu_torch.ops import block as K

    w = _block_weights(5)
    x, heads = w["x"], 4
    ln = (w["ln_s"], w["ln_b"])
    tps = [TD.TensorParallel(mp, r) for r in range(mp)]

    def qkv(tp):
        return (TT._shard_leaf("attn.in_proj.kernel", w["wqkv"], tp),
                w["bqkv"][tp.qkv_columns(64)],
                TT._shard_leaf("attn.out_proj.kernel", w["wo"], tp))

    total = sum(K.plain_attn_partial(x, *ln, *qkv(tp), heads // mp, n_valid,
                                     causal)[0] for tp in tps)
    got = K.mp_close(x, total, w["bo"], TD.NO_SPLIT)
    want = K.plain_attn_block(x, *ln, w["wqkv"], w["bqkv"], w["wo"], w["bo"],
                              heads, n_valid, causal)
    torch.testing.assert_close(got[:, :n_valid], want[:, :n_valid],
                               rtol=0, atol=TOL)

    total = sum(K.plain_mlp_partial(
        x, *ln, TT._shard_leaf("mlp_fc.kernel", w["wfc"], tp),
        w["bfc"][tp.columns(256)],
        TT._shard_leaf("mlp_proj.kernel", w["wproj"], tp), "gelu")[0]
        for tp in tps)
    got = K.mp_close(x, total, w["bproj"], TD.NO_SPLIT)
    want = K.plain_mlp_block(x, *ln, w["wfc"], w["bfc"], w["wproj"],
                             w["bproj"], "gelu")
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)

    for rows, pool_row in ((None, 4), (torch.tensor([9, 0, 5],
                                                    dtype=torch.int32), 0)):
        total = sum(K.plain_attn_pooled_partial(
            x, rows, *ln, *qkv(tp), heads // mp, n_valid, pool_row, causal)
            for tp in tps)
        got = K.mp_close(K.pooled_rows(x, rows, pool_row), total, w["bo"],
                         TD.NO_SPLIT)
        if rows is None:
            want = K.plain_attn_block_pooled(
                x, *ln, w["wqkv"], w["bqkv"], w["wo"], w["bo"], heads,
                n_valid, pool_row, causal)
        else:
            want = K.plain_attn_block_pooled_dyn(
                x, rows, *ln, w["wqkv"], w["bqkv"], w["wo"], w["bo"], heads,
                n_valid, causal)
        torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_blocks_that_do_not_divide_refuse():
    from wise_tpu_torch.models.clip.model import ResidualAttentionBlock

    with pytest.raises(ValueError, match="2 heads .* mp = 4"):
        ResidualAttentionBlock(32, 2, "gelu", torch.float32, False,
                               tp=TD.TensorParallel(4, 0))
    with pytest.raises(ValueError, match="do not split over mp = 3"):
        TT.shard_clip_params({"a.mlp_fc.kernel": torch.zeros(4, 8)},
                             TD.TensorParallel(3, 0))

"""Pipeline parallelism in the port (parallel/pipeline.py,
parallel/pp_train.py, the train CLI's ``--pp`` and ``--microbatches``)
against the JAX package's ``PipelinedStack`` and ``PipelinedCLIPTrainer``
and the port's single-process trainer, on the CPU (the stages are the CPU
named twice, or four times).

- ``PipelinedStack``: a four-layer stack of the JAX ``ResidualAttentionBlock``
  at pp 2 over microbatches 1, 2 and 4, with and without remat: the output
  and the gradients of sum(y²) with respect to the input and to every
  stacked leaf, against the JAX ``PipelinedStack`` at pp 2 and the same
  microbatches (2e-5 forward, 2e-4 gradients, as
  tests/test_pipeline_parallel.py holds the JAX stack to its sequential
  apply). A mesh of two 'dp' columns in one process is refused: each 'dp'
  rank drives its own.
- ``PipelinedCLIPTrainer``: three steps' losses against the JAX trainer on
  ``get_pp_mesh(pp=2, dp=1)`` from one flax tree (1e-4 relative); the
  port's trainer also against its single-process ``CLIPTrainer``, losses and
  parameters within 1e-5 (the key third of each in-projection's bias, whose
  gradient is zero in exact arithmetic, as tests/test_torch_mp_train.py
  ``key_bias_apart`` holds it).
- ``restructure_clip_params`` / ``restore_clip_params``: the round trip, bit
  for bit, and the stacks' shapes.
- The CLI at ``--pp 2 --microbatches 4`` (one process, two stages) and at
  ``--pp 2 --dp 2 --microbatches 2`` (one spawn of two gloo ranks, two stages
  each): a ``step_00000003`` checkpoint of the pipeline tree, which restored
  is the single-process CLI's within 1e-5 and which the extractor serves.
- The reference's refusals: ``--pp`` with ``--mp`` (tests/
  test_torch_mp_train.py), a batch that does not divide by dp x
  microbatches, a layer count that does not divide by pp, the default
  backbone, the kernels on.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_dp_train import CAPTIONS, _close
from test_torch_mp_train import key_bias_apart
from wise_tpu_torch.models.clip.config import CLIPConfig
from wise_tpu_torch.parallel import pipeline as PL
from wise_tpu_torch.parallel import pp_train as PT
from wise_tpu_torch.parallel import train as TT
from wise_tpu_torch.parallel.mesh import get_pp_mesh

WIDTH, HEADS, LAYERS, B, T = 32, 2, 4, 8, 10
#: tests/test_pp_train.py's config, at two layers a tower (a stage each)
CFG = dict(embed_dim=32, image_size=32, patch_size=16, vision_width=64,
           vision_layers=2, vision_heads=4, context_length=12,
           vocab_size=128, text_width=64, text_heads=4, text_layers=2,
           quick_gelu=True)
LR, WD, TOL = 1e-3, 0.01, 1e-5
#: a registry entry for the CLI: two layers a tower, for two stages, and a
#: vocabulary the hash tokenizer's ids fit
MODEL = "ViT-PPTRAIN"
SLICE = dict(embed_dim=16, image_size=32, patch_size=16, vision_width=32,
             vision_layers=2, vision_heads=2, context_length=8,
             vocab_size=4096, text_width=32, text_heads=2, text_layers=2)


def _mesh(pp, dp):
    return get_pp_mesh(pp, dp, ["cpu"] * (pp * dp))


def _layer_fn():
    from torch.func import functional_call

    from wise_tpu_torch.models.clip.model import ResidualAttentionBlock

    block = ResidualAttentionBlock(WIDTH, HEADS, "quick_gelu", torch.float32,
                                   False)
    return lambda p, h: functional_call(block, p, (h, h.shape[1]))


@pytest.fixture(scope="module")
def stack():
    """The JAX tower's params and input, the JAX PipelinedStack's value and
    gradients at pp 2 for each microbatch count, and the port's stacked tree
    of the same params."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from wise_tpu.models.clip.model import (ResidualAttentionBlock,
                                            Transformer)
    from wise_tpu.parallel import pipeline as JP
    from wise_tpu_torch.models.clip.convert import from_flax_params

    tf = Transformer(width=WIDTH, layers=LAYERS, heads=HEADS,
                     quick_gelu=True)
    x = jax.random.normal(jax.random.PRNGKey(0), (B, T, WIDTH), jnp.float32)
    # flax's init run eagerly compiles op by op: jit it
    params = jax.jit(tf.init)(jax.random.PRNGKey(1), x)["params"]
    per_layer, _ = JP.extract_resblock_params(params)
    stacked = JP.stack_layer_params(per_layer)

    def layer_fn(lp, h):
        return ResidualAttentionBlock(WIDTH, HEADS, quick_gelu=True).apply(
            {"params": lp}, h)

    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("pp", "dp"))
    pipes = {mb: JP.PipelinedStack(mesh, layer_fn, n_microbatches=mb)
             for mb in (1, 2, 4)}
    sp, xs = pipes[1].place(stacked, x)

    def run(a, b):   # one program for the three microbatch counts
        return {mb: (pipe.apply(a, b), *jax.value_and_grad(
            lambda a, b: jnp.sum(pipe.apply(a, b) ** 2),
            argnums=(0, 1))(a, b)) for mb, pipe in pipes.items()}

    want = {mb: (float(val), np.asarray(gx),
                 from_flax_params(jax.tree.map(np.asarray, gp)),
                 np.asarray(y))
            for mb, (y, val, (gp, gx)) in jax.jit(run)(sp, xs).items()}
    tree = from_flax_params(jax.tree.map(np.asarray, params))
    layers, rest = PL.extract_resblock_params(tree)
    assert rest == {}
    return PL.stack_layer_params(layers), torch.from_numpy(np.asarray(x)), want


@pytest.mark.parametrize("pp,dp,mb,remat", [
    (2, 1, 1, False), (2, 1, 2, False), (2, 1, 4, False), (2, 1, 2, True),
    (2, 1, 4, True)])
def test_pipelined_stack_matches_the_jax_stack(stack, pp, dp, mb, remat):
    stacked, x, want = stack
    val, gx, gp, y = want[mb]
    leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    xs = x.clone().requires_grad_()
    pipe = PL.PipelinedStack(_mesh(pp, dp), _layer_fn(), n_microbatches=mb,
                             remat=remat)
    out = pipe.apply(leaves, xs)
    np.testing.assert_allclose(out.detach().numpy(), y, rtol=2e-5,
                               atol=2e-5)
    loss = (out ** 2).sum()
    loss.backward()
    assert float(loss) == pytest.approx(val, rel=1e-5)
    np.testing.assert_allclose(xs.grad.numpy(), gx, rtol=2e-4, atol=2e-4)
    assert set(gp) == set(leaves)
    for k, g in gp.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), g.numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


def test_a_detached_stage_hop_fails_the_gradient_check(stack, monkeypatch):
    """The planted fault: activations detached as they cross to the next
    stage. The first stage's leaves get no gradient, and the check that
    passes on the real hop (above) fails on each of them."""
    stacked, x, want = stack
    _, _, gp, _ = want[2]
    monkeypatch.setattr(PL.PipelinedStack, "_hop",
                        lambda self, y, device: y.detach().to(device))
    leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    pipe = PL.PipelinedStack(_mesh(2, 1), _layer_fn(), n_microbatches=2)
    (pipe.apply(leaves, x) ** 2).sum().backward()
    for k, g in gp.items():
        first = leaves[k].grad[:LAYERS // 2]
        assert not np.allclose(first.numpy(), g.numpy()[:LAYERS // 2],
                               rtol=2e-4, atol=2e-4), k
        assert not first.any(), k


def test_stack_refusals(stack):
    stacked, x, _ = stack
    three = {k: v[:3] for k, v in stacked.items()}
    with pytest.raises(ValueError, match="3 layers not divisible by pp=2"):
        PL.PipelinedStack(_mesh(2, 1), _layer_fn(),
                          n_microbatches=2).apply(three, x)
    with pytest.raises(ValueError, match=r"batch 8 not divisible by "
                                         r"dp\*microbatches = 1\*3"):
        PL.PipelinedStack(_mesh(2, 1), _layer_fn(),
                          n_microbatches=3).apply(stacked, x)
    with pytest.raises(ValueError, match="'pp' and 'dp'"):
        from wise_tpu_torch.parallel.mesh import get_mesh

        PL.PipelinedStack(get_mesh(2, devices=["cpu"] * 2), _layer_fn(),
                          n_microbatches=1)


def test_a_mesh_of_two_columns_is_refused():
    """One process drives one 'dp' column: the stack refuses a mesh of two,
    and so does the trainer outside a process group of two ranks."""
    with pytest.raises(ValueError, match="a mesh of dp=2: one process"):
        PL.PipelinedStack(_mesh(2, 2), _layer_fn(), n_microbatches=2)
    with pytest.raises(ValueError, match="1 ranks on a mesh of dp=2"):
        PT.PipelinedCLIPTrainer(CLIPConfig(**CFG), _mesh(2, 2))


def _batches(steps=3, seed=0):
    out = []
    for i in range(steps):
        rng = np.random.default_rng(seed + i)
        images = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
        tokens = np.concatenate([rng.integers(1, 100, (8, 11)),
                                 np.full((8, 1), 127)], axis=1)
        out.append((torch.from_numpy(images), torch.from_numpy(tokens)))
    return out


def test_pipelined_trainer_matches_the_jax_and_the_one_process_trainer():
    """Three steps from one flax tree: the losses against the JAX
    PipelinedCLIPTrainer on get_pp_mesh(pp=2, dp=1) (1e-4 relative), and
    the losses and f32 parameters against the port's CLIPTrainer (1e-5);
    the trainer's tree round trips through the pipeline layout bit for bit
    and serves as a CLIP state_dict."""
    import jax
    import jax.numpy as jnp

    from wise_tpu.models.clip import model as JM
    from wise_tpu.parallel import mesh as JMESH
    from wise_tpu.parallel import pp_train as JPT
    from wise_tpu_torch.models.clip.convert import from_flax_params
    from wise_tpu_torch.models.clip.model import CLIP

    jt = JPT.PipelinedCLIPTrainer(
        JM.CLIPConfig(**CFG), JMESH.get_pp_mesh(2, 1, jax.devices()[:2]),
        n_microbatches=2, learning_rate=LR, weight_decay=WD)
    flax = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 12), jnp.int32))
    tree = from_flax_params(jax.tree.map(np.asarray, flax))
    pp_params, opt_state = jt.prepare(flax)
    step = jt.make_train_step()
    batches = _batches()
    want = []
    for images, tokens in batches:
        pp_params, opt_state, loss = step(pp_params, opt_state,
                                          jnp.asarray(images.numpy()),
                                          jnp.asarray(tokens.numpy(),
                                                      jnp.int32))
        want.append(float(loss))
    cfg = CLIPConfig(**CFG, dtype="float32")
    port = PT.PipelinedCLIPTrainer(cfg, _mesh(2, 1), n_microbatches=2,
                                   learning_rate=LR,
                                   weight_decay=WD).init(params=tree)
    one = TT.CLIPTrainer(cfg, device="cpu", learning_rate=LR,
                         weight_decay=WD).init(params=tree)
    got, single = [], []
    for i, b in enumerate(batches):
        got.append(float(port.train_step(*b)))
        single.append(float(one.train_step(*b)))
        if i == 0:
            grads = {n: p.grad.clone()
                     for n, p in one.model.named_parameters()}
    assert got == pytest.approx(want, rel=1e-4)
    assert got == pytest.approx(single, rel=0, abs=TOL)
    params = PT.restore_clip_params(port.pp_tree())
    assert not key_bias_apart(params, one.params, grads, 3, LR)
    assert _close(params, tree), "the steps moved nothing"
    model = CLIP(cfg)
    model.load_state_dict(params)


def test_restructure_and_restore_round_trip():
    from wise_tpu_torch.models.clip.model import CLIP, init_random_

    sd = init_random_(CLIP(CLIPConfig(**CFG)), 0).state_dict()
    pp = PT.restructure_clip_params(sd)
    assert pp["visual"]["stack"]["attn.in_proj.kernel"].shape == (2, 64, 192)
    assert "transformer.resblocks.0.ln_1.scale" not in pp["text"]["rest"]
    back = PT.restore_clip_params(pp)
    assert set(back) == set(sd) and len(back) == len(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("change,match", [
    (dict(text_tower="hf_xlm_roberta", text_pool="eos"), "CLS-pooled"),
    (dict(vision_pool="map", text_causal=False, text_pool="last"),
     "CLS-pooled"),
    (dict(fused_block=True), "fused"), (dict(fused_attention=True), "fused")])
def test_pipelined_trainer_refusals(change, match):
    with pytest.raises(ValueError, match=match):
        PT.PipelinedCLIPTrainer(CLIPConfig(**{**CFG, **change}), _mesh(2, 1))


def test_default_backbone_is_refused():
    from wise_tpu_torch.cli.train import training_clip_config

    cfg = training_clip_config("xlm-roberta-large-ViT-H-14", pp=2)
    assert not (cfg.fused_block or cfg.fused_attention
                or cfg.pool_last_block)
    with pytest.raises(ValueError, match="CLS-pooled"):
        PT.PipelinedCLIPTrainer(cfg, _mesh(2, 1))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _stand_ins(setitem, setattr_):
    """The two-layer registry model, and seeded caption segments and a frame
    a segment for pipeline/train_data.py (tests/test_torch_dp_train.py's,
    another model)."""
    from wise_tpu_torch.models.clip import config as TC
    from wise_tpu_torch.pipeline import train_data

    frames = np.random.default_rng(7).integers(
        0, 256, (len(CAPTIONS), 32, 32, 3), dtype=np.uint8)
    segments = [(f"clip{i}.mp4", float(i), c) for i, c in enumerate(CAPTIONS)]
    setitem(TC.CLIP_CONFIGS, MODEL, TC.CLIPConfig(**SLICE))
    setattr_(train_data, "load_caption_segments", lambda *a: segments)
    setattr_(train_data, "sample_frame", lambda path, t, size: frames[int(t)])


def _cli_rank(argv) -> None:
    from wise_tpu_torch.cli import train

    _stand_ins(dict.__setitem__, setattr)
    train._rank_main(argv)


def _args(ckpt, *more):
    return ["--project-dir", str(ckpt.parent / "p"), "--metadata-id",
            "T/pp/train", "--caption-column", "narration", "--model", MODEL,
            "--steps", "3", "--batch-size", "4", "--dtype", "float32",
            "--checkpoint-every", "0", "--checkpoint-dir", str(ckpt), *more]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLI at --pp 2 --microbatches 4 and at --pp 2 --dp 2
    --microbatches 2 (two ranks) beside the single-process CLI, and the
    refused batch."""
    from wise_tpu_torch.cli import train

    tmp = tmp_path_factory.mktemp("pp")
    (tmp / "p").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        _stand_ins(mp.setitem, mp.setattr)
        mp.setattr(train, "_rank_main", _cli_rank)
        # the ranks read the list when they start; the runs in this process
        # name their devices beside them
        mp.setenv("WISE_TORCH_DEVICE", "cpu,cpu,cpu,cpu")
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(train.main, _args(
                tmp / "dp", "--pp", "2", "--dp", "2", "--microbatches", "2"))
            rcs = {"pp": train.main(_args(tmp / "pp", "--pp", "2", "--dp",
                                          "1", "--microbatches", "4")),
                   "one": train.main(_args(tmp / "one", "--dp", "1")),
                   "odd": train.main(_args(tmp / "odd", "--pp", "2",
                                           "--microbatches", "3"))}
            rcs["dp"] = ranks.result()
    return tmp, rcs


@pytest.mark.parametrize("run", ["pp", "dp"])
def test_train_cli_at_pp_2_writes_the_pipeline_tree(cli_runs, run):
    """One step-3 checkpoint of the pipeline tree; restored, the single
    process CLI's within 1e-5 and moved from the seed-0 weights."""
    tmp, rcs = cli_runs
    assert rcs[run] == 0 and rcs["one"] == 0
    assert TT.checkpoint_steps(tmp / run) == [3]
    _, pp_tree, _ = TT.restore_train_checkpoint(tmp / run)
    assert set(pp_tree) == {"logit_scale", "visual", "text"}
    assert pp_tree["text"]["stack"]["ln_1.scale"].shape == (2, 32)
    got = PT.restore_clip_params(pp_tree)
    _, want, _ = TT.restore_train_checkpoint(tmp / "one")
    assert set(got) == set(want)
    assert not _close(got, want)
    start = TT.CLIPTrainer(CLIPConfig(**SLICE, dtype="float32"),
                           device="cpu").init(seed=0).params
    assert _close(got, start), "the CLI's steps moved nothing"


def test_the_extractor_serves_a_restored_pp_checkpoint(cli_runs,
                                                       monkeypatch):
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.models.clip import config as TC

    tmp, rcs = cli_runs
    _, pp_tree, _ = TT.restore_train_checkpoint(tmp / "pp")
    params = PT.restore_clip_params(pp_tree)
    TT.save_train_checkpoint(tmp / "served" / MODEL / "finetuned", 3,
                             params, {})
    monkeypatch.setitem(TC.CLIP_CONFIGS, MODEL, TC.CLIPConfig(**SLICE))
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WISE_CHECKPOINT_DIR", str(tmp / "served"))
    monkeypatch.setenv("WISE_CLIP_DTYPE", "float32")
    served = OpenClipExtractor(f"mlfoundations/open_clip/{MODEL}/finetuned")
    state = served.model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in params.items())
    feats = served.extract_text_features(["a dog", "a red car"])
    assert np.isfinite(feats).all()
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1, atol=1e-5)


def test_train_cli_refuses_a_batch_that_does_not_divide(cli_runs):
    tmp, rcs = cli_runs
    assert rcs["odd"] == 1 and not (tmp / "odd").exists()

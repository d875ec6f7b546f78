"""Data-parallel training in the port (parallel/train.py under
``torch.distributed``, parallel/distributed.py, the train CLI's ``--dp``)
against the port's single-process trainer and the JAX package's
``CLIPTrainer`` on a ``get_mesh(dp=2)``, on the CPU.

One spawn of two gloo ranks serves every test: the train CLI at ``--dp 2``
starts them, and each rank runs the CLI's own rank entry (three steps of a
tiny registry model on seeded stand-in captions and frames), then, in the
same process group, the trainer's checks (``_trainer_checks``): three steps
of a tiny CLIP, f32, from one flax tree (``convert.from_flax_params``) on
its half of a global batch of 8, and the first step again with a planted
fault. What is held:

- the ranks against the single-process trainer at the global batch: losses
  and f32 parameters within 1e-5, first-step gradients within 1e-5 (only
  the order of the reductions differs);
- the ranks against the JAX trainer on a dp = 2 mesh of the CPU devices
  that tests/conftest.py forces, at tests/test_torch_train.py's f32
  tolerance (losses 1e-4 relative, parameters 5e-5);
- the planted fault: the features' gather without the ``all_reduce`` in its
  backward gives the towers half their gradient (DDP's average over two
  ranks) while ``logit_scale`` keeps all of its, and the tower-gradient
  check must fail;
- the CLI at ``--dp 2``: one ``step_00000003`` checkpoint, equal to the
  single-process CLI's at the same global batch within 1e-5.

JAX is imported inside the fixture: the ranks import this module by name
and need none of it.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from wise_tpu_torch.models.clip.config import CLIPConfig
from wise_tpu_torch.parallel import distributed as TD
from wise_tpu_torch.parallel import train as TT

#: the tiny config of tests/test_torch_train.py
TINY = dict(
    embed_dim=16, image_size=32, patch_size=16, vision_width=32,
    vision_layers=1, vision_heads=2, context_length=8, vocab_size=64,
    text_width=32, text_heads=2, text_layers=1,
)
LR, WD, WARMUP, TOTAL, CLIP_NORM = 1e-3, 0.01, 2, 10, 0.5
GLOBAL, RANKS, TOL = 8, 2, 1e-5
#: where the ranks find their inputs and leave their results
OUT_ENV = "WISE_TEST_DP_DIR"
#: a tiny registry entry for the CLI whose vocabulary the hash tokenizer's
#: ids fit (tests/test_torch_train_slice.py's)
MODEL = "ViT-DPTRAIN"
SLICE = dict(TINY, vocab_size=4096)
CAPTIONS = ["frying vegetables", "stirring the pan", "a dog on the beach",
            "waves on the sand", "a red car at night", "two cats sleeping"]


def _batches(steps=3):
    out = []
    for seed in range(steps):
        rng = np.random.default_rng(seed)
        images = rng.random((GLOBAL, 32, 32, 3)).astype(np.float32)
        tokens = rng.integers(1, 63, (GLOBAL, 8)).astype(np.int64)
        out.append((torch.from_numpy(images), torch.from_numpy(tokens)))
    return out


def _trainer(params, clip):
    return TT.CLIPTrainer(
        CLIPConfig(**TINY, dtype="float32"), device="cpu", learning_rate=LR,
        weight_decay=WD, warmup_steps=WARMUP, total_steps=TOTAL,
        grad_clip=clip).init(params=params)


def _run(trainer, batches, rows=slice(None)):
    """Steps over ``batches`` (this rank's ``rows`` of each): the losses,
    the parameters after, and the first step's gradients (after the clip,
    as the optimizer took them)."""
    losses, grads = [], None
    for images, tokens in batches:
        losses.append(float(trainer.train_step(images[rows], tokens[rows])))
        if grads is None:
            grads = {name: p.grad.detach().clone()
                     for name, p in trainer.model.named_parameters()}
    return {"losses": losses, "params": trainer.params, "grads": grads}


class _GatherWithoutReduce(torch.autograd.Function):
    """The planted fault: ``gather_rows`` whose backward takes the rank's
    rows of the gradient without summing it over the ranks first."""

    @staticmethod
    def forward(ctx, x):
        return TT._GatherRows.forward(ctx, x)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi]


def _stand_ins(setitem, setattr_):
    """The tiny model in the registry, and seeded caption segments and a
    frame a segment for pipeline/train_data.py in place of the metadata
    table and the decoder, installed by ``setitem`` / ``setattr_``
    (monkeypatch's here, plain assignment in a rank)."""
    from wise_tpu_torch.models.clip import config as TC
    from wise_tpu_torch.pipeline import train_data

    frames = np.random.default_rng(7).integers(
        0, 256, (len(CAPTIONS), 32, 32, 3), dtype=np.uint8)
    segments = [(f"clip{i}.mp4", float(i), c) for i, c in enumerate(CAPTIONS)]
    setitem(TC.CLIP_CONFIGS, MODEL, TC.CLIPConfig(**SLICE))
    setattr_(train_data, "load_caption_segments", lambda *a: segments)
    setattr_(train_data, "sample_frame", lambda path, t, size: frames[int(t)])


def _trainer_checks(out_dir) -> None:
    """In a rank, after the CLI's run: its half of every batch, three steps
    at ``CLIP_NORM``, then the first step again without the clip and with
    the planted fault; the results in ``out_dir``."""
    import torch.distributed as dist

    state = torch.load(out_dir / "inputs.pt", weights_only=True)
    batches = list(zip(state["images"], state["tokens"]))
    trainer = _trainer(state["params"], CLIP_NORM)
    assert (trainer.world, dist.get_backend()) == (RANKS, "gloo")
    b = GLOBAL // RANKS
    rows = slice(trainer.rank * b, (trainer.rank + 1) * b)
    out = _run(trainer, batches, rows)
    TT.gather_rows = _GatherWithoutReduce.apply
    out["fault_grads"] = _run(_trainer(state["params"], 0.0), batches[:1],
                              rows)["grads"]
    torch.save(out, out_dir / f"rank{trainer.rank}.pt")


def _cli_rank(argv) -> None:
    """The CLI's rank entry in a spawned process (the tiny model and the
    stand-ins installed there first), then the trainer's checks."""
    from wise_tpu_torch.cli import train

    _stand_ins(dict.__setitem__, setattr)
    train._rank_main(argv)
    _trainer_checks(Path(os.environ[OUT_ENV]))


def _cli_args(ckpt, *more):
    return ["--project-dir", str(ckpt.parent / "p"), "--metadata-id",
            "T/dp/train", "--caption-column", "narration", "--model", MODEL,
            "--steps", "3", "--batch-size", "4", "--dtype", "float32",
            "--checkpoint-every", "0", "--checkpoint-dir", str(ckpt), *more]


def _close(got: dict, want: dict, tol=TOL, skip=()):
    """The keys of ``want`` but ``skip`` whose tensors differ by more than
    ``tol`` (absolute) in ``got``."""
    return [k for k in want if k not in skip
            and float((got[k] - want[k]).abs().max()) > tol]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One flax tree from the JAX trainer on a dp = 2 mesh. The CLI at
    --dp 2 (whose ranks then run the trainer's checks on the tree) runs in
    a thread while the JAX trainer steps the tree here and the port's
    single-process trainer runs beside it; then the single-process CLI and
    a refused ``--dp 3``."""
    import jax
    import jax.numpy as jnp

    from wise_tpu.models.clip import model as JM
    from wise_tpu.parallel import train as JT
    from wise_tpu.parallel.mesh import get_mesh
    from wise_tpu_torch.cli import train
    from wise_tpu_torch.models.clip.convert import from_flax_params

    tmp = tmp_path_factory.mktemp("dp")
    (tmp / "p").mkdir()
    mesh = get_mesh(dp=2, devices=jax.devices()[:2])
    jt = JT.CLIPTrainer(JM.CLIPConfig(**TINY, dtype=jnp.float32), mesh,
                        learning_rate=LR, weight_decay=WD,
                        warmup_steps=WARMUP, total_steps=TOTAL,
                        grad_clip=CLIP_NORM)
    # flax's init run eagerly compiles op by op (~11 s on the CPU): jit it
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
            dp_cli = pool.submit(train.main,
                                 _cli_args(tmp / "dp", "--dp", "2"))
            step = jt.make_train_step()
            jax_losses = []
            for images, tokens in batches:
                params, opt_state, loss = step(params, opt_state,
                                               jnp.asarray(images.numpy()),
                                               jnp.asarray(tokens.numpy()))
                jax_losses.append(float(loss))
            one = _run(_trainer(tree, CLIP_NORM), batches)
            one["plain_grads"] = _run(_trainer(tree, 0.0),
                                      batches[:1])["grads"]
            assert dp_cli.result() == 0
        assert train.main(_cli_args(tmp / "one", "--dp", "1")) == 0
        refused = train.main(_cli_args(tmp / "three", "--dp", "3"))
    return {"jax": (jax_losses,
                    from_flax_params(jax.tree.map(np.asarray, params))),
            "one": one, "start": tree, "tmp": tmp, "refused": refused,
            "ranks": [torch.load(tmp / f"rank{r}.pt", weights_only=True)
                      for r in range(RANKS)]}


def test_ranks_hold_one_model(runs):
    """Every rank computes the global loss and takes the same step."""
    r0, r1 = runs["ranks"]
    assert r0["losses"] == r1["losses"]
    assert not _close(r1["params"], r0["params"], tol=0.0)


def test_two_ranks_match_one_process(runs):
    """Losses, first gradients (every tower and ``logit_scale``) and the
    parameters after three steps, against the single-process trainer at
    the global batch."""
    got, want = runs["ranks"][0], runs["one"]
    assert got["losses"] == pytest.approx(want["losses"], rel=0, abs=TOL)
    assert not _close(got["grads"], want["grads"])
    assert not _close(got["params"], want["params"])
    moved = _close(got["params"], runs["start"])
    assert len(moved) > len(got["params"]) // 2, "the steps moved nothing"


def test_two_ranks_match_the_jax_trainer_on_a_dp2_mesh(runs):
    want_losses, want = runs["jax"]
    got = runs["ranks"][0]
    assert got["losses"] == pytest.approx(want_losses, rel=1e-4)
    assert set(got["params"]) == set(want)
    assert not _close(got["params"], want, tol=5e-5)


def test_the_gather_backward_must_sum_over_the_ranks(runs):
    """Without the sum, DDP's average leaves the towers half their
    gradient and ``logit_scale`` all of it (the first step, no clip): the
    check that passes on the real gather (above) fails on every tower, and
    the gradients are those of the fault, not noise."""
    want = runs["one"]["plain_grads"]
    bad = runs["ranks"][0]["fault_grads"]
    towers = _close(bad, want, skip=("logit_scale",))
    assert len(towers) == len(want) - 1, "the tower check passed"
    assert not _close(bad, want, skip=towers)   # logit_scale: all of it
    for k in towers:
        torch.testing.assert_close(bad[k], want[k] / RANKS, rtol=1e-4,
                                   atol=1e-7)


def test_backend_follows_the_devices():
    cards = [torch.device("cuda", i) for i in range(4)]
    assert TD.choose_backend(4, cards) == "nccl"
    assert TD.choose_backend(2, cards[:1]) == "gloo"         # one card, two
    assert TD.choose_backend(2, [cards[0], cards[0]]) == "gloo"
    assert TD.choose_backend(2, ["cpu"]) == "gloo"
    assert TD.choose_backend(3, cards[:2]) == "gloo"          # 3 on 2 cards
    assert [TD.rank_device(r, cards[:2]).index for r in range(4)] == [
        0, 1, 0, 1]


def test_train_cli_at_dp_2_writes_one_checkpoint(runs):
    """``--dp 2``: one step-3 checkpoint, the single-process CLI's at the
    same global batch within 1e-5, moved from the seed-0 weights both
    start from. ``--dp 3`` at batch 4 is refused."""
    from wise_tpu_torch.parallel.train import (checkpoint_steps,
                                               restore_train_checkpoint)

    tmp = runs["tmp"]
    assert checkpoint_steps(tmp / "dp") == [3]
    _, got, _ = restore_train_checkpoint(tmp / "dp")
    _, want, _ = restore_train_checkpoint(tmp / "one")
    assert not _close(got, want)
    start = TT.CLIPTrainer(CLIPConfig(**SLICE, dtype="float32"),
                           device="cpu").init(seed=0).params
    assert _close(got, start, tol=0.0), "the CLI's steps moved nothing"
    assert runs["refused"] == 1 and not (tmp / "three").exists()


@pytest.mark.parametrize("world,batch,n,drop", [
    (2, 8, 20, ()), (4, 8, 6, ()), (2, 4, 3, ()), (2, 8, 20, (5,)),
])
def test_caption_batches_give_each_rank_its_rows(monkeypatch, world, batch,
                                                 n, drop):
    """``caption_batches`` with a rank: every rank decodes only the frames
    of its own rows, and where every frame decodes, the ranks' batches side
    by side are the one-process global batches (fewer segments than a batch
    included, the order carried across epochs). A frame that does not
    decode is skipped by its rank alone, which still yields whole batches."""
    from wise_tpu_torch.pipeline import train_data

    frames = np.arange(n, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 2, 2, 3), np.uint8)
    decoded = []

    def sample(path, t, size):
        decoded.append(int(t))
        return None if int(t) in drop else frames[int(t)]

    monkeypatch.setattr(train_data, "sample_frame", sample)
    segments = [(f"c{i}.mp4", float(i), f"caption {i}") for i in range(n)]

    def tokenizer(captions):
        return np.array([[int(c.split()[1])] for c in captions], np.int32)

    def take(rank, steps=5):
        decoded.clear()
        out = train_data.caption_batches(segments, tokenizer, batch, 2,
                                         epochs=50, rank=rank, world=world)
        got = [next(out) for _ in range(steps)]
        return got, set(decoded)

    ranks = [take(r) for r in range(world)]
    for images, tokens in (b for got, _ in ranks for b in got):
        assert images.shape[0] == tokens.shape[0] == batch // world
        assert (images[:, 0, 0, 0] * 255 == tokens[:, 0]).all()
    for got, seen in ranks:   # a rank decodes the frames it yields alone
        assert seen <= {int(t) for _, tokens in got for t in tokens[:, 0]
                        } | set(drop)
    if drop:
        assert all(drop[0] not in tokens for got, _ in ranks
                   for _, tokens in got)
        return
    one = train_data.caption_batches(segments, tokenizer, batch, 2,
                                     epochs=50)
    for step in range(5):
        want = next(one)[1][:, 0]
        got = np.concatenate([ranks[r][0][step][1][:, 0]
                              for r in range(world)])
        np.testing.assert_array_equal(got, want)

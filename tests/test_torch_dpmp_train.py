"""Data and tensor parallelism together in the port: the train CLI at
``--dp 2 --mp 2`` (four gloo ranks, rank d * 2 + m) and ``CLIPTrainer(...,
mp=2)`` in a world of four, against the port's single-process trainer and
the JAX package's ``CLIPTrainer`` on a ``get_mesh(dp=2, mp=2)``, on the CPU.

One spawn of four ranks: each runs the CLI's own rank entry (three steps of
a tiny registry model on seeded stand-ins), then, in the same process group,
three steps of a tiny CLIP, f32, from one flax tree, on its 'dp' rank's
half of a global batch of 8 (both 'mp' ranks of a 'dp' rank the same rows).
What is held:

- losses, the first step's gradients (gathered whole by 'mp' rank 0 of each
  'dp' rank) and the parameters after three steps within 1e-5 of the single
  process at the global batch (the key third of an in-projection's bias as
  tests/test_torch_mp_train.py ``key_bias_apart`` holds it); both 'dp'
  ranks' whole trees the same;
- the same against the JAX trainer stepped on the dp = 2, mp = 2 mesh from
  the same tree and batches, at tests/test_torch_dp_train.py's tolerances
  (losses 1e-4 relative, parameters 5e-5): the 'dp' group's DDP and
  ``gather_rows`` and the shard-aware clip together, against the reference;
- a replicated leaf's gradient the same on all four ranks, a sharded leaf's
  the same on the two ranks of its 'mp' index and their slice of the single
  process's;
- the CLI: one ``step_00000003`` checkpoint in the one-process format,
  within 1e-5 of the single-process CLI's.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_dp_train import (CLIP_NORM, LR, TINY, TOTAL, WARMUP, WD,
                                 _batches, _cli_args, _close, _stand_ins)
from test_torch_mp_train import key_bias_apart
from wise_tpu_torch.models.clip.config import CLIPConfig
from wise_tpu_torch.parallel import distributed as TD
from wise_tpu_torch.parallel import train as TT

DP, MP, GLOBAL, TOL = 2, 2, 8, 1e-5
OUT_ENV = "WISE_TEST_DPMP_DIR"


def _trainer(params, mp=1):
    return TT.CLIPTrainer(
        CLIPConfig(**TINY, dtype="float32"), device="cpu", learning_rate=LR,
        weight_decay=WD, warmup_steps=WARMUP, total_steps=TOTAL,
        grad_clip=CLIP_NORM, mp=mp).init(params=params)


def _run(trainer, batches, rows=slice(None)):
    losses, grads, local = [], None, None
    for i, (images, tokens) in enumerate(batches):
        losses.append(float(trainer.train_step(images[rows], tokens[rows])))
        if i == 0:
            local = {k: g.detach().clone()
                     for k, g in trainer.grads().items()}
            grads = trainer.whole(local)
    return {"losses": losses, "params": trainer.whole(trainer.params),
            "grads": grads, "local": local}


def _cli_rank(argv) -> None:
    """The CLI's rank entry, then three trainer steps on the rank's rows."""
    import torch.distributed as dist

    from wise_tpu_torch.cli import train

    _stand_ins(dict.__setitem__, setattr)
    train._rank_main(argv)
    out_dir = Path(os.environ[OUT_ENV])
    state = torch.load(out_dir / "inputs.pt", weights_only=True)
    trainer = _trainer(state["params"], MP)
    assert (trainer.dp, trainer.mp, dist.get_backend()) == (DP, MP, "gloo")
    b = GLOBAL // DP
    rows = slice(trainer.dp_rank * b, (trainer.dp_rank + 1) * b)
    out = _run(trainer, list(zip(state["images"], state["tokens"])), rows)
    torch.save(out, out_dir / f"rank{trainer.rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One flax tree from the JAX trainer on a dp = 2, mp = 2 mesh. The CLI
    at --dp 2 --mp 2 (whose ranks then run the trainer's steps) runs in a
    thread while the JAX trainer steps the tree here and the port's
    single-process trainer and CLI run beside it. JAX is imported here: the
    ranks import this module by name and need none of it."""
    import jax
    import jax.numpy as jnp

    from wise_tpu.models.clip import model as JM
    from wise_tpu.parallel import train as JT
    from wise_tpu.parallel.mesh import get_mesh
    from wise_tpu_torch.cli import train
    from wise_tpu_torch.models.clip.convert import from_flax_params

    tmp = tmp_path_factory.mktemp("dpmp")
    (tmp / "p").mkdir()
    mesh = get_mesh(dp=DP, mp=MP, devices=jax.devices()[:DP * MP])
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
        # the ranks in a thread, the single process beside them
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(train.main, _cli_args(
                tmp / "dpmp", "--dp", "2", "--mp", "2"))
            step = jt.make_train_step()
            jax_losses = []
            for images, tokens in batches:
                params, opt_state, loss = step(params, opt_state,
                                               jnp.asarray(images.numpy()),
                                               jnp.asarray(tokens.numpy()))
                jax_losses.append(float(loss))
            one_cli = train.main(_cli_args(tmp / "one", "--dp", "1"))
            one = _run(_trainer(tree), batches)
            rc = ranks.result()
    return {"jax": (jax_losses,
                    from_flax_params(jax.tree.map(np.asarray, params))),
            "rc": (rc, one_cli), "tmp": tmp, "one": one,
            "ranks": [torch.load(tmp / f"rank{r}.pt", weights_only=True)
                      for r in range(DP * MP)]}


def test_four_ranks_match_one_process(runs):
    want = runs["one"]
    for r in (0, 2):   # 'mp' rank 0 of each 'dp' rank holds the whole tree
        got = runs["ranks"][r]
        assert got["losses"] == pytest.approx(want["losses"], rel=0, abs=TOL)
        assert not _close(got["grads"], want["grads"])
        assert not key_bias_apart(got["params"], want["params"],
                                  want["grads"], 3, LR)
    assert not _close(runs["ranks"][2]["params"], runs["ranks"][0]["params"],
                      tol=0.0)
    assert runs["ranks"][1]["params"] is None


def test_four_ranks_match_the_jax_trainer_on_a_dp2_mp2_mesh(runs):
    want_losses, want = runs["jax"]
    for r in (0, 2):
        got = runs["ranks"][r]
        assert got["losses"] == pytest.approx(want_losses, rel=1e-4)
        assert set(got["params"]) == set(want)
        assert not _close(got["params"], want, tol=5e-5)


def test_leaves_are_replicated_or_the_ranks_slices(runs):
    want = runs["one"]["grads"]
    local = [r["local"] for r in runs["ranks"]]
    for key, g in local[0].items():
        if not TT._spec_for_path(key, g):
            assert all(torch.equal(g, other[key]) for other in local), key
            continue
        for rank, grads in enumerate(local):
            m = rank % MP
            piece = TT._shard_leaf(key, want[key], TD.TensorParallel(MP, m))
            assert not _close({key: grads[key]}, {key: piece}), (key, rank)


def test_train_cli_at_dp_2_mp_2_writes_the_whole_tree(runs):
    tmp = runs["tmp"]
    assert runs["rc"] == (0, 0)
    assert TT.checkpoint_steps(tmp / "dpmp") == [3]
    _, got, _ = TT.restore_train_checkpoint(tmp / "dpmp")
    _, want, _ = TT.restore_train_checkpoint(tmp / "one")
    assert set(got) == set(want) and not _close(got, want)

"""The control at each cell's own size, on the card: the reference in float8
linear layers, put in the program's place, fails the cell's limits on three
seeds (for the training cell, so do the planted faults it is held
against). Run on a card machine:

    python -m pytest h100bench/tests/test_h100bench_control.py -m cuda
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

import pytest

SEEDS = (2_147_483_659, 2_300_000_011, 2_450_000_003)


def _ctx(cell_name, seed, card):
    from h100bench import run as R
    from h100bench.harness import Ctx, limits_of

    _, config, traffic, _ = R.load_cell(cell_name)
    tmp = Path(tempfile.mkdtemp(prefix="h100bench-control-"))
    os.environ["WISE_CHECKPOINT_DIR"] = str(tmp / "no-checkpoints")
    ctx = Ctx(seed=seed, seconds=1.0, trace=False, device=card,
              config=config, traffic=traffic, limits=limits_of(cell_name),
              tmp=tmp, t_start=time.perf_counter())
    return R.driver(traffic["driver"]), ctx


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["xlmr-vith14.ingest",
                                  "siglip-l16-384.ingest"])
@pytest.mark.parametrize("seed", SEEDS)
def test_ingest_control_fails(card, cell, seed):
    drv, ctx = _ctx(cell, seed, card)
    try:
        got = drv.control(ctx, ctx.traffic["sample"])
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    assert got["cos_gap_max"] > ctx.limits["cos_gap_max"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_finetune_control_and_faults_fail(card, seed):
    drv, ctx = _ctx("xlmr-vith14.finetune", seed, card)
    try:
        got = drv.control(ctx)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    for kind, numbers in got.items():
        assert any(numbers[k] > limit for k, limit in ctx.limits.items()), \
            kind

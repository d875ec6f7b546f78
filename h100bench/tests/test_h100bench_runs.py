"""Whole runs of tiny cells on the CPU, through the program's plain paths:
the result line's keys, the per-layer readers, and correct runs."""

from __future__ import annotations

import json

import pytest

from conftest import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,e2e", [
    ("tiny.ingest", "frames_per_s"),
    ("tinymap.ingest", "frames_per_s"),
    ("tiny.finetune", "train_samples_per_s"),
])
def test_run_is_correct_and_its_line_complete(tiny, cell, e2e):
    root, bench = tiny
    outcome, line = run_cell(root, bench, cell)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {e2e, "setup_s"}
    assert line["metrics"][e2e]["value"] > 0
    assert line["attempted"] > 0 and line["failed"] == 0
    json.dumps(line)


@pytest.mark.parametrize("cell,names", [
    ("tiny.ingest", {"host_ms_per_batch.ingest", "mfu.ingest"}),
    ("tiny.finetune", {"mfu.train"}),
])
def test_traced_run_reads_the_layers_it_can(tiny, cell, names):
    """On the CPU the trace holds no device event: the device readers
    return nothing and are left out; the host ones read."""
    root, bench = tiny
    _, line = run_cell(root, bench, cell, trace=1)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == names
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"

"""What a run loads: no JAX and no JAX package in the harness and the port's
modules it drives; nothing of the program in the reference. Each in a fresh
interpreter, whose modules are compared by their whole top-level name."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=300, check=True,
        env={"PATH": "/usr/bin:/bin", "WISE_TORCH_DEVICE": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_what_it_drives_load_no_jax():
    body = """
from h100bench import run as R
spec = json.load(open(R.ROOT / "BENCHMARK.json"))
for w in spec["workloads"]:
    cell, config, traffic, _ = R.load_cell(w["name"])
    R.driver(traffic["driver"])
for m in spec["per_layer"]:
    R.reader(m["name"])
import wise_tpu_torch.models.clip.extractor
import wise_tpu_torch.pipeline.extract
import wise_tpu_torch.parallel.train
import wise_tpu_torch.cli.train
"""
    loaded = _loaded(body)
    assert "wise_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "wise_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("from h100bench import reference, weights, frames, flops")
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "wise_tpu",
                         "wise_tpu_torch"}


def test_the_check_compares_whole_names(monkeypatch):
    from h100bench import run as R

    monkeypatch.setitem(sys.modules, "wise_tpu_torch_x", sys)
    assert "wise_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in R.forbidden_modules()


def _run(cwd):
    return subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "xlmr-vith14.ingest", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""

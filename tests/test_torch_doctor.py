"""The port's doctor CLI (wise_tpu_torch/cli/doctor.py) on the CPU, and its
profiler hook (wise_tpu_torch/utils/profiling.py ``trace``).

With WISE_TORCH_DEVICE=cpu and no card, no nvcc: the card line and the
kernel lines (nvcc, the kernel library) print FAIL and the exit code is 1,
as the reference's is when any line fails; the product runs on the device
the port's entry points would use (the CPU here) and passes, as do the
native decoder, FTS5 and OpenCV, which this machine has. With
``--project-dir`` the project lines read an extracted project through the
port's own store and DB.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from wise_tpu_torch.cli import doctor
from wise_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def _lines(out):
    return {ln[6:].split(":")[0]: ln[:4] for ln in out.splitlines()
            if ln[:4] in ("PASS", "FAIL")}


def test_doctor_on_the_cpu_fails_the_card_and_kernel_lines():
    run = subprocess.run(
        [sys.executable, "-m", "wise_tpu_torch.cli.doctor"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), "WISE_TORCH_DEVICE": "cpu",
             "CUDA_HOME": "", "CUDA_PATH": ""})
    lines = _lines(run.stdout)
    assert lines == {
        "native FFmpeg decoder": "PASS", "cuda devices": "FAIL",
        "device compute": "PASS", "nvcc": "FAIL", "kernel library": "FAIL",
        "sqlite FTS5": "PASS", "opencv": "PASS"}, run.stdout
    assert run.returncode == 1
    assert "no CUDA device" in run.stdout
    assert "matmul ok on cpu" in run.stdout


def test_doctor_reads_a_project(monkeypatch, tmp_path, capsys):
    """An extracted project (the random-features extractor: no model) gives
    PASS for its assets and DB; a directory that is no project fails the DB
    line."""
    from tests.media_fixtures import make_image
    from wise_tpu_torch.cli import extract_features

    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    media = tmp_path / "media"
    media.mkdir()
    for i in range(3):
        make_image(media / f"i{i}.png", value=40 + 20 * i)
    proj = tmp_path / "proj"
    fid = "wise/random_features/8/test"
    extract_features.main([str(media), "--project-dir", str(proj),
                           "--image-feature-id", fid,
                           "--video-feature-id", fid])
    checks = dict(doctor.project_checks(str(proj)))
    assert doctor.check("project assets", checks["project assets"])
    assert doctor.check("project db", checks["project db"])
    out = capsys.readouterr().out
    assert "PASS  project assets: 1 feature assets" in out
    empty = dict(doctor.project_checks(str(tmp_path / "none")))
    assert not doctor.check("project db", empty["project db"])


def test_trace_writes_a_chrome_trace_when_asked(monkeypatch, tmp_path):
    import torch

    monkeypatch.delenv("WISE_TRACE_DIR", raising=False)
    with profiling.trace("off"):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("WISE_TRACE_DIR", str(tmp_path))
    with profiling.trace("batch"):
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    files = list((tmp_path / "batch").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("label", ["a", "b"])
def test_trace_is_a_no_op_without_the_variable(monkeypatch, label):
    monkeypatch.delenv("WISE_TRACE_DIR", raising=False)
    with profiling.trace(label):
        value = 1
    assert value == 1

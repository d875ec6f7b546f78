"""A cell, a configuration and a per-layer metric are added as new files and
new entries alone: the harness finds them by name, and no file that was
there changes."""

from __future__ import annotations

import hashlib
import json

from conftest import run_cell


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_config_and_metric_are_files_and_entries(tiny):
    root, bench = tiny
    before = _digests(bench)
    before.pop(root / "BENCHMARK.json", None)
    config = json.loads((bench / "configs" / "tiny.json").read_text())
    config = dict(config, name="tiny2")
    (bench / "configs" / "tiny2.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "tiny-ingest.json").read_text())
    traffic.update(batch_size=4, clip_frames=4)
    (bench / "traffic" / "tiny-ingest-b4.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tiny2.ingest-b4.json").write_text(
        json.dumps({"limits": {"rows_wrong": 0.0, "cos_gap_max": 1e-3}}))
    (bench / "metrics" / "batches_seen.ingest.py").write_text(
        "def read(r):\n    return float(r['batches']) or None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny2", "source": "test", "reduced": [],
                            "why": "test",
                            "file": "h100bench/configs/tiny2.json"})
    spec["workloads"].append({"name": "tiny2.ingest-b4", "config": "tiny2",
                              "traffic": "tiny-ingest-b4", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny.ingest" in m.get("workloads", []):
            m["workloads"].append("tiny2.ingest-b4")
    spec["per_layer"].append({"name": "batches_seen.ingest", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "ingest driver",
                              "moves": "frames_per_s",
                              "workloads": ["tiny2.ingest-b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    outcome, line = run_cell(root, bench, "tiny2.ingest-b4", trace=1)
    assert line["correct"], line["checks"]
    assert line["metrics"]["batches_seen.ingest"]["value"] >= 1
    assert outcome.readings["batch_size"] == 4
    after = _digests(bench)
    assert {p: after[p] for p in before} == before

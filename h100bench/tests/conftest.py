"""Fixtures of the benchmark's own tests.

``tiny`` lays out a checkout of the benchmark in a temporary directory, with
tiny configurations, traffic and limits beside the real ones, so that a
whole run goes through on the CPU with the program's plain paths
(``WISE_TORCH_DEVICE=cpu``). Whether a card is there is decided in the
``card`` fixture, never while a module is imported.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the tiny towers' shapes (head_dim 16)
TINY_VISION = dict(image_size=32, patch_size=16, width=64, layers=2,
                   heads=4, mlp_width=256, embed_dim=32)
TINY_TEXT = dict(width=64, layers=2, heads=4, mlp_width=256,
                 vocab_size=4096, context_length=16, embed_dim=32)
#: the port's registry entries of the tiny stand-ins: the default
#: backbone's kind (class-token vision, XLM-R text) and SigLIP's (MAP)
TINY_XLMR, TINY_MAP = "xlm-roberta-tiny-test", "siglip-tiny-test"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without a CUDA device)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _tiny_port_config(map_pool: bool = False):
    from wise_tpu_torch.models.clip.config import CLIPConfig

    v, t = TINY_VISION, TINY_TEXT
    if map_pool:
        # SigLIP's head has no projection: the joint space is the width
        return CLIPConfig(
            embed_dim=v["width"], image_size=v["image_size"],
            patch_size=v["patch_size"], vision_width=v["width"],
            vision_layers=v["layers"], vision_heads=v["heads"],
            context_length=t["context_length"], vocab_size=1024,
            text_width=t["width"], text_heads=t["heads"],
            text_layers=t["layers"], vision_pool="map", text_causal=False,
            text_pool="last", act="gelu_tanh", text_proj_bias=True)
    return CLIPConfig(
        embed_dim=v["embed_dim"], image_size=v["image_size"],
        patch_size=v["patch_size"], vision_width=v["width"],
        vision_layers=v["layers"], vision_heads=v["heads"],
        context_length=t["context_length"], vocab_size=t["vocab_size"],
        text_width=t["width"], text_heads=t["heads"],
        text_layers=t["layers"], text_tower="hf_xlm_roberta",
        hf_proj_type="mlp")


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(root, bench) of a checkout whose BENCHMARK.json holds three tiny
    cells: ``tiny.ingest`` (a class-token tower), ``tinymap.ingest`` (a MAP
    tower) and ``tiny.finetune``."""
    from wise_tpu_torch.models.clip import config as clip_config

    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    monkeypatch.setitem(clip_config.CLIP_CONFIGS, TINY_XLMR,
                        _tiny_port_config())
    monkeypatch.setitem(clip_config.CLIP_CONFIGS, TINY_MAP,
                        _tiny_port_config(map_pool=True))
    src = ROOT / "h100bench"
    bench = tmp_path / "h100bench"
    shutil.copytree(src, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((src / "configs" / "xlmr-vith14.json").read_text())
    cls = dict(base, name="tiny")
    cls["port"] = dict(base["port"], model=TINY_XLMR,
                       extractor_id=f"mlfoundations/open_clip/{TINY_XLMR}/x")
    cls["shapes"] = {"vision": dict(base["shapes"]["vision"], **TINY_VISION),
                     "text": dict(base["shapes"]["text"], **TINY_TEXT)}
    sig = json.loads((src / "configs" / "siglip-l16-384.json").read_text())
    tmap = dict(sig, name="tinymap")
    tmap["shapes"] = {"vision": dict(sig["shapes"]["vision"], **dict(
        TINY_VISION, embed_dim=TINY_VISION["width"]))}
    tmap["port"] = dict(sig["port"], model=TINY_MAP,
                        extractor_id=f"mlfoundations/open_clip/{TINY_MAP}/x")
    for c in (cls, tmap):
        (bench / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    ingest = json.loads((src / "traffic" / "ingest.json").read_text())
    ingest.update(batch_size=8, clip_frames=8, pool_batches=2, sample=6,
                  warmup_clips=1)
    (bench / "traffic" / "tiny-ingest.json").write_text(json.dumps(ingest))
    tune = json.loads((src / "traffic" / "finetune.json").read_text())
    tune.update(batch_size=8, pool_batches=4, caption_tokens=[4, 12])
    (bench / "traffic" / "tiny-finetune.json").write_text(json.dumps(tune))
    limits = {"tiny.ingest": {"rows_wrong": 0.0, "cos_gap_max": 1e-3},
              "tinymap.ingest": {"rows_wrong": 0.0, "cos_gap_max": 1e-3},
              "tiny.finetune": {"loss_gap_max": 1e-2,
                                "grad_norm_gap_max": 5e-2,
                                "change_norm_gap_median": 0.5}}
    for cell, lim in limits.items():
        (bench / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": lim}))
    spec["configs"] = [
        {"name": "tiny", "source": "test", "reduced": [], "why": "test",
         "file": "h100bench/configs/tiny.json"},
        {"name": "tinymap", "source": "test", "reduced": [], "why": "test",
         "file": "h100bench/configs/tinymap.json"}]
    spec["workloads"] = [
        {"name": "tiny.ingest", "config": "tiny", "traffic": "tiny-ingest",
         "chips": 1, "why": "test"},
        {"name": "tinymap.ingest", "config": "tinymap",
         "traffic": "tiny-ingest", "chips": 1, "why": "test"},
        {"name": "tiny.finetune", "config": "tiny",
         "traffic": "tiny-finetune", "chips": 1, "why": "test"}]
    renamed = {"xlmr-vith14.ingest": ["tiny.ingest", "tinymap.ingest"],
               "siglip-l16-384.ingest": [],
               "xlmr-vith14.finetune": ["tiny.finetune"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({n for w in m["workloads"]
                                     for n in renamed[w]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path, bench


def run_cell(root, bench, cell, seed=3_000_000_019, seconds=0.5, trace=0):
    """One run of ``cell`` on the CPU: (outcome, result line)."""
    import torch
    from h100bench import run as R

    args = R.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", str(trace)])
    outcome, c, spec = R.execute(args, torch.device("cpu"), root, bench)
    line = R.result_line(outcome, c, spec, bool(trace),
                         {"platform": "cpu", "kind": "cpu", "count": 1,
                          "memory_peak_bytes": outcome.memory_peak_bytes},
                         bench)
    return outcome, line

"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU runs the program's plain
paths) and the rest of a run goes through, once for each fault the cell can
have. The exchange between chips has no fault to plant: every cell runs on
one card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import run_cell


def _broken_embed(monkeypatch, how):
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    real = OpenClipExtractor.extract_image_features

    def broken(self, images):
        out = real(self, images)
        if how == "answer_altered":
            out = np.roll(out, 1, axis=0)
        elif how == "half_batch":
            half = len(out) // 2
            out = np.concatenate([out[:half], out[:len(out) - half]])
        return out

    monkeypatch.setattr(OpenClipExtractor, "extract_image_features", broken)


@pytest.mark.parametrize("cell", ["tiny.ingest", "tinymap.ingest"])
@pytest.mark.parametrize("how", ["answer_altered", "half_batch"])
def test_ingest_fault_is_not_correct(tiny, monkeypatch, cell, how):
    root, bench = tiny
    _broken_embed(monkeypatch, how)
    _, line = run_cell(root, bench, cell)
    assert not line["correct"]
    assert line["checks"]["cos_gap_max"]["value"] > \
        line["checks"]["cos_gap_max"]["limit"]


def test_ingest_rows_altered_is_not_correct(tiny, monkeypatch):
    from wise_tpu_torch.db.repository import VectorRepo

    real = VectorRepo.insert_rows

    def shifted(self, conn, rows, id_base=0):
        rows = [(m, mid, t + 0.5, e) for m, mid, t, e in rows]
        return real(self, conn, rows, id_base)

    monkeypatch.setattr(VectorRepo, "insert_rows", shifted)
    root, bench = tiny
    _, line = run_cell(root, bench, "tiny.ingest")
    assert not line["correct"] and line["checks"]["rows_wrong"]["value"] > 0


def test_step_that_leaves_the_state_unchanged_is_not_correct(tiny,
                                                             monkeypatch):
    from wise_tpu_torch.parallel.train import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: None)
    root, bench = tiny
    _, line = run_cell(root, bench, "tiny.finetune")
    assert not line["correct"]
    c = line["checks"]["change_norm_gap_median"]
    assert c["value"] > c["limit"]


def test_half_the_batch_left_out_is_not_correct(tiny, monkeypatch):
    from wise_tpu_torch.parallel.train import CLIPTrainer, clip_loss

    def half(self, images, tokens):
        n = images.shape[0] // 2
        img, txt, scale = self._forward(images[:n], tokens[:n])
        return clip_loss(img, txt, scale)

    monkeypatch.setattr(CLIPTrainer, "loss", half)
    root, bench = tiny
    _, line = run_cell(root, bench, "tiny.finetune")
    assert not line["correct"]
    c = line["checks"]["loss_gap_max"]
    assert c["value"] > c["limit"]


def test_control_reads_above_the_program(tiny):
    """The control (the reference in float8 linear layers) against the
    float32 reference reads well above what the program's bf16 path reads,
    at the tiny size too."""
    import h100bench.run as R
    from h100bench.harness import Ctx, limits_of

    root, bench = tiny
    _, line = run_cell(root, bench, "tiny.ingest")
    _, config, traffic, _ = R.load_cell("tiny.ingest", root, bench)
    ctx = Ctx(seed=3_000_000_019, seconds=0.5, trace=False,
              device=torch.device("cpu"), config=config,
              traffic=traffic, limits=limits_of("tiny.ingest", bench),
              tmp=root, t_start=0.0)
    control = R.driver("ingest", bench).control(ctx, 6)
    assert control["cos_gap_max"] > 3 * line["checks"]["cos_gap_max"]["value"]

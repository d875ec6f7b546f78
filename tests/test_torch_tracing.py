"""The port's spans (wise_tpu_torch/utils/profiling.py) on the CPU: off by
default, ``record_function`` ranges under ``torch.profiler``, counted under
``recording()``, bounded however many, and where the ingest pipeline, the
CLIP extractor and the trainer put them."""

import json
import tracemalloc
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wise_tpu_torch.utils import profiling

#: the port's spans, by name: the names are its contract with whoever
#: reads a trace or a recording
INGEST = ["wise.ingest.flush", "wise.ingest.canonicalise", "wise.ingest.db",
          "wise.ingest.store", "wise.ingest.decode"]
TOWER = "wise.extract.tower"
TRAIN = ["wise.train.forward", "wise.train.backward", "wise.train.optimizer"]
#: the spans inside each flush of a batch of frames
IN_FLUSH = ["wise.ingest.canonicalise", "wise.ingest.db", "wise.ingest.store",
            TOWER]


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", INGEST + [TOWER] + TRAIN)
def test_off_a_span_is_the_shared_null_context_and_counts_nothing(name):
    timer = profiling.timer()
    before = timer.count(name)
    ctx = profiling.span(name, torch.device("cpu"))
    assert ctx is profiling.span("another") is profiling._NULL
    with ctx:
        pass
    assert timer.count(name) == before


def test_a_recording_counts_host_time_and_the_enclosing_span():
    with profiling.recording() as timer:
        for _ in range(3):
            with profiling.span("outer"):
                with profiling.span("inner", torch.device("cpu")):
                    pass
        with profiling.span("inner"):
            pass
    assert timer is profiling.timer()
    assert (timer.count("outer"), timer.count("inner")) == (3, 4)
    assert timer.parents("inner") == {"outer", None}
    assert timer.parents("outer") == {None}
    assert timer.host_seconds("inner") >= 0.0
    # no CUDA device, no device time
    assert timer.device_seconds("inner") == [] and timer.device_ms("inner") is None
    summary = timer.summary()
    assert "inner=" in summary and "device" not in summary
    # the log names each span's enclosing spans; a top-level one has none
    assert "x[in outer|top]" in summary.split("inner=")[1]
    assert "[" not in summary.split("outer=")[1].split(" ")[0]
    # a new recording starts from nothing; after it, spans are off again
    with profiling.recording():
        assert timer.count("outer") == 0
    with profiling.span("outer"):
        pass
    assert timer.count("outer") == 0


class _Event:
    """A CUDA event's stand-in: passed once ``done`` is set."""

    clock = 0.0

    def __init__(self):
        self.done, self.at = False, None

    def record(self, stream):
        _Event.clock += 1.0
        self.at = _Event.clock

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.at - self.at


def test_spans_stay_bounded_and_device_times_resolve(monkeypatch):
    """10,000 spans leave the timer the size it had once its device times
    were full (a few KB of interpreter noise aside); device times are kept for the newest
    DEVICE_KEPT spans, resolved without waiting once the device has passed
    them, and at read time otherwise."""
    events = deque(maxlen=5)

    def fake(device):
        pair = (_Event(), _Event())
        events.append(pair)
        return pair + (None,)

    monkeypatch.setattr(profiling, "_device_events", fake)

    def spans(n):
        for _ in range(n):
            with profiling.span("outer"):
                with profiling.span("dev", "cuda"):
                    pass

    with profiling.recording() as timer:
        warm = 2 * profiling.DEVICE_KEPT + 100
        tracemalloc.start()
        try:
            spans(warm)
            base = tracemalloc.get_traced_memory()[0]
            spans(10_000)
            grown = tracemalloc.get_traced_memory()[0] - base
        finally:
            tracemalloc.stop()
        assert timer.count("dev") == warm + 10_000
        assert grown < 64 * 1024, grown
        st = timer._stats["dev"]
        # none passed yet: waiting starts only past DEVICE_KEPT pending
        assert len(st.pending) == profiling.DEVICE_KEPT
        assert len(st.device_s) == profiling.DEVICE_KEPT
        for start, end in events:
            end.done = True
        dev = timer.device_seconds("dev")
        assert len(dev) == profiling.DEVICE_KEPT and not st.pending
        assert dev == [1e-3] * profiling.DEVICE_KEPT
    # with the device ahead, a span resolves as it ends
    with profiling.recording() as timer:
        def passed(device):
            pair = (_Event(), _Event())
            pair[1].done = True
            return pair + (None,)

        monkeypatch.setattr(profiling, "_device_events", passed)
        spans(3)
        assert len(timer._stats["dev"].device_s) == 3
        assert timer.device_ms("dev") == pytest.approx(1.0)


def _tiny_embedder(tmp_path, batch):
    from wise_tpu_torch import config, data_models as dm, db, project, store
    from wise_tpu_torch.db import repository
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.pipeline.extract import (ExtractionStats,
                                                 _BatchedEmbedder)

    cfg = config.WiseConfig()
    proj = project.WiseProject(tmp_path / "project", create_project=True)
    conn = db.init_project(proj.db_path)
    sc = repository.SourceCollectionRepo().create(conn, dm.SourceCollection(
        location=str(tmp_path), type=dm.SourceCollectionType.DIR))
    media = repository.MediaRepo().create(conn, dm.MediaMetadata(
        source_collection_id=sc.id, path="a.mp4",
        media_type=dm.MediaType.VIDEO, format="mp4", width=32, height=32,
        num_frames=2 * batch, duration=2 * batch / 2.0))
    ext = OpenClipExtractor("mlfoundations/open_clip/ViT-Test-Tiny/x")
    st = store.FeatureStoreFactory.create_store(
        cfg.store.store_type, "video", proj.create_features_dir("tiny"))
    st.enable_write(cfg.store.shard_maxcount, cfg.store.shard_maxsize)
    stats = ExtractionStats()
    return (_BatchedEmbedder(ext, st, conn, dm.ModalityType.VIDEO, batch,
                             stats, "num_video_vectors"), media.id, st, stats)


def test_a_flush_under_the_profiler_encloses_its_parts(cpu, tmp_path):
    batch = 4
    embedder, mid, st, stats = _tiny_embedder(tmp_path, batch)
    frames = np.random.default_rng(0).integers(
        0, 255, (2 * batch, 48, 40, 3), dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        embedder.add_frames(mid, frames, np.arange(2 * batch) / 2.0)
    st.close()
    assert stats.frames_embedded == 2 * batch
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    flushes = [e for e in ranges if e["name"] == "wise.ingest.flush"]
    assert len(flushes) == 2
    for f in flushes:
        inside = {e["name"] for e in ranges
                  if e["ts"] >= f["ts"]
                  and e["ts"] + e["dur"] <= f["ts"] + f["dur"]}
        assert set(IN_FLUSH) <= inside, inside
    # under the profiler the spans count too, with their parents
    timer = profiling.timer()
    assert timer.parents("wise.ingest.store") >= {"wise.ingest.flush"}


def test_three_steps_count_three_of_each_training_span(cpu):
    from wise_tpu_torch.models.clip.config import CLIPConfig
    from wise_tpu_torch.parallel.train import CLIPTrainer

    cfg = CLIPConfig(embed_dim=16, image_size=32, patch_size=16,
                     vision_width=32, vision_layers=1, vision_heads=2,
                     context_length=8, vocab_size=64, text_width=32,
                     text_heads=2, text_layers=1)
    trainer = CLIPTrainer(cfg, device="cpu", grad_clip=1.0).init(seed=0)
    rng = np.random.default_rng(0)
    images = rng.random((4, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 63, (4, 8))
    with profiling.recording() as timer:
        for _ in range(3):
            trainer.train_step(images, tokens)
    for name in TRAIN:
        assert timer.count(name) == 3
        assert timer.parents(name) == {None}
        assert timer.device_seconds(name) == []
        assert timer.host_seconds(name) > 0
    from wise_tpu_torch.cli.train import step_split

    assert step_split(timer).endswith("host ms a step, over 3 steps")


def test_extract_features_writes_a_trace_of_its_flushes(cpu, monkeypatch,
                                                        tmp_path, caplog):
    import logging

    from tests.media_fixtures import make_image
    from wise_tpu_torch.pipeline.extract import extract_features

    media = tmp_path / "media"
    media.mkdir()
    for i in range(3):
        make_image(media / f"i{i}.png", value=40 + 20 * i)
    monkeypatch.setenv("WISE_TRACE_DIR", str(tmp_path / "traces"))
    fid = "wise/random_features/8/test"
    with caplog.at_level(logging.INFO):
        stats = extract_features([str(media)], tmp_path / "proj",
                                 image_feature_id=fid, video_feature_id=fid,
                                 batch_size=2)
    assert stats.num_image_vectors == 3
    files = list((tmp_path / "traces" / "extract").glob("trace_*.json"))
    assert len(files) == 1
    names = [e.get("name") for e in
             json.loads(files[0].read_text())["traceEvents"]]
    assert names.count("wise.ingest.flush") == 2
    assert "wise.ingest.decode" in names
    assert any("wise.ingest.flush=" in r.getMessage() and "/2x" in
               r.getMessage() for r in caplog.records)
    assert any("[in wise.ingest.flush]" in r.getMessage()
               for r in caplog.records)

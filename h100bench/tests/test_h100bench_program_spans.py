"""The readers of the port's own spans (program_spans.py and the metrics
that use it), on hand-made traces and a stand-in for the port's
StageTimer."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT

from h100bench import flops, tracing
from h100bench.run import reader

IDLE = {"canonicalise_idle_ms_per_batch.ingest": "wise.ingest.canonicalise",
        "db_idle_ms_per_batch.ingest": "wise.ingest.db",
        "store_idle_ms_per_batch.ingest": "wise.ingest.store"}
STEP = {"forward_ms_per_step.train": "wise.train.forward",
        "backward_ms_per_step.train": "wise.train.backward",
        "optimizer_ms_per_step.train": "wise.train.optimizer"}
TOWER = "tower_roofline.ingest"


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace(kernels=True):
    """A window of 0-1000 us: kernels at 0-100 and 600-1000, so one idle
    gap, 100-600 us, which the db span covers from 100 to 250 and the
    store span from 250 to 600 (its middle, 350, in the store span)."""
    events = [_x(tracing.WINDOW, "user_annotation", 0, 1000),
              _x("wise.ingest.flush", "user_annotation", 0, 1000),
              _x("wise.ingest.db", "user_annotation", 90, 160),
              _x("wise.ingest.store", "user_annotation", 250, 400)]
    if kernels:
        events += [_x("gemm_kernel", "kernel", 0, 100),
                   _x("gemm_kernel", "kernel", 600, 400)]
    return tracing.Trace(events)


def test_a_gap_across_two_spans_is_split_by_overlap():
    tr = _trace()
    assert tr._gaps == [(100, 600)]
    r = {"trace": tr, "batches": 2}
    db = reader("db_idle_ms_per_batch.ingest")(r)
    store = reader("store_idle_ms_per_batch.ingest")(r)
    assert db == pytest.approx(0.150 / 2)
    assert store == pytest.approx(0.350 / 2)
    # the midpoint's label takes the whole gap
    assert tr.idle_gaps() == [["wise.ingest.store (1 gaps)",
                               pytest.approx(500e-6)]]
    # the span is not in the trace: nothing, not 0
    assert reader("canonicalise_idle_ms_per_batch.ingest")(r) is None


@pytest.mark.parametrize("name", sorted(IDLE))
def test_idle_readers_read_nothing_without_device_events(name):
    assert reader(name)({"trace": None, "batches": 2}) is None
    assert reader(name)({"trace": _trace(kernels=False), "batches": 2}) is None
    assert reader(name)({"trace": _trace(), "batches": 0}) is None


class _Timer:
    """The port's StageTimer as the readers see it."""

    def __init__(self, device):
        self.device = device

    def device_seconds(self, name):
        return list(self.device.get(name, []))


@pytest.fixture
def port(monkeypatch):
    """Hand the readers a stand-in StageTimer: ``port({name: [s]})``."""
    from wise_tpu_torch.utils import profiling

    def install(device):
        monkeypatch.setattr(profiling, "timer", lambda: _Timer(device),
                            raising=False)
    return install


def _vision():
    return json.loads((ROOT / "h100bench" / "configs" / "xlmr-vith14.json")
                      .read_text())["shapes"]["vision"]


def test_tower_roofline_reads_the_last_batches_device_time(port):
    v = _vision()
    port({"wise.extract.tower": [9.0, 0.25, 0.25]})
    r = {"batches": 2, "frames": 512, "vision": v}
    want = 100 * 512 * flops.vision_forward_ops(v) / (0.5 * flops.PEAK_OPS)
    assert reader(TOWER)(r) == pytest.approx(want)
    # fewer spans than batches, or none: nothing
    assert reader(TOWER)(dict(r, batches=4)) is None
    port({})
    assert reader(TOWER)(r) is None


@pytest.mark.parametrize("name", sorted(STEP))
def test_step_readers_read_the_mean_of_the_last_steps(port, name):
    port({STEP[name]: [5.0, 0.010, 0.020, 0.030]})
    assert reader(name)({"steps": 3}) == pytest.approx(20.0)
    assert reader(name)({"steps": 5}) is None
    assert reader(name)({}) is None
    port({STEP[name]: []})
    assert reader(name)({"steps": 3}) is None


@pytest.mark.parametrize("name", sorted(STEP) + [TOWER])
def test_a_port_without_spans_reads_nothing(monkeypatch, name):
    """A program whose profiling module has no process-wide timer (the
    port before its spans) gives no number and raises nothing."""
    from wise_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "timer", raising=False)
    r = {"steps": 3, "batches": 2, "frames": 512, "vision": _vision()}
    assert reader(name)(r) is None

"""What a run passes between run.py, its driver and the metric readers.

A driver (``drivers/<name>.py``, named by the traffic file's ``driver``)
takes a ``Ctx`` and returns an ``Outcome``. run.py turns the outcome into
the result line; each per-layer metric's reader (``metrics/<name>.py``)
reads the outcome's ``readings``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass
class Ctx:
    seed: int
    seconds: float
    trace: bool
    device: object
    config: dict
    traffic: dict
    limits: dict
    tmp: Path
    t_start: float


@dataclasses.dataclass
class Check:
    """A number compared and its limit: it passes when ``value <= limit``
    (an exact comparison has the limit 0)."""

    name: str
    value: float
    limit: float

    @property
    def passes(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    #: end-to-end metric name -> value
    end_to_end: dict
    #: what the metric readers read: "trace" (a tracing.Trace or None),
    #: "spans" ({name: [seconds]}), counts and shapes by name
    readings: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    #: the driver's own reason when the run is not correct, else ""
    fault: str = ""


def sync(device) -> None:
    """Wait for the device's queue (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The process's peak of allocated device memory (0 on the CPU)."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def limits_of(cell: str, bench: Path = BENCH) -> dict:
    """The limits of a cell's compared numbers (``limits/<cell>.json``):
    {name: limit}."""
    with open(bench / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]

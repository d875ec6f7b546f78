"""What the port's own spans show in a traced run.

The port marks its layer boundaries with spans (``wise_tpu_torch/utils/
profiling.py``): under the profiler each is a ``record_function`` range in
the trace, and each counts into the port's ``StageTimer`` in this process,
with the device time between two CUDA events where the span names a card.
The readers here return None where there is nothing to read: a trace with
no device event (the CPU), a program without the span, or no device time.
"""

from __future__ import annotations

from h100bench.tracing import _union


def _overlap(gaps, ranges) -> float:
    """The length of the sorted, disjoint ``gaps`` that the sorted, merged
    ``ranges`` cover."""
    total, j = 0.0, 0
    for s, e in gaps:
        while j < len(ranges) and ranges[j][1] <= s:
            j += 1
        k = j
        while k < len(ranges) and ranges[k][0] < e:
            total += min(e, ranges[k][1]) - max(s, ranges[k][0])
            k += 1
    return total


def idle_ms_per_batch(r, name: str):
    """ms a batch of the traced window's idle time (no kernel, copy or
    memset on the card) inside the ranges of the span ``name``: each idle
    gap counts for the part of it that the span covers, so a gap that
    crosses two spans is split between them."""
    tr = r.get("trace")
    if tr is None or tr.busy_s <= 0 or not r.get("batches"):
        return None
    ranges = _union((s, e) for n, cat, s, e in tr._host
                    if n == name and cat == "user_annotation")
    if not ranges:
        return None
    return 1e-3 * _overlap(tr._gaps, ranges) / r["batches"]


def port_timer():
    """The port's process-wide ``StageTimer``, or None where the port has
    none."""
    try:
        from wise_tpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "timer", None)
    return get() if callable(get) else None


def device_seconds(name: str, last):
    """The device seconds of the last ``last`` spans ``name`` the port
    counted, or None where it has fewer (or none)."""
    timer = port_timer()
    if timer is None or not last:
        return None
    dev = timer.device_seconds(name)
    return dev[-last:] if len(dev) >= last else None

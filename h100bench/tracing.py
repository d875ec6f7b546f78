"""The benchmark's spans and its reading of the device trace.

``Spans`` times the benchmark's own calls into the program with the host
clock and, while the profiler runs, marks them in its trace
(``record_function``). ``profiled`` runs ``torch.profiler`` (CPU and CUDA
activity) around a region and writes its Chrome trace; ``read_trace``
reduces that trace to the device's timeline inside the window span:
kernels, copies, the busy union, the idle gaps and what the host was doing
in each.
"""

from __future__ import annotations

import contextlib
import json
import re
import time
from collections import defaultdict

#: the span that encloses the measured window in a traced run
WINDOW = "bench.window"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_CATS = {"user_annotation", "cpu_op"}


class Spans:
    """Host-clock seconds of named calls, in order; each call also marks a
    ``record_function`` range of its name for the profiler."""

    def __init__(self):
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(name):
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return timed


@contextlib.contextmanager
def profiled(path, enabled: bool):
    """torch.profiler over the region when ``enabled``, its Chrome trace
    written to ``path`` at the end; a no-op otherwise."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    parameter list, cut to 90 characters; a copy's or a memset's whole."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::",
                                                ""))
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name if len(name) <= 90 else name[:90] + "..."


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The device's timeline within the window span of a Chrome trace.
    Times in seconds; ``kernels`` and ``copies`` are (name, start, dur)."""

    def __init__(self, events):
        window = [e for e in events if e.get("name") == WINDOW
                  and e.get("cat") in _HOST_CATS and e.get("ph") == "X"]
        if not window:
            raise ValueError(f"the trace holds no {WINDOW!r} span")
        w0 = window[0]["ts"]
        w1 = w0 + window[0]["dur"]
        self.window_s = (w1 - w0) * 1e-6
        self.kernels, self.copies = [], []
        device = []
        host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat")
            s, d = e["ts"], e["dur"]
            if cat in _DEVICE_CATS:
                if s < w0 or s >= w1:
                    continue
                row = (e.get("name", ""), (s - w0) * 1e-6, d * 1e-6)
                (self.kernels if cat == "kernel" else self.copies).append(row)
                device.append((s, min(s + d, w1)))
            elif cat in _HOST_CATS and s < w1 and s + d > w0:
                host.append((e.get("name", ""), cat, s, s + d))
        busy = _union(device)
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        gaps, prev = [], w0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        self._gaps = gaps
        self._host = host

    def time_of(self, pattern: str) -> float:
        """Seconds of the kernels whose name matches ``pattern`` (re)."""
        rx = re.compile(pattern)
        return sum(d for n, _, d in self.kernels if rx.search(n))

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time,
        summed by short name."""
        total = defaultdict(float)
        for n, _, d in self.kernels + self.copies:
            total[short_name(n)] += d
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[[label, seconds]]: the window's idle time summed by what the
        host was doing at each gap's middle, the largest first. A label is
        the innermost benchmark or library span there, and after ``>`` the
        outermost host operation inside it; it carries its count of
        gaps."""
        total, count = defaultdict(float), defaultdict(int)
        host = sorted((h for h in self._host if h[0] != WINDOW),
                      key=lambda h: h[2])
        active, i = [], 0
        for s, e in sorted(self._gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (s + e)
            while i < len(host) and host[i][2] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[3] > mid]
            spans = [h for h in active if h[1] == "user_annotation"]
            span = min(spans, key=lambda h: h[3] - h[2], default=None)
            ops = [h for h in active if h[1] == "cpu_op"
                   and (span is None or h[2] >= span[2])]
            op = max(ops, key=lambda h: h[3] - h[2], default=None)
            label = " > ".join(h[0] for h in (span, op) if h is not None)
            label = label or "host: no span"
            total[label] += (e - s) * 1e-6
            count[label] += 1
        return [[f"{n} ({count[n]} gaps)", s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def read_trace(path) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events)

"""Device ms a batch of host-to-device and device-to-host copies (the
extractor's frames in, its vectors out), from the profiler's memcpy events
in the traced window."""


def read(r):
    tr = r.get("trace")
    if tr is None or not r.get("batches"):
        return None
    s = sum(d for name, _, d in tr.copies
            if "HtoD" in name or "DtoH" in name)
    return 1e3 * s / r["batches"] if s > 0 else None

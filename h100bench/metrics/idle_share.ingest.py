"""The share of the traced window in which no kernel, copy or memset ran on
the card (the union of the profiler's device events); nothing where the
trace holds no device event."""


def read(r):
    tr = r.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

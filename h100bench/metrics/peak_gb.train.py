"""Peak allocated device memory over the training window (after
torch.cuda.reset_peak_memory_stats at its start), in GB (1e9 bytes)."""


def read(r):
    peak = r.get("window_peak_bytes")
    return peak / 1e9 if peak else None

"""The vision tower's share of the card's bf16 peak while it runs: the
forward operations of the window's frames (flops.vision_forward_ops) over
the device time of the window's batches in the port's
``wise.extract.tower`` span (CUDA events around the tower's forward) times
989 TFLOP/s. Unlike mfu.ingest, the card's idle time between batches is
left out, and no kernel is found by name."""

from h100bench import flops, program_spans


def read(r):
    dev = program_spans.device_seconds("wise.extract.tower", r.get("batches"))
    if not dev or sum(dev) <= 0:
        return None
    ops = r["frames"] * flops.vision_forward_ops(r["vision"])
    return 100.0 * ops / (sum(dev) * flops.PEAK_OPS)

"""The ingest window's share of the card's bf16 peak: the forward
operations of the window's frames through the vision tower, counted from
the configuration's shapes (flops.vision_forward_ops), over the window's
seconds times 989 TFLOP/s (H100 SXM, dense)."""

from h100bench import flops


def read(r):
    if not r.get("frames") or not r.get("window_s"):
        return None
    ops = r["frames"] * flops.vision_forward_ops(r["vision"])
    return 100.0 * ops / (r["window_s"] * flops.PEAK_OPS)

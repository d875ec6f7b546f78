"""The training window's share of the card's bf16 peak: 3 x the forward
operations of its samples (the vision tower at the image size, the text
tower at each caption's own length; flops.py) over the window's seconds
times 989 TFLOP/s (H100 SXM, dense)."""

from h100bench import flops


def read(r):
    if not r.get("samples") or not r.get("window_s"):
        return None
    ops = r["samples"] * flops.vision_forward_ops(r["vision"])
    ops += sum(flops.text_forward_ops(r["text"], n)
               for n in r["caption_lengths"])
    return 100.0 * 3 * ops / (r["window_s"] * flops.PEAK_OPS)

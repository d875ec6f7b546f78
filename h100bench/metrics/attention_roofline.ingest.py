"""The attention middles' share of their roofline in the traced window: the
least time of the vision tower's attention (4 * rows * keys * D
operations; q, k, v and out once in bf16; the pooled last layer from its
class row), over the window's batches, divided by the device time of the
kernels named below (csrc/attention.cuh attention_kernel<HD>,
csrc/block_kernels.cu attention_pooled_kernel<HD>)."""

from h100bench import flops

KERNELS = r"(^|\W)attention(_pooled)?_kernel\b"


def read(r):
    tr = r.get("trace")
    if tr is None or not r.get("batches"):
        return None
    spent = tr.time_of(KERNELS)
    if spent <= 0:
        return None
    least_ms = flops.work_ms(
        flops.vision_attention(r["vision"], r["batch_size"]))
    return 100.0 * least_ms * 1e-3 * r["batches"] / spent

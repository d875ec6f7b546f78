"""The block GEMMs' share of their roofline in the traced window: the least
time of the vision tower's block products (qkv, out-proj, fc, proj; the
pooled last layer's k, v, q and out-proj), each max(2 M K N / 989 TFLOP/s,
(A + B + C bytes) / 3.35 TB/s), over the window's batches, divided by the
device time of the kernels named below (csrc/common.cuh gemm_kernel)."""

from h100bench import flops

KERNELS = r"(^|\W)gemm_kernel\b"


def read(r):
    tr = r.get("trace")
    if tr is None or not r.get("batches"):
        return None
    spent = tr.time_of(KERNELS)
    if spent <= 0:
        return None
    least_ms = flops.product_ms(
        flops.vision_products(r["vision"], r["batch_size"]))
    return 100.0 * least_ms * 1e-3 * r["batches"] / spent

"""OpenCLIP towers on the port's kernels (wise_tpu/models/clip)."""

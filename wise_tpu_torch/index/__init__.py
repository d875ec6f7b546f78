"""Search indices of the port (wise_tpu/index)."""

"""Feature extractors of the port (wise_tpu/models)."""

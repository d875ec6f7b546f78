"""Offline ingestion on the port's extractors (wise_tpu/pipeline)."""

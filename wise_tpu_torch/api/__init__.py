"""Online search engine and REST server on the port's indices
(wise_tpu/api)."""

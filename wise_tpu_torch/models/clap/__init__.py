"""CLAP 2023 towers (HTSAT audio, GPT2 caption) on the port's kernels
(wise_tpu/models/clap)."""

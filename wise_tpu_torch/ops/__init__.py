"""Device ops of the port: the block kernels (block.py, built by build.py)
and the exact flat top-k (topk.py)."""

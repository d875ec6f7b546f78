"""wise_tpu_torch: the WISE search engine on PyTorch and CUDA (NVIDIA Hopper).

The port of ``wise_tpu`` (JAX on TPU), which stays beside it as the
reference. The serve path of OpenCLIP ViT-B/32 runs here: GEMM bicubic
preprocess, the image and text towers on hand-written CUDA block kernels
(``csrc/``), the flat exact index, the extract / create-index / search /
serve entry points. The framework-free host layers (project, DB, feature
stores, media IO, temporal merge, REST handler, tokenizer) are reused from
``wise_tpu`` through ``_host``; nothing here imports jax.

Layout mirrors ``wise_tpu``: ``ops/`` (kernels), ``models/clip/``,
``index/``, ``pipeline/``, ``api/``, ``cli/``.
"""

__version__ = "0.1.0"

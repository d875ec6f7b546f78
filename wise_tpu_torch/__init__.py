"""wise_tpu_torch: the WISE search engine on PyTorch and CUDA (NVIDIA Hopper).

The port of ``wise_tpu`` (JAX on TPU), which stays beside it as the
reference. The package stands alone: it imports torch and numpy, never jax
and nothing of ``wise_tpu``. Its host layers (project, DB, feature stores,
media IO, temporal merge, REST handler, coalescer, tokenizers, checkpoint
converters, CLIs) are its own copies of the reference's modules, at the same
relative paths and under the same names; each copy's docstring names its
origin. The device layers are the port's own: GEMM bicubic preprocess, the
OpenCLIP image and text towers (ViT-B/32, B/16, L/14, H/14) and CLAP 2023
(HTSAT + GPT2) on hand-written CUDA kernels (``csrc/``), and the flat exact
index.

Entry points run on the card; ``WISE_TORCH_DEVICE=cpu`` asks for the CPU
(``utils/device.py``), where every kernel wrapper computes its plain version.

Layout mirrors ``wise_tpu``: ``ops/`` (kernels), ``models/``, ``index/``,
``store/``, ``db/``, ``io/``, ``search/``, ``pipeline/``, ``api/``, ``cli/``.
"""

__version__ = "0.1.0"

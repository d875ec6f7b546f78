"""Multi-device work (wise_tpu/parallel/__init__.py): the mesh, the sharded
search over it, process-group set-up, the CLIP trainer on one device,
data-parallel and tensor-parallel (``train.py``), and the pipeline-parallel
trainer (``pipeline.py``, ``pp_train.py``)."""

from .distributed import maybe_initialize_distributed
from .mesh import get_mesh, shard_rows
from .sharded_search import sharded_scan_topk

__all__ = [
    "get_mesh",
    "shard_rows",
    "sharded_scan_topk",
    "maybe_initialize_distributed",
]

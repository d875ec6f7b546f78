"""FeatureStore interface.

Same contract as the reference ABC (ox-vgg/WISE/src/feature/store/
feature_store.py:1-14) plus the read/iteration surface its concrete stores
expose (enable_read/enable_write/add/__iter__/iter_batch).

Copy of ``wise_tpu/store/feature_store.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class FeatureStore:
    feature_count: int = -1
    feature_dim: int = -1

    def __init__(self, store_name: str, store_data_dir):
        raise NotImplementedError

    def enable_write(self, shard_maxcount: int, shard_maxsize: int, verbose: int = 0):
        raise NotImplementedError

    def enable_read(self, shard_shuffle: bool = False, shuffle_values: bool = False,
                    shuffle_bufsize: int = 10000):
        raise NotImplementedError

    def add(self, id: int, features: np.ndarray) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        raise NotImplementedError

    def iter_batch(self, batch_size: int = 512):
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

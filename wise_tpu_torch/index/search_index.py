"""SearchIndex interface (reference contract:
ox-vgg/WISE/src/index/search_index.py:1-24).

Copy of ``wise_tpu/index/search_index.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SearchIndex:
    def __init__(self, media_type: str, asset_id: str, asset: dict):
        raise NotImplementedError

    def create_index(self, index_type: str, overwrite: bool = False) -> bool:
        raise NotImplementedError

    def load_index(self, index_type: str) -> bool:
        raise NotImplementedError

    def search(
        self, media_type: str, query, topk: int, query_type: str = "text"
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (distances, ids) arrays of shape (topk,)."""
        raise NotImplementedError

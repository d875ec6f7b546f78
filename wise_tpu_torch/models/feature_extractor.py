"""The extractor interface (reused from wise_tpu) and DeviceArray, the
unrealised result of a dispatch-only embed."""

from __future__ import annotations

import numpy as np

from wise_tpu.models.feature_extractor import (  # noqa: F401 (re-export)
    BucketPolicy,
    FeatureExtractor,
)


class DeviceArray:
    """Rows of a device tensor that realise on the host only when numpy asks
    (``np.asarray``). The serving coalescer (wise_tpu/api/engine.py) slices
    a dispatched batch per request and realises each slice outside its
    lock, so the forwards of successive batches queue on the card while
    earlier readbacks wait."""

    def __init__(self, tensor):
        self.tensor = tensor

    def __getitem__(self, idx):
        return DeviceArray(self.tensor[idx])

    def __array__(self, dtype=None, copy=None):
        arr = self.tensor.detach().float().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)

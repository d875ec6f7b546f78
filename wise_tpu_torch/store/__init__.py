"""Copy of ``wise_tpu/store/__init__.py``, with its imports bound to wise_tpu_torch."""

from .feature_store import FeatureStore
from .factory import FeatureStoreFactory, FeatureStoreType
from .tar_store import TarShardStore
from .npz_store import NpzShardStore

__all__ = [
    "FeatureStore",
    "FeatureStoreFactory",
    "FeatureStoreType",
    "TarShardStore",
    "NpzShardStore",
]

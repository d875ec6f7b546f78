"""Feature store factory (reference contract:
ox-vgg/WISE/src/feature/store/feature_store_factory.py:12-38).

Copy of ``wise_tpu/store/factory.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import enum
import glob
from pathlib import Path

from .npz_store import NpzShardStore
from .tar_store import TarShardStore


class FeatureStoreType(str, enum.Enum):
    WEBDATASET = "webdataset"
    NUMPY = "numpy"


class FeatureStoreFactory:
    @classmethod
    def create_store(cls, feature_store_type, media_type: str, features_dir):
        t = FeatureStoreType(feature_store_type)
        if t == FeatureStoreType.WEBDATASET:
            return TarShardStore(media_type, features_dir)
        if t == FeatureStoreType.NUMPY:
            return NpzShardStore(media_type, features_dir)
        raise ValueError(f"unknown feature_store_type {feature_store_type}")

    @classmethod
    def load_store(cls, media_type: str, features_dir):
        features_dir = Path(features_dir)
        exts = set()
        for f in glob.iglob(str(features_dir / (media_type + "-*.*"))):
            exts.add(Path(f).suffix)
        if len(exts) != 1:
            raise ValueError(
                f"failed to infer type of {media_type} feature store in {features_dir}"
            )
        ext = exts.pop()
        if ext == ".tar":
            store = TarShardStore(media_type, features_dir)
        elif ext == ".npz":
            store = NpzShardStore(media_type, features_dir)
        else:
            raise ValueError(f"unknown store shard extension {ext}")
        return store

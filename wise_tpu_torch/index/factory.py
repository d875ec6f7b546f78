"""SearchIndex factory (wise_tpu/index/factory.py) on the port's feature
index and the metadata (FTS5) index on SQLite."""

from __future__ import annotations

from .fts_index import SqliteSearchIndex

from .feature_index import FeatureSearchIndex


def SearchIndexFactory(media_type: str, asset_id: str, asset: dict,
                       config=None):
    if media_type in ("audio", "video", "image"):
        return FeatureSearchIndex(media_type, asset_id, asset, config=config)
    if media_type == "metadata":
        return SqliteSearchIndex(media_type, asset_id, asset, config=config)
    raise ValueError(f"unknown media_type {media_type}")

"""Offline ingestion (wise_tpu/pipeline/extract.py): decode -> embed ->
store + record, with the port's FeatureExtractorFactory in place of the
reference's. Everything else is the reference's driver: the batched
embedder, the DB and feature-store writes, thumbnails, resumption."""

from __future__ import annotations

from wise_tpu.pipeline import extract as _ref

from .._host import rebind
from ..models.factory import FeatureExtractorFactory

ExtractionStats = _ref.ExtractionStats
BatchedEmbedder = _ref._BatchedEmbedder

extract_features = rebind(_ref.extract_features,
                          FeatureExtractorFactory=FeatureExtractorFactory)

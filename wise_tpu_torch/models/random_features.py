"""Deterministic fake feature extractor for hermetic tests.

The reference documents (but never implements) a RandomFeatures stub
(docs/FeatureExtractor.md; factory docstring mentions ``__RANDOM_768__``,
src/feature/feature_extractor_factory.py:14). Here it is first-class:
features are a pure function of the input bytes (content-hashed seed), so
ingest -> index -> search pipelines are reproducible without model weights,
and text/image/audio of the same underlying concept can be made to match in
tests by seeding from the same string.

Extractor id: ``wise/random_features/<dim>/<seed-label>``
e.g. ``wise/random_features/512/test``.

Copy of ``wise_tpu/models/random_features.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np

from .feature_extractor import FeatureExtractor, l2_normalize


def _seeded_vector(seed_bytes: bytes, dim: int) -> np.ndarray:
    h = hashlib.sha256(seed_bytes).digest()
    rng = np.random.default_rng(np.frombuffer(h[:16], dtype=np.uint64))
    return rng.standard_normal(dim, dtype=np.float32)


class RandomFeatures(FeatureExtractor):
    TARGET_SIZE = (224, 224)

    def __init__(self, id: str):
        tok = id.split("/")
        if len(tok) != 4 or tok[0] != "wise" or tok[1] != "random_features":
            raise ValueError(f"invalid random_features id {id}")
        self.id = id
        self.output_dim = int(tok[2])
        self.label = tok[3]
        self.input_size = self.TARGET_SIZE

    # -- image --------------------------------------------------------------
    def preprocess_image(self, images) -> np.ndarray:
        if isinstance(images, np.ndarray) and images.ndim == 4:
            batch = images
        else:
            batch = np.stack([np.asarray(im) for im in images])
        return batch.astype(np.float32)

    def extract_image_features(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        out = np.stack(
            [
                _seeded_vector(
                    self.label.encode() + np.ascontiguousarray(im).tobytes(),
                    self.output_dim,
                )
                for im in images
            ]
        )
        return l2_normalize(out)

    # -- text ---------------------------------------------------------------
    def extract_text_features(self, text_query: List[str]) -> np.ndarray:
        out = np.stack(
            [
                _seeded_vector(self.label.encode() + t.encode("utf-8"), self.output_dim)
                for t in text_query
            ]
        )
        return l2_normalize(out)

    # -- audio --------------------------------------------------------------
    def preprocess_audio(self, audio) -> np.ndarray:
        a = np.asarray(audio, dtype=np.float32)
        if a.ndim == 1:
            a = a[None]
        return a

    def extract_audio_features(self, preprocessed_audio: np.ndarray) -> np.ndarray:
        a = np.asarray(preprocessed_audio, dtype=np.float32)
        if a.ndim == 1:
            a = a[None]
        out = np.stack(
            [
                _seeded_vector(
                    self.label.encode() + np.ascontiguousarray(x).tobytes(),
                    self.output_dim,
                )
                for x in a
            ]
        )
        return l2_normalize(out)

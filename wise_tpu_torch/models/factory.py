"""Feature extractor factory (wise_tpu/models/factory.py): the same 4-token
ids, routed to the port's extractors.

- ``mlfoundations/open_clip/<model>/<pretrained>`` -> PyTorch/CUDA OpenCLIP
- ``wise/random_features/<dim>/<label>``           -> the numpy fake (random_features.py)
- ``microsoft/clap/<version>/<variant>``           -> PyTorch/CUDA CLAP
  (version 2023: HTSAT + GPT2; version 2022: CNN14 + BERT)
"""

from __future__ import annotations

import re


def FeatureExtractorFactory(id: str):
    from .random_features import RandomFeatures

    m = re.fullmatch(r"__RANDOM_(\d+)__", id)
    if m:
        return RandomFeatures(f"wise/random_features/{m.group(1)}/default")
    if len(id.split("/")) != 4:
        raise ValueError(
            "Feature extractor id must be formatted as "
            "MODEL_CREATOR_NAMESPACE/MODEL_CREATOR/MODEL_NAME/"
            "PRETRAINING_DATASET, "
            'e.g. "mlfoundations/open_clip/ViT-B-32/laion2b_s34b_b79k" or '
            '"wise/random_features/512/test"'
        )
    if id.startswith("wise/random_features/"):
        return RandomFeatures(id)
    if id.startswith("mlfoundations/open_clip/"):
        from .clip.extractor import OpenClipExtractor

        return OpenClipExtractor(id)
    if id.startswith("microsoft/clap/"):
        from .clap.extractor import ClapExtractor

        return ClapExtractor(id)
    raise ValueError(f"Unknown feature extractor id {id}")

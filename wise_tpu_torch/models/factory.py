"""Feature extractor factory (wise_tpu/models/factory.py): the same 4-token
ids, routed to the port's extractors.

- ``mlfoundations/open_clip/<model>/<pretrained>`` -> PyTorch/CUDA OpenCLIP
- ``wise/random_features/<dim>/<label>``           -> wise_tpu's numpy fake
- ``microsoft/clap/<version>/<variant>``           -> not ported yet
"""

from __future__ import annotations

import re


def FeatureExtractorFactory(id: str):
    from wise_tpu.models.random_features import RandomFeatures

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
        raise NotImplementedError(
            f"{id}: the CLAP towers are not ported to PyTorch yet "
            "(ROADMAP Queue A item 9)")
    raise ValueError(f"Unknown feature extractor id {id}")

"""Evaluation of retrieval and index quality (numpy).

Copy of ``wise_tpu/eval/__init__.py``, with its imports bound to wise_tpu_torch.
"""

from .retrieval import calculate_mAP, build_similarity_matrix

__all__ = ["calculate_mAP", "build_similarity_matrix"]

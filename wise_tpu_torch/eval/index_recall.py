"""ANN index quality evaluation: recall vs the exhaustive scan.

Protocol from the reference's docs/Search-Index-Evaluation.md:
- R0@K  — fraction of exact top-K results recovered in the ANN top-K
- R1@N,K — fraction of queries whose exact top-1 appears in the ANN top-N
  (evaluated with ANN retrieving K >= N)

Copy of ``wise_tpu/eval/index_recall.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from ..ops.topk import numpy_reference_topk


def recall_at_k(exact_ids: np.ndarray, ann_ids: np.ndarray, k: int) -> float:
    """R0@K averaged over queries; inputs (Q, >=k) id matrices."""
    hits = 0
    for r in range(exact_ids.shape[0]):
        hits += len(set(exact_ids[r, :k]) & set(ann_ids[r, :k]))
    return hits / (exact_ids.shape[0] * k)


def top1_recall_at_n(exact_ids: np.ndarray, ann_ids: np.ndarray, n: int) -> float:
    """R1@N: exact top-1 found within ANN top-N."""
    hits = sum(
        int(exact_ids[r, 0] in ann_ids[r, :n])
        for r in range(exact_ids.shape[0])
    )
    return hits / exact_ids.shape[0]


def evaluate_index(
    index,
    queries: np.ndarray,
    exact_db: np.ndarray,
    exact_ids: np.ndarray,
    topk: int = 100,
    r1_n: int = 20,
) -> Dict[str, float]:
    """index: a loaded FeatureSearchIndex (any type); exact_db/(exact_ids):
    the raw vectors and their vector ids for ground truth."""
    ref_vals, ref_rows = numpy_reference_topk(queries, exact_db, topk)
    ref_ids = exact_ids[ref_rows]
    t0 = time.time()
    _, ann_ids = index.search_batch(queries, topk)
    elapsed = (time.time() - t0) / len(queries)
    return {
        "R0@10": recall_at_k(ref_ids, ann_ids, min(10, topk)),
        "R0@100": recall_at_k(ref_ids, ann_ids, min(100, topk)),
        f"R1@{r1_n}": top1_recall_at_n(ref_ids, ann_ids, r1_n),
        "sec_per_query": elapsed,
    }

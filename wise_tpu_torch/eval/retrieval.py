"""Multi-instance retrieval evaluation (EpicKitchens-100-style mAP).

Same protocol as the reference harness
(ox-vgg/WISE/scripts/eval/EpicKitchens-100/retrieval_eval.py): WISE CSV
search results are assigned to annotated ground-truth segments by temporal
IoU overlap, building a (num_segments, num_queries) similarity matrix that is
scored against a relevancy matrix with the standard AP formula
(sum_k p(k)·rel(k) / num_rel_docs, averaged over queries).

Copy of ``wise_tpu/eval/retrieval.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np


def hhmmss_to_sec(hhmmss: str) -> float:
    hh, mm, rest = hhmmss.split(":")
    if "." in rest:
        ss, ms = rest.split(".")
    else:
        ss, ms = rest, "0"
    return int(hh) * 3600 + int(mm) * 60 + int(ss) + int(ms) / 1000.0


def segment_iou_overlap(seg1: Sequence[float], seg2: Sequence[float],
                        iou_threshold: float) -> bool:
    union = max(*seg1, *seg2) - min(*seg1, *seg2)
    if union <= 0:
        return True
    iou = (min(seg1[1], seg2[1]) - max(seg1[0], seg2[0])) / union
    return iou > iou_threshold


def calculate_mAP(sim_mat: np.ndarray, relevancy_matrix: np.ndarray) -> float:
    """Rows are queries. AP = sum_k p(k)*rel(k) / num_rel_docs."""
    order = (-sim_mat).argsort(axis=1)
    rows = np.arange(sim_mat.shape[0])[:, None]
    ranked_rel = relevancy_matrix[rows, order]
    cum_rel = np.cumsum(ranked_rel, axis=1).astype(np.float64)
    cum_rel[ranked_rel != 1] = 0
    divisor = np.arange(ranked_rel.shape[1]) + 1
    num_rel = np.sum(ranked_rel == 1, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        ap = np.sum(cum_rel / divisor, axis=1) / num_rel
    return float(np.nanmean(ap))


def load_ground_truth_segments(path) -> Tuple[Dict[str, List[Dict]], int]:
    """EPIC_100_retrieval_test.csv: narration_id,participant_id,video_id,
    narration_timestamp,start_timestamp,stop_timestamp,...,narration."""
    segments: Dict[str, List[Dict]] = {}
    index = 0
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            video_id = row[2]
            segments.setdefault(video_id, []).append(
                {
                    "video_index": index,
                    "starttime": hhmmss_to_sec(row[4]),
                    "stoptime": hhmmss_to_sec(row[5]),
                }
            )
            index += 1
    return segments, index


def load_queries(path) -> Tuple[List[str], List[str]]:
    ids, texts = [], []
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            ids.append(row[0])
            texts.append(row[1])
    return ids, texts


def build_similarity_matrix(
    results_csv,
    query_ids: List[str],
    video_segments: Dict[str, List[Dict]],
    n_segments: int,
    iou_threshold: float,
) -> np.ndarray:
    """(n_segments, n_queries) from WISE result rows
    query,rank,filename,start_time,end_time,score."""
    qpos = {q: i for i, q in enumerate(query_ids)}
    sim = np.zeros((n_segments, len(query_ids)), dtype=np.float32)
    with open(results_csv) as f:
        reader = csv.reader(f, quotechar='"')
        next(reader)
        for row in reader:
            qid = row[0]
            if qid not in qpos:
                continue
            video_id = Path(row[2]).stem
            if video_id not in video_segments:
                continue
            seg = [float(row[3]), float(row[4])]
            score = float(row[5])
            for g in video_segments[video_id]:
                if segment_iou_overlap(
                    seg, [g["starttime"], g["stoptime"]], iou_threshold
                ):
                    sim[g["video_index"], qpos[qid]] = score
    return sim

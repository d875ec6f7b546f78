"""Search result processing: query dispatch, temporal merging, export.

Behavioural contract matches the reference's search.py:

- ``process_query`` / ``process_text_query`` (search.py:67-159): per-query
  faiss-equivalent top-k then DB hydration to (filename, pts, score); our
  hydration uses one batched JOIN instead of the reference's N+1 per-id gets.
- ``apply_subtract`` / ``does_segment_overlap`` (:161-230): --not-in removal
  by temporal overlap (points use containment; ranges use IoU > 0.01).
- ``merge0`` (:253-363): greedy same-file merge by time+rank tolerance;
  merged entry keeps the best (first) score and the [min, max] pts span.
- ``merge1`` (:393-445): cross-modality AND — same file + overlapping
  segments, scores added, re-sorted descending.
- CSV/table export (:453-539): header
  ``query,rank,filename,start_time,end_time,score``; scores to 3 decimals,
  timestamps to 1 decimal.

Copy of ``wise_tpu/search/results.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Dict, List, Optional, Sequence

from ..db.repository import get_full_metadata_batch

EXPORT_CSV_HEADER = "query,rank,filename,start_time,end_time,score"


# ---------------------------------------------------------------------------
# overlap + subtract
# ---------------------------------------------------------------------------

def does_segment_overlap(seg1, seg2) -> bool:
    def norm(seg):
        if isinstance(seg, (int, float)):
            return [float(seg), float(seg)], True
        seg = list(seg)
        if len(seg) == 1:
            return [seg[0], seg[0]], True
        return seg, False

    s1, p1 = norm(seg1)
    s2, p2 = norm(seg2)
    if p1:
        return s2[0] <= s1[0] <= s2[1]
    if p2:
        return s1[0] <= s2[0] <= s1[1]
    union = max(s1 + s2) - min(s1 + s2)
    if union <= 0:
        return True
    iou = (min(s1[1], s2[1]) - max(s1[0], s2[0])) / union
    return iou > 0.01


def apply_subtract(search_result: Dict, not_search_result: Dict) -> Dict:
    out = {k: v for k, v in search_result.items()}
    keep = []
    for i, fname in enumerate(search_result["match_filename_list"]):
        pts = search_result["match_pts_list"][i]
        hit = False
        for j, nf in enumerate(not_search_result["match_filename_list"]):
            if nf == fname and does_segment_overlap(
                pts, not_search_result["match_pts_list"][j]
            ):
                hit = True
                break
        if not hit:
            keep.append(i)
    for key in ("match_filename_list", "match_pts_list", "match_score_list"):
        out[key] = [search_result[key][i] for i in keep]
    return out


# ---------------------------------------------------------------------------
# query processing
# ---------------------------------------------------------------------------

def process_text_query(search_index_list: Dict, conn, query_text: str,
                       media_type: str, topk: int,
                       query_vector=None) -> Dict:
    """query_vector (optional np array) bypasses text embedding — used for
    compound @file +/- text queries from the console grammar."""
    if media_type == "metadata":
        dist, rows = search_index_list[media_type].search(
            media_type, query_text, topk, query_type="text"
        )
        return {
            "match_filename_list": [r.get("__filename", "") for r in rows],
            "match_pts_list": [
                [r.get("__starttime", 0.0) or 0.0, r.get("__stoptime", 0.0) or 0.0]
                for r in rows
            ],
            "match_score_list": list(dist),
        }
    if query_vector is not None:
        dist, ids = search_index_list[media_type].search(
            media_type, query_vector, topk, query_type="vector"
        )
    else:
        dist, ids = search_index_list[media_type].search(
            media_type, query_text, topk, query_type="text"
        )
    return hydrate_result(conn, dist, ids)


def hydrate_result(conn, dist, ids) -> Dict:
    """vector ids + scores -> (filename, pts, score) lists via one batched
    JOIN (the reference hydrates with N+1 per-id queries, search.py:137-153)."""
    valid = [
        (int(i), float(d)) for i, d in zip(ids, dist) if int(i) != -1
    ]
    metas = get_full_metadata_batch(conn, [i for i, _ in valid])
    by_id = {m.id: m for m in metas}
    fns, ptss, scores = [], [], []
    for vid, score in valid:
        m = by_id.get(vid)
        if m is None:
            continue
        fns.append(m.path)
        if m.end_timestamp is None:
            ptss.append(m.timestamp)
        else:
            ptss.append([m.timestamp, m.end_timestamp])
        scores.append(score)
    return {
        "match_filename_list": fns,
        "match_pts_list": ptss,
        "match_score_list": scores,
    }


def process_query(
    search_index_list: Dict,
    conn,
    queries: Sequence[str],
    media_type_list: Sequence[str],
    topk_list: Sequence[int],
    not_queries: Sequence[str] = (),
    media_type_not_list: Sequence[str] = (),
    query_id: Optional[str] = None,
) -> List[Dict]:
    """queries/media_type_list are the IN queries; not_queries line up with
    media_type_not_list."""
    all_not = []
    t_not = time.time()
    for nq, nmt in zip(not_queries, media_type_not_list):
        k = topk_list[0] if topk_list else 10
        all_not.append(process_text_query(search_index_list, conn, nq, nmt, k))
    not_elapsed = time.time() - t_not if not_queries else 0.0

    results = []
    for qi, (q, mt) in enumerate(zip(queries, media_type_list)):
        t0 = time.time()
        k = topk_list[qi] if qi < len(topk_list) else topk_list[-1]
        r = process_text_query(search_index_list, conn, q, mt, k)
        r["query"] = [q]
        r["in"] = [mt]
        r["not_in"] = []
        for (nq, nmt), nr in zip(
            zip(not_queries, media_type_not_list), all_not
        ):
            r = apply_subtract(r, nr)
            r["query"].append(nq)
            r["not_in"].append(nmt)
        r["search_time_sec"] = (time.time() - t0) + not_elapsed
        if query_id is not None:
            r["query_id"] = [query_id]
        results.append(r)
    return results


# ---------------------------------------------------------------------------
# merge0: same-modality temporal merging
# ---------------------------------------------------------------------------

def merge_a_ranked_result_list(
    filename_list, pts_list, score_list, pts_tolerance, rank_tolerance
):
    n = len(filename_list)
    merged_f, merged_p, merged_s, merged_r = [], [], [], []
    consumed = set()

    def midpoint(p):
        return sum(p) / len(p) if isinstance(p, list) else p

    for i in range(n):
        if i in consumed:
            continue
        same_file = [i] + [
            j
            for j in range(i + 1, n)
            if j not in consumed and filename_list[j] == filename_list[i]
        ]
        group = {i}
        for a, b in itertools.combinations(range(len(same_file)), 2):
            ia, ib = same_file[a], same_file[b]
            if (
                math.fabs(midpoint(pts_list[ia]) - midpoint(pts_list[ib]))
                <= pts_tolerance
                and math.fabs(ia - ib) <= rank_tolerance
            ):
                group.add(ia)
                group.add(ib)
        all_pts = []
        for j in group:
            p = pts_list[j]
            all_pts.extend(p if isinstance(p, list) else [p])
            consumed.add(j)
        all_pts.sort()
        merged_p.append(
            [all_pts[0], all_pts[-1]] if len(all_pts) > 1 else [all_pts[0]]
        )
        merged_f.append(filename_list[i])
        merged_s.append(score_list[i])
        merged_r.append(sorted(group))
    return merged_f, merged_p, merged_s, merged_r


def merge0(
    results: List[Dict],
    merge_tolerance_video: float = 4.0,
    merge_tolerance_audio: float = 8.0,
    merge_rank_tolerance: int = 20,
) -> List[Dict]:
    tolerances = {
        "video": merge_tolerance_video,
        "audio": merge_tolerance_audio,
        "metadata": 0.0,
        "image": 0.0,
    }
    for r in results:
        media_type = r["in"][0]
        tt = tolerances.get(media_type, 0.0)
        rt = 0 if media_type == "image" else merge_rank_tolerance
        f, p, s, ranks = merge_a_ranked_result_list(
            r["match_filename_list"],
            r["match_pts_list"],
            r["match_score_list"],
            tt,
            rt,
        )
        r["match_filename_list"] = f
        r["match_pts_list"] = p
        r["match_score_list"] = s
        r["merged_rank_list"] = ranks
    return results


# ---------------------------------------------------------------------------
# merge1: cross-modality AND
# ---------------------------------------------------------------------------

def merge1(results: List[Dict]) -> List[Dict]:
    if len(results) != 2:
        raise ValueError("merge1() requires exactly two result sets")
    r0, r1 = results
    fns, scores, ptss, ranks = [], [], [], []
    for i0, i1 in itertools.product(
        range(len(r0["match_filename_list"])), range(len(r1["match_filename_list"]))
    ):
        if r0["match_filename_list"][i0] != r1["match_filename_list"][i1]:
            continue
        p0, p1 = r0["match_pts_list"][i0], r1["match_pts_list"][i1]
        if not does_segment_overlap(p0, p1):
            continue
        fns.append(r0["match_filename_list"][i0])
        scores.append(r0["match_score_list"][i0] + r1["match_score_list"][i1])
        merged = (
            (p0 if isinstance(p0, list) else [p0])
            + (p1 if isinstance(p1, list) else [p1])
        )
        merged.sort()
        ptss.append([merged[0]] if len(merged) == 1 else [merged[0], merged[-1]])
        ranks.append([i0, i1])
    order = sorted(range(len(scores)), key=scores.__getitem__, reverse=True)
    merged_result = {
        "match_filename_list": [fns[i] for i in order],
        "match_pts_list": [ptss[i] for i in order],
        "match_score_list": [scores[i] for i in order],
        "merged_rank_list": [ranks[i] for i in order],
        "search_time_sec": r0.get("search_time_sec", 0.0)
        + r1.get("search_time_sec", 0.0),
        "query": r0["query"] + r1["query"],
        "in": r0["in"] + r1["in"],
        "not_in": r0.get("not_in", []) + r1.get("not_in", []),
    }
    return [merged_result]


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def search_result_title(result: Dict) -> str:
    parts = []
    in_count = len(result["in"])
    for i in range(in_count):
        parts.append(f'"{result["query"][i]}" in {result["in"][i]}')
    for i in range(in_count, len(result["query"])):
        parts.append(
            f'"{result["query"][i]}" not in {result["not_in"][i - in_count]}'
        )
    return " and ".join(parts)


def format_timestamp_csv(pts) -> str:
    if isinstance(pts, list):
        if len(pts) == 1:
            return "%.1f,%.1f" % (pts[0], pts[0])
        return "%.1f,%.1f" % (pts[0], pts[1])
    return "%.1f" % pts


def result_to_csv_lines(results: List[Dict]) -> List[str]:
    lines = []
    for r in results:
        if "query_id" in r:
            query_id = r["query_id"][0]
        else:
            query_id = search_result_title(r).replace('"', '""')
        for rank, fname in enumerate(r["match_filename_list"]):
            pts_str = format_timestamp_csv(r["match_pts_list"][rank])
            score_str = "%.3f" % r["match_score_list"][rank]
            lines.append(f'"{query_id}",{rank},"{fname}",{pts_str},{score_str}')
    return lines


def to_hhmmss(sec: float) -> str:
    hh = int(sec / 3600)
    ds = sec - hh * 3600
    mm = int(ds / 60)
    ds -= mm * 60
    ss = int(ds)
    ms = int((ds - ss) * 100)
    return "%02d:%02d:%02d.%02d" % (hh, mm, ss, ms)


def result_to_table_lines(results: List[Dict], human_readable: bool = False):
    lines = []
    for r in results:
        title = search_result_title(r)
        if not r["match_filename_list"]:
            lines.append(f"No results found for {title}")
            continue
        lines.append(f"Search results for {title}")
        lines.append("Rank  Time             Score  Filename")
        for rank, fname in enumerate(r["match_filename_list"]):
            pts = r["match_pts_list"][rank]
            if isinstance(pts, list):
                if human_readable:
                    pts_str = " - ".join(to_hhmmss(p) for p in pts)
                else:
                    pts_str = " - ".join("%.1f" % p for p in pts)
            else:
                pts_str = to_hhmmss(pts) if human_readable else "%.1f" % pts
            score = "%.3f" % r["match_score_list"][rank]
            lines.append(f"{rank:>4}  {pts_str:<15}  {score}  {fname}")
        if "search_time_sec" in r:
            lines.append("(search completed in %.3f sec.)" % r["search_time_sec"])
        lines.append("")
    return lines

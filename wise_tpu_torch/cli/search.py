"""search CLI: one-shot queries, CSV batch (--queries-from), and an
interactive console — argument surface compatible with the reference's
search.py:670-992.

Copy of ``wise_tpu/cli/search.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import argparse
import csv
import logging
import sys

from .. import db as wdb
from ..index.factory import SearchIndexFactory
from ..project import WiseProject
from ..search.results import (
    EXPORT_CSV_HEADER,
    merge0,
    merge1,
    process_query,
    result_to_csv_lines,
    result_to_table_lines,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="search", description="Search images, audio and videos using natural language."
    )
    p.add_argument("--query", action="append")
    p.add_argument("--in", action="append", dest="media_type_list",
                   choices=["audio", "video", "metadata", "image"])
    p.add_argument("--not-in", action="append", dest="media_type_not_list",
                   choices=["audio", "video", "metadata", "image"])
    p.add_argument("--index-type", default="IndexFlatIP",
                   choices=["IndexFlatIP", "IndexIVFFlat", "IndexIVFPQ"])
    p.add_argument("--storage-dtype", default=None,
                   choices=["float32", "bfloat16", "int8"],
                   help="HBM dtype for the resident index: bfloat16 halves "
                        "scan bandwidth; int8 quarters it (device candidate "
                        "scan + exact host f32 rerank)")
    p.add_argument("--flat-approx-recall", type=float, default=None,
                   help="approximate flat scan with this recall target "
                        "(lax.approx_max_k — measured 7.4x at k=1000, "
                        "recall@1000 0.983); default exact")
    p.add_argument("--topk", action="append", type=int)
    p.add_argument("--max-filename-length", type=int, default=50)
    p.add_argument("--no-merge", action="store_true")
    # None = take the project config's SearchConfig value (wise.json
    # merge_video_time_tolerance / merge_audio_time_tolerance /
    # merge_rank_tolerance); reference hard-codes 4/8/20 (search.py:717-740)
    p.add_argument("--merge-tolerance-video", type=float, default=None)
    p.add_argument("--merge-rank-tolerance", type=int, default=None)
    p.add_argument("--merge-tolerance-audio", type=float, default=None)
    p.add_argument("--merge-tolerance-metadata", type=int, default=0)
    p.add_argument("--result-format", default="table", choices=["table", "csv"])
    p.add_argument("--save-to-file", type=str)
    p.add_argument("--queries-from", type=str,
                   help="CSV with header, rows [query_id, query_text]")
    p.add_argument("--human-readable", action="store_true")
    p.add_argument("--asset-index", type=int, default=0,
                   help="which feature-extractor asset to use when several exist")
    p.add_argument("--project-dir", required=True, type=str)
    return p


def load_search_indices(project, assets, media_types, index_type, config,
                        asset_index=0):
    out = {}
    for media_type in media_types:
        asset_ids = list(assets.get(media_type, {}).keys())
        if not asset_ids:
            continue
        asset_id = asset_ids[min(asset_index, len(asset_ids) - 1)]
        asset = assets[media_type][asset_id]
        index = SearchIndexFactory(media_type, asset_id, asset, config=config.index)
        ok = index.load_index("fts5" if media_type == "metadata" else index_type)
        if ok:
            out[media_type] = index
    return out


def emit(results, args, out_lines):
    if args.result_format == "csv":
        out_lines.extend(result_to_csv_lines(results))
    else:
        out_lines.extend(result_to_table_lines(results, args.human_readable))


def run_queries(search_index_list, conn, args, queries, media_types,
                not_queries, not_media_types, topk_list, out_lines,
                query_id=None, allow_merge1=True):
    results = process_query(
        search_index_list, conn, queries, media_types, topk_list,
        not_queries=not_queries, media_type_not_list=not_media_types,
        query_id=query_id,
    )
    if args.no_merge:
        emit(results, args, out_lines)
        return
    results = merge0(
        results,
        merge_tolerance_video=args.merge_tolerance_video,
        merge_tolerance_audio=args.merge_tolerance_audio,
        merge_rank_tolerance=args.merge_rank_tolerance,
    )
    emit(results, args, out_lines)
    if len(results) == 2 and allow_merge1:
        emit(merge1(results), args, out_lines)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    project = WiseProject(args.project_dir, create_project=False)
    assets = project.discover_assets()
    if not assets:
        print(f"failed to load assets from {args.project_dir}")
        return 1
    config = project.load_config()
    if args.storage_dtype:
        config.index.storage_dtype = args.storage_dtype
    if args.flat_approx_recall is not None:
        config.index.flat_approx_recall = args.flat_approx_recall
    # CLI flags override the project config's merge tolerances; unset
    # flags take the typed-config values (SearchConfig)
    if args.merge_tolerance_video is None:
        args.merge_tolerance_video = config.search.merge_video_time_tolerance
    if args.merge_tolerance_audio is None:
        args.merge_tolerance_audio = config.search.merge_audio_time_tolerance
    if args.merge_rank_tolerance is None:
        args.merge_rank_tolerance = config.search.merge_rank_tolerance
    conn = wdb.connect(project.db_path, readonly=True)

    if args.media_type_list is None and args.media_type_not_list is not None:
        print("--not-in flag requires previous definitions of --in flag")
        return 0

    topk_list = args.topk if args.topk else [10]

    # decide which indices we need
    if args.query is None and args.media_type_list is None and not args.queries_from:
        required = [mt for mt in assets if assets.get(mt)]
    else:
        required = list(args.media_type_list or [])
        if args.media_type_not_list:
            required += args.media_type_not_list
        if not required:
            required = [
                mt for mt in ("audio", "video", "image") if assets.get(mt)
            ]
    required = sorted(set(required))
    search_index_list = load_search_indices(
        project, assets, required, args.index_type, config, args.asset_index
    )
    if not search_index_list:
        print(f"search index missing from {args.project_dir}")
        return 1

    out_lines: list = []
    if args.result_format == "csv":
        out_lines.append(EXPORT_CSV_HEADER)

    if args.query is not None:
        media_types = args.media_type_list
        queries = list(args.query)
        if media_types is None:
            # apply the single query to all available media types
            media_types = [
                mt for mt in ("audio", "video", "metadata")
                if mt in search_index_list
            ]
            queries = [queries[0]] * len(media_types)
        n_in = len(media_types)
        not_queries = queries[n_in:]
        queries = queries[:n_in]
        if len(topk_list) == 1:
            topk_list = topk_list * len(queries)
        run_queries(
            search_index_list, conn, args, queries, media_types,
            not_queries, args.media_type_not_list or [], topk_list, out_lines,
        )
    elif args.queries_from:
        if args.media_type_not_list:
            print("--queries-from flag does not support --not-in flag")
            return 0
        with open(args.queries_from) as f:
            reader = csv.reader(f)
            next(reader)  # header
            rows = [r for r in reader if len(r) >= 2]
        media_types = args.media_type_list or [
            mt for mt in ("audio", "video") if mt in search_index_list
        ]
        k = int(topk_list[0])
        # batch mode: embed ALL query texts in one encoder call per media
        # type and run one batched index search — the reference embeds and
        # searches per row (0.31 s/query over EpicKitchens' 3842 queries)
        from ..index.feature_index import QUERY_PROMPTS
        from ..search.results import hydrate_result, process_text_query

        per_mt = {}
        for mt in media_types:
            index = search_index_list[mt]
            if mt == "metadata" or not hasattr(index, "search_batch"):
                per_mt[mt] = None  # FTS stays per-query
                continue
            prompts = [
                QUERY_PROMPTS.get(mt, "") + str(q) for _, q in
                ((r[0], r[1]) for r in rows)
            ]
            vecs = index.extractor.extract_text_features(prompts)
            per_mt[mt] = index.search_batch(vecs, k)
        for ri, row in enumerate(rows):
            query_id, query_text = row[0], row[1]
            results = []
            for mt in media_types:
                if per_mt[mt] is None:
                    r = process_text_query(
                        search_index_list, conn, query_text, mt, k
                    )
                else:
                    scores, ids = per_mt[mt]
                    r = hydrate_result(conn, scores[ri], ids[ri])
                r["query"] = [query_text]
                r["in"] = [mt]
                r["not_in"] = []
                r["query_id"] = [query_id]
                results.append(r)
            if not args.no_merge:
                results = merge0(
                    results,
                    merge_tolerance_video=args.merge_tolerance_video,
                    merge_tolerance_audio=args.merge_tolerance_audio,
                    merge_rank_tolerance=args.merge_rank_tolerance,
                )
            emit(results, args, out_lines)
    else:
        return console(search_index_list, conn, args, out_lines)

    text = "\n".join(out_lines) + "\n"
    if args.save_to_file:
        with open(args.save_to_file, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def compound_query_vector(search_index_list, unit):
    """Build a fused query vector for a grammar unit with @file items and/or
    +/- embedding ops (e.g. '@dog.jpg + "in snow" IN video'). Returns an
    (1, dim) array, or None for plain single-text units."""
    import numpy as np

    if unit["query_type"] == ["text"] and not unit["query_embedding_vec_op"]:
        return None
    index = search_index_list[unit["search_target"]]
    fe = index.extractor
    from ..index.feature_index import QUERY_PROMPTS

    prompt = QUERY_PROMPTS.get(unit["search_target"], "")
    vecs = []
    for qstr, qtype in zip(unit["query_str"], unit["query_type"]):
        if qtype == "file":
            from ..io.decode import load_image

            img = load_image(qstr)
            vecs.append(fe.extract_image_features(fe.preprocess_image([img])))
        else:
            vecs.append(
                fe.extract_text_features([prompt + qstr.strip('"')])
            )
    out = vecs[0].astype(np.float64)
    for op, v in zip(unit["query_embedding_vec_op"], vecs[1:]):
        out = out + v if op == "+" else out - v
    out = out / max(np.linalg.norm(out), 1e-12)
    return out.astype(np.float32)


def console(search_index_list, conn, args, out_lines) -> int:
    """Interactive search console using the audiovisual query grammar,
    including compound @file +/- embedding queries."""
    from ..search import parse_search_query
    from ..search.results import (
        apply_subtract,
        merge0,
        process_text_query,
    )

    print("WISE search console. Query grammar: "
          '<query>[+/-<query>] (IN|NOT IN) (audio|video|image|metadata) [AND ...]')
    print("Items: words, \"quoted phrases\", @image-files. Type q to quit.")
    while True:
        try:
            cmd = input("wise> ").strip()
        except EOFError:
            break
        if cmd in ("q", "quit", "exit"):
            break
        if not cmd:
            continue
        status, tree = parse_search_query(cmd)
        if status["status"] != "OK":
            print(f"parse error: {status.get('message')}")
            continue
        lines: list = []
        try:
            results = []
            not_results = []
            for unit in tree["query"]:
                mt = unit["search_target"]
                if mt not in search_index_list:
                    print(f"no index loaded for {mt}")
                    results = []
                    break
                qtext = " ".join(s.strip('"') for s in unit["query_str"])
                vec = compound_query_vector(search_index_list, unit)
                r = process_text_query(
                    search_index_list, conn, qtext, mt, 10, query_vector=vec
                )
                r["query"] = [qtext]
                if unit["search_target_link"] == "in":
                    r["in"] = [mt]
                    r["not_in"] = []
                    results.append(r)
                else:
                    not_results.append((qtext, mt, r))
            for nq, nmt, nr in not_results:
                results = [apply_subtract(r, nr) for r in results]
                for r in results:
                    r["query"].append(nq)
                    r["not_in"].append(nmt)
            if results:
                results = merge0(
                    results,
                    merge_tolerance_video=args.merge_tolerance_video,
                    merge_tolerance_audio=args.merge_tolerance_audio,
                    merge_rank_tolerance=args.merge_rank_tolerance,
                )
                emit(results, args, lines)
                if len(results) == 2:
                    emit(merge1(results), args, lines)
        except Exception as e:  # console stays alive on bad input
            print(f"error: {e}")
            continue
        print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

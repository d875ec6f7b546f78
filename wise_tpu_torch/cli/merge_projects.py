"""merge-projects CLI: combine per-worker ingest projects into one.

Counterpart of extract-features --ingest-worker/--ingest-workers: each host
ingests its stride of the file list into its own project dir with a disjoint
media/vector id range (pipeline/extract.py INGEST_ID_STRIDE), so merging is
pure concatenation — DB rows copy with their ids, feature-store shards copy
with sequential renumbering, no remapping. Source collections are deduped by
(location, type) since every worker registers the same media dirs.

The reference has no distributed ingest (extract-features.py is single
process); this closes the multi-host item for pod-scale corpora.

    python -m wise_tpu_torch.cli.merge_projects --target-dir merged \\
        --source-dir w0 --source-dir w1

Copy of ``wise_tpu/cli/merge_projects.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import argparse
import logging
import shutil
import sys
from pathlib import Path

from .. import db as wdb
from ..project import WiseProject

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="merge-projects",
        description="Merge per-worker ingest projects into one project.",
    )
    p.add_argument("--target-dir", required=True, type=str)
    p.add_argument("--source-dir", action="append", required=True,
                   dest="source_dirs", type=str,
                   help="worker project dir (repeatable, merged in order)")
    return p


def _copy_shards(src_dir: Path, dst_dir: Path, media_type: str):
    """Copy tar shards, renumbering to continue the target's sequence
    (hardlink when possible — same filesystem — else copy)."""
    dst_dir.mkdir(parents=True, exist_ok=True)
    existing = sorted(dst_dir.glob(f"{media_type}-*.tar"))
    next_idx = (
        int(existing[-1].stem.rsplit("-", 1)[1]) + 1 if existing else 0
    )
    copied = 0
    for shard in sorted(src_dir.glob(f"{media_type}-*.tar")):
        dst = dst_dir / f"{media_type}-{next_idx:06d}.tar"
        try:
            import os

            os.link(shard, dst)
        except OSError:
            shutil.copy2(shard, dst)
        next_idx += 1
        copied += 1
    return copied


def _merge_db(src_conn, dst_conn) -> dict:
    """Copy source_collections (deduped by location+type), media, vectors,
    imported_metadata. Media/vector ids copy verbatim (disjoint ranges);
    collisions abort the merge."""
    sc_map = {}
    for row in src_conn.execute(
        "SELECT id, location, type FROM source_collections"
    ):
        hit = dst_conn.execute(
            "SELECT id FROM source_collections WHERE location = ? AND type = ?",
            (row["location"], row["type"]),
        ).fetchone()
        if hit is None:
            cur = dst_conn.execute(
                "INSERT INTO source_collections (location, type) VALUES (?,?)",
                (row["location"], row["type"]),
            )
            sc_map[row["id"]] = cur.lastrowid
        else:
            sc_map[row["id"]] = hit["id"]

    counts = {"media": 0, "vectors": 0, "imported_metadata": 0}
    for row in src_conn.execute("SELECT * FROM media"):
        if dst_conn.execute(
            "SELECT 1 FROM media WHERE id = ?", (row["id"],)
        ).fetchone():
            raise SystemExit(
                f"media id {row['id']} exists in target — source projects "
                "were not ingested with disjoint --ingest-worker ranks"
            )
        d = dict(row)
        d["source_collection_id"] = sc_map[d["source_collection_id"]]
        cols = ",".join(d)
        dst_conn.execute(
            f"INSERT INTO media ({cols}) VALUES "
            f"({','.join('?' for _ in d)})",
            tuple(d.values()),
        )
        counts["media"] += 1
    for row in src_conn.execute("SELECT * FROM vectors"):
        d = dict(row)
        dst_conn.execute(
            f"INSERT INTO vectors ({','.join(d)}) VALUES "
            f"({','.join('?' for _ in d)})",
            tuple(d.values()),
        )
        counts["vectors"] += 1
    for row in src_conn.execute("SELECT * FROM imported_metadata"):
        d = dict(row)
        dst_conn.execute(
            f"INSERT INTO imported_metadata ({','.join(d)}) VALUES "
            f"({','.join('?' for _ in d)})",
            tuple(d.values()),
        )
        counts["imported_metadata"] += 1
    return counts


def _merge_thumbs(src_conn, dst_conn) -> int:
    n = 0
    for row in src_conn.execute(
        "SELECT media_id, timestamp, content FROM thumbnails"
    ):
        dst_conn.execute(
            "INSERT INTO thumbnails (media_id, timestamp, content) "
            "VALUES (?,?,?)",
            (row["media_id"], row["timestamp"], row["content"]),
        )
        n += 1
    return n


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    sources = [WiseProject(d) for d in args.source_dirs]
    for s in sources:
        if not s.db_path.exists():
            print(f"{s.project_dir} has no project database", file=sys.stderr)
            return 1
    target = WiseProject(args.target_dir, create_project=True)
    if not target.config_path.exists():
        target.save_config(sources[0].load_config())

    dst_conn = wdb.init_project(target.db_path)
    dst_thumbs = wdb.init_thumbs(target.thumbs_db_path)

    for src in sources:
        src_conn = wdb.connect(src.db_path, readonly=True)
        counts = _merge_db(src_conn, dst_conn)
        shards = 0
        assets = src.discover_assets()
        for media_type, by_id in assets.items():
            if media_type == "metadata":
                continue
            for asset_id in by_id:
                shards += _copy_shards(
                    Path(by_id[asset_id]["features_dir"]),
                    target.create_features_dir(asset_id),
                    media_type,
                )
        thumbs = 0
        if src.thumbs_db_path.exists():
            src_thumbs = wdb.connect(src.thumbs_db_path, readonly=True)
            thumbs = _merge_thumbs(src_thumbs, dst_thumbs)
            src_thumbs.close()
        src_conn.close()
        dst_conn.commit()
        dst_thumbs.commit()
        logger.info(
            f"merged {src.project_dir}: {counts['media']} media, "
            f"{counts['vectors']} vectors, {shards} store shards, "
            f"{thumbs} thumbnails"
        )
    n = dst_conn.execute("SELECT COUNT(*) FROM vectors").fetchone()[0]
    print(
        f"merged {len(sources)} projects into {args.target_dir} "
        f"({n} vectors); run create-index.py next"
    )
    dst_conn.close()
    dst_thumbs.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

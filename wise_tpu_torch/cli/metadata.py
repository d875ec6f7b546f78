"""metadata CLI: import CSV metadata into a project metadata table.

Behavioural port of the reference's metadata.py (:40-305): column values can
reference CSV columns directly ("filename") or via "{col}"-format templates
("{participant_id}/videos/{video_id}.MP4"); reserved columns are
__filename/__metadata_id/__starttime/__stoptime; rows are validated against
the media table (filename must exist; timestamps within the media duration);
times accept seconds or hh:mm:ss.ms. The FTS index over the resulting table
is built by create-index.py.

Copy of ``wise_tpu/cli/metadata.py``, with its imports bound to
wise_tpu_torch.
"""

from __future__ import annotations

import argparse
import csv
import logging
import sqlite3
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from .. import db as wdb
from ..db.repository import MediaRepo
from ..project import WiseProject

logger = logging.getLogger(__name__)

WISE_COLNAME_PREFIX = "__"
SEGMENT_COLUMNS = ["__filename", "__metadata_id", "__starttime", "__stoptime"]


def get_csv_row_col_value(row: Dict, col_id: str):
    """col_id None -> None: --col-starttime/--col-stoptime are optional
    (file-level metadata with no temporal segment, MetadataType.FILE)."""
    if col_id is None:
        return None
    if "{" in col_id and "}" in col_id:
        return col_id.format(**row)
    return row[col_id]


def hhmmss_to_sec(hhmmss: str) -> float:
    tok = hhmmss.split(":")
    if len(tok) != 3:
        raise ValueError(f"expected hh:mm:ss[.ms], got {hhmmss}")
    hh, mm = int(tok[0]), int(tok[1])
    if "." in tok[2]:
        ss_s, ms_s = tok[2].split(".")
        ss, ms = int(ss_s), int(ms_s)
    else:
        ss, ms = int(tok[2]), 0
    return float(hh * 3600 + mm * 60 + ss + ms / 100.0)


def time2sec(t):
    if t is None:
        return None
    if isinstance(t, (int, float)):
        return float(t)
    t = str(t)
    if ":" in t:
        return hhmmss_to_sec(t)
    return float(t)


def load_metadata_from_csv(csv_filename, args) -> Tuple[List[Dict], List[str]]:
    rows: List[Dict] = []
    metadata_colnames = list(args.col_metadata or [])
    with open(csv_filename, "r") as f:
        sample = f.read(2048)
        if not csv.Sniffer().has_header(sample):
            raise ValueError("csv file must have a header row")
        f.seek(0)
        dialect = csv.Sniffer().sniff(sample)
        f.seek(0)
        reader = csv.DictReader(f, dialect=dialect)
        for row in reader:
            try:
                rec = {
                    "__filename": get_csv_row_col_value(row, args.col_filename),
                    "__metadata_id": get_csv_row_col_value(
                        row, args.col_metadata_id
                    ),
                    "__starttime": time2sec(
                        get_csv_row_col_value(row, args.col_starttime)
                    ),
                    "__stoptime": time2sec(
                        get_csv_row_col_value(row, args.col_stoptime)
                    ),
                }
                for col in metadata_colnames:
                    rec[col] = row[col]
                rows.append(rec)
            except Exception:
                logger.exception(f"Error parsing row: {row}")
    return rows, metadata_colnames


def get_valid_metadata(rows: List[Dict], conn) -> List[Dict]:
    repo = MediaRepo()
    missing, bad_ts = set(), 0
    valid = []
    duration_cache: Dict[str, float] = {}
    for rec in rows:
        fname = rec["__filename"]
        if fname not in duration_cache:
            media = repo.get_row_by_column_match(conn, "path", fname)
            if media is None:
                duration_cache[fname] = -1.0  # file not in project
            else:
                # durationless media (images) accept file-level metadata;
                # only a real duration can bound timestamps
                duration_cache[fname] = (
                    float(media.duration) if media.duration else 0.0
                )
        duration = duration_cache[fname]
        if duration < 0:
            missing.add(fname)
            continue
        start, stop = rec["__starttime"], rec["__stoptime"]
        has_ts = start is not None or stop is not None
        if has_ts and duration <= 0:
            # temporal metadata on durationless media (images/bad probe)
            bad_ts += 1
            continue
        if start is not None and (start < 0 or start >= duration):
            bad_ts += 1
            continue
        if stop is not None and (stop < 0 or stop > duration + 1e-6):
            bad_ts += 1
            continue
        valid.append(rec)
    print(
        f"Adding {len(valid)} rows of metadata "
        f"(discarded {len(rows) - len(valid)} rows)"
    )
    if missing:
        print(f"  - {len(missing)} filenames not found in WISE project: {sorted(missing)}")
    if bad_ts:
        print(f"  - {bad_ts} rows with out-of-range timestamps discarded")
    return valid


def add_metadata(metadata_db, metadata_table, rows: List[Dict],
                 metadata_colnames: List[str]) -> None:
    colnames = SEGMENT_COLUMNS + metadata_colnames
    specs = [
        f"{c} NUMERIC" if c in ("__starttime", "__stoptime") else f"{c} TEXT"
        for c in colnames
    ]
    with sqlite3.connect(str(metadata_db)) as conn:
        cur = conn.cursor()
        cur.execute(f"DROP TABLE IF EXISTS {metadata_table}")
        cur.execute(f"CREATE TABLE {metadata_table} ({', '.join(specs)})")
        placeholders = ",".join("?" * len(colnames))
        cur.executemany(
            f"INSERT INTO {metadata_table}({','.join(colnames)}) "
            f"VALUES ({placeholders})",
            [tuple(r[c] for c in colnames) for r in rows],
        )
        conn.commit()


def metadata_exist(metadata_db: Path, metadata_table: str) -> bool:
    if not Path(metadata_db).exists():
        return False
    with sqlite3.connect(str(metadata_db)) as conn:
        row = conn.execute(
            "SELECT COUNT(*) FROM sqlite_master WHERE type='table' AND name=?",
            (metadata_table,),
        ).fetchone()
    return row[0] > 0


def build_parser():
    p = argparse.ArgumentParser(
        prog="metadata",
        description="Manage metadata associated with media in a WISE project.",
    )
    p.add_argument("command", choices=["import"], nargs="?")
    p.add_argument("--from-csv", type=str)
    p.add_argument("--metadata-id", type=str,
                   help='FOLDER_NAME/DB_NAME/TABLE_NAME, e.g. "EK-100/ann/train"')
    p.add_argument("--col-metadata-id", type=str)
    p.add_argument("--col-filename", type=str)
    p.add_argument("--col-starttime", type=str)
    p.add_argument("--col-stoptime", type=str)
    p.add_argument("--col-metadata", action="append", type=str)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--project-dir", required=True, type=str)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.command != "import":
        print(f"unknown command {args.command}")
        return 1
    project = WiseProject(args.project_dir)
    conn = wdb.connect(project.db_path, readonly=True)
    metadata_db, metadata_table = project.metadata_db_table(args.metadata_id)
    if metadata_exist(metadata_db, metadata_table) and not args.overwrite:
        print(
            f'metadata "{args.metadata_id}" already exists in file {metadata_db}'
        )
        return 0
    rows, metadata_colnames = load_metadata_from_csv(args.from_csv, args)
    if not rows:
        print("metadata not found")
        return 1
    valid = get_valid_metadata(rows, conn)
    add_metadata(metadata_db, metadata_table, valid, metadata_colnames)
    return 0


if __name__ == "__main__":
    sys.exit(main())

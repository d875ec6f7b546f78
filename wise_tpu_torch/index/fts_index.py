"""Full-text metadata search via SQLite FTS5.

Same behaviour as the reference's SqliteSearchIndex
(ox-vgg/WISE/src/index/sqlite_search_index.py): ``create_index`` builds a
``<table>_fts`` FTS5 virtual table over all non-reserved (non-``__``)
columns; ``load_index`` snapshots the DB into :memory: for lock-free serving;
``search`` runs an FTS MATCH joined back to the base table and returns
(filename, start, stop, rank) tuples. Deliberately host-side — metadata FTS
is not TPU work (SURVEY.md §2b).

Copy of ``wise_tpu/index/fts_index.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import logging
import sqlite3
from typing import List

from .search_index import SearchIndex

logger = logging.getLogger(__name__)

RESERVED_PREFIX = "__"


class SqliteSearchIndex(SearchIndex):
    def __init__(self, media_type: str, asset_id: str, asset: dict, config=None):
        self.media_type = media_type  # "metadata"
        self.asset_id = asset_id
        self.db_path = asset["metadata_db"]
        self.table = asset["metadata_table"]
        self._conn = None

    def _table_columns(self, conn) -> List[str]:
        rows = conn.execute(f"PRAGMA table_info({self.table})").fetchall()
        return [r[1] for r in rows]

    def create_index(self, index_type: str = "fts5", overwrite: bool = False) -> bool:
        conn = sqlite3.connect(self.db_path)
        try:
            fts = f"{self.table}_fts"
            exists = conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' AND name=?",
                (fts,),
            ).fetchone()
            if exists:
                if not overwrite:
                    logger.info(f"FTS table {fts} exists, skipping")
                    return False
                conn.execute(f"DROP TABLE {fts}")
            cols = [
                c
                for c in self._table_columns(conn)
                if not c.startswith(RESERVED_PREFIX)
            ]
            if not cols:
                raise ValueError(f"no indexable columns in {self.table}")
            col_list = ",".join(f'"{c}"' for c in cols)
            conn.execute(
                f"CREATE VIRTUAL TABLE {fts} USING fts5({col_list}, "
                f"content='{self.table}', content_rowid='rowid')"
            )
            conn.execute(
                f"INSERT INTO {fts}(rowid, {col_list}) "
                f"SELECT rowid, {col_list} FROM {self.table}"
            )
            conn.commit()
            return True
        finally:
            conn.close()

    def load_index(self, index_type: str = "fts5") -> bool:
        src = sqlite3.connect(self.db_path)
        self._conn = sqlite3.connect(":memory:", check_same_thread=False)
        src.backup(self._conn)
        src.close()
        return True

    def search(self, media_type: str, query, topk: int, query_type: str = "text"):
        """Returns (distances, results) where results are dicts with
        __filename/__starttime/__stoptime plus matched columns."""
        if self._conn is None:
            raise RuntimeError("load_index() must be called before search()")
        fts = f"{self.table}_fts"
        # quote the query for FTS5 string syntax
        q = '"' + str(query).replace('"', '""') + '"'
        cur = self._conn.execute(
            f"SELECT t.rowid, t.*, f.rank FROM {fts} f "
            f"JOIN {self.table} t ON t.rowid = f.rowid "
            f"WHERE {fts} MATCH ? ORDER BY f.rank LIMIT ?",
            (q, int(topk)),
        )
        cols = [d[0] for d in cur.description]
        rows = cur.fetchall()
        results = []
        dists = []
        for row in rows:
            rec = dict(zip(cols, row))
            dists.append(-float(rec.get("rank", 0.0)))  # bm25 rank: lower=better
            results.append(rec)
        return dists, results

"""Typed CRUD repositories over sqlite3.

Equivalent role to the reference's generic SQLAlchemy repository
(ox-vgg/WISE/src/repository/base.py:43-147) and its query helpers
(ox-vgg/WISE/src/repository/__init__.py:42-151), rebuilt on stdlib
sqlite3 with batch insert paths for the ingestion hot loop.

Copy of ``wise_tpu/db/repository.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import datetime
import sqlite3
from typing import Any, Dict, Iterator, List, Optional, Sequence

from ..data_models import (
    MediaMetadata,
    MediaType,
    ModalityType,
    SourceCollection,
    SourceCollectionType,
    ThumbnailMetadata,
    VectorAndMediaMetadata,
    VectorMetadata,
)


def _enum_to_db(v: Any) -> Any:
    """SQLAlchemy's sa.Enum persists member *names* — match that."""
    import enum

    if isinstance(v, enum.Enum):
        return v.name
    return v


def _parse_enum(enum_cls, raw):
    if raw is None:
        return None
    if isinstance(raw, enum_cls):
        return raw
    try:
        return enum_cls[raw]         # by name ("VIDEO")
    except KeyError:
        return enum_cls(raw)         # by value ("video")


def _parse_dt(raw):
    if raw is None or isinstance(raw, datetime.datetime):
        return raw
    try:
        return datetime.datetime.fromisoformat(str(raw))
    except ValueError:
        return None


class _Repo:
    table: str = ""
    columns: Sequence[str] = ()

    def _row_to_model(self, row: sqlite3.Row):
        raise NotImplementedError

    def _model_to_params(self, obj) -> Dict[str, Any]:
        raise NotImplementedError

    def get(self, conn: sqlite3.Connection, id: int):
        row = conn.execute(
            f"SELECT * FROM {self.table} WHERE id = ?", (id,)
        ).fetchone()
        return self._row_to_model(row) if row else None

    def list(self, conn: sqlite3.Connection) -> Iterator:
        for row in conn.execute(f"SELECT * FROM {self.table}"):
            yield self._row_to_model(row)

    def get_count(self, conn: sqlite3.Connection) -> int:
        return conn.execute(f"SELECT COUNT(*) FROM {self.table}").fetchone()[0]

    def create(self, conn: sqlite3.Connection, obj):
        params = self._model_to_params(obj)
        cols = [c for c in params if params[c] is not None or c != "id"]
        if params.get("id") is None and "id" in cols:
            cols.remove("id")
        placeholders = ",".join("?" for _ in cols)
        cur = conn.execute(
            f"INSERT INTO {self.table} ({','.join(cols)}) VALUES ({placeholders})",
            tuple(params[c] for c in cols),
        )
        new = obj.model_copy()
        new.id = params.get("id") or cur.lastrowid
        return new

    def create_batch(self, conn: sqlite3.Connection, objs: List) -> List:
        """Batched insert; returns objects with assigned ids (contiguous)."""
        out = []
        for obj in objs:
            out.append(self.create(conn, obj))
        return out

    def update(self, conn: sqlite3.Connection, id: int, obj):
        params = self._model_to_params(obj)
        params.pop("id", None)
        sets = ",".join(f"{c} = ?" for c in params)
        conn.execute(
            f"UPDATE {self.table} SET {sets} WHERE id = ?",
            tuple(params.values()) + (id,),
        )
        new = obj.model_copy()
        new.id = id
        return new

    def delete(self, conn: sqlite3.Connection, id: int) -> None:
        conn.execute(f"DELETE FROM {self.table} WHERE id = ?", (id,))

    def get_row_by_column_match(self, conn: sqlite3.Connection, column: str, value):
        row = conn.execute(
            f"SELECT * FROM {self.table} WHERE {column} = ?", (_enum_to_db(value),)
        ).fetchone()
        return self._row_to_model(row) if row else None

    def list_by_column_match(self, conn: sqlite3.Connection, column: str, value):
        for row in conn.execute(
            f"SELECT * FROM {self.table} WHERE {column} = ?", (_enum_to_db(value),)
        ):
            yield self._row_to_model(row)


class SourceCollectionRepo(_Repo):
    table = "source_collections"

    def _row_to_model(self, row):
        return SourceCollection(
            id=row["id"],
            location=row["location"],
            type=_parse_enum(SourceCollectionType, row["type"]),
        )

    def _model_to_params(self, obj: SourceCollection):
        return {
            "id": obj.id,
            "location": obj.location,
            "type": _enum_to_db(SourceCollectionType(obj.type)),
        }


class MediaRepo(_Repo):
    table = "media"

    def _row_to_model(self, row):
        return MediaMetadata(
            id=row["id"],
            source_collection_id=row["source_collection_id"],
            path=row["path"],
            checksum=row["checksum"],
            size_in_bytes=row["size_in_bytes"],
            date_modified=_parse_dt(row["date_modified"]),
            media_type=_parse_enum(MediaType, row["media_type"]),
            format=row["format"],
            width=row["width"],
            height=row["height"],
            num_frames=row["num_frames"],
            duration=row["duration"],
        )

    def _model_to_params(self, obj: MediaMetadata):
        return {
            "id": obj.id,
            "source_collection_id": obj.source_collection_id,
            "path": obj.path,
            "checksum": obj.checksum,
            "size_in_bytes": obj.size_in_bytes,
            "date_modified": obj.date_modified.isoformat()
            if obj.date_modified
            else None,
            "media_type": _enum_to_db(MediaType(obj.media_type)),
            "format": obj.format,
            "width": obj.width,
            "height": obj.height,
            "num_frames": obj.num_frames,
            "duration": obj.duration,
        }


class VectorRepo(_Repo):
    table = "vectors"

    def _row_to_model(self, row):
        return VectorMetadata(
            id=row["id"],
            modality=_parse_enum(ModalityType, row["modality"]),
            media_id=row["media_id"],
            timestamp=row["timestamp"],
            end_timestamp=row["end_timestamp"],
        )

    def _model_to_params(self, obj: VectorMetadata):
        return {
            "id": obj.id,
            "modality": _enum_to_db(ModalityType(obj.modality)),
            "media_id": obj.media_id,
            "timestamp": obj.timestamp,
            "end_timestamp": obj.end_timestamp,
        }

    def create_batch(self, conn, objs: List[VectorMetadata],
                     id_base: int = 0) -> List[VectorMetadata]:
        """Single executemany; relies on sqlite rowid monotonicity within the
        statement to assign contiguous ids. ``id_base`` floors the id range —
        multi-host ingest gives each worker a disjoint 2^40 range so merged
        projects never collide."""
        if not objs:
            return []
        cur = conn.execute("SELECT COALESCE(MAX(id), 0) FROM vectors")
        base = max(cur.fetchone()[0], id_base)
        rows = [
            (
                base + i + 1,
                _enum_to_db(ModalityType(o.modality)),
                o.media_id,
                o.timestamp,
                o.end_timestamp,
            )
            for i, o in enumerate(objs)
        ]
        conn.executemany(
            "INSERT INTO vectors (id, modality, media_id, timestamp, end_timestamp)"
            " VALUES (?,?,?,?,?)",
            rows,
        )
        out = []
        for i, o in enumerate(objs):
            n = o.model_copy()
            n.id = base + i + 1
            out.append(n)
        return out


class ThumbnailRepo(_Repo):
    table = "thumbnails"

    def _row_to_model(self, row):
        return ThumbnailMetadata(
            id=row["id"],
            media_id=row["media_id"],
            timestamp=row["timestamp"],
            content=row["content"],
        )

    def _model_to_params(self, obj: ThumbnailMetadata):
        return {
            "id": obj.id,
            "media_id": obj.media_id,
            "timestamp": obj.timestamp,
            "content": obj.content,
        }


class MetadataRepo:
    """imported_metadata rows (no surrogate pk)."""

    def create(self, conn, media_id: int, external_id: Optional[str], metadata_json: str):
        conn.execute(
            "INSERT INTO imported_metadata (media_id, external_id, metadata)"
            " VALUES (?,?,?)",
            (media_id, external_id, metadata_json),
        )


# ---------------------------------------------------------------------------
# query helpers (reference: src/repository/__init__.py:42-151)
# ---------------------------------------------------------------------------

def get_full_metadata_batch(
    conn: sqlite3.Connection, vector_ids: Sequence[int]
) -> List[VectorAndMediaMetadata]:
    """vectors ⋈ media for a batch of vector ids, output ordered to match the
    input id order (reference: repository/__init__.py get_full_metadata_batch)."""
    if len(vector_ids) == 0:
        return []
    ids = [int(i) for i in vector_ids]
    placeholders = ",".join("?" for _ in ids)
    rows = conn.execute(
        f"""
        SELECT v.id AS vector_id, v.modality, v.media_id, v.timestamp,
               v.end_timestamp,
               m.id AS m_id, m.source_collection_id, m.path, m.checksum,
               m.size_in_bytes, m.date_modified, m.media_type, m.format,
               m.width, m.height, m.num_frames, m.duration
        FROM vectors v JOIN media m ON v.media_id = m.id
        WHERE v.id IN ({placeholders})
        """,
        ids,
    ).fetchall()
    by_id = {}
    for row in rows:
        by_id[row["vector_id"]] = VectorAndMediaMetadata(
            id=row["vector_id"],
            modality=_parse_enum(ModalityType, row["modality"]),
            media_id=row["media_id"],
            timestamp=row["timestamp"],
            end_timestamp=row["end_timestamp"],
            source_collection_id=row["source_collection_id"],
            path=row["path"],
            checksum=row["checksum"],
            size_in_bytes=row["size_in_bytes"],
            date_modified=_parse_dt(row["date_modified"]),
            media_type=_parse_enum(MediaType, row["media_type"]),
            format=row["format"],
            width=row["width"],
            height=row["height"],
            num_frames=row["num_frames"],
            duration=row["duration"],
        )
    return [by_id[i] for i in ids if i in by_id]


def get_thumbnail_by_timestamp(
    thumbs_conn: sqlite3.Connection, media_id: int, timestamp: float
) -> Optional[bytes]:
    """Thumbnail in window [t-0.25, t+2] nearest to t (reference:
    repository/__init__.py get_thumbnail_by_timestamp)."""
    row = thumbs_conn.execute(
        """
        SELECT content FROM thumbnails
        WHERE media_id = ? AND timestamp >= ? AND timestamp <= ?
        ORDER BY timestamp ASC LIMIT 1
        """,
        (media_id, timestamp - 0.25, timestamp + 2.0),
    ).fetchone()
    return row["content"] if row else None


def get_featured_vector_ids(conn: sqlite3.Connection) -> List[int]:
    """A vector near the 4 s mark of each video (reference:
    repository/__init__.py get_featured_images). Returns ALL candidates —
    the caller shuffles with the fixed seed and THEN caps (the reference
    order: routes.py:1159-1165; capping first would select a different
    subset than the reference on >cap corpora)."""
    rows = conn.execute(
        """
        SELECT v.id FROM vectors v
        JOIN media m ON v.media_id = m.id
        WHERE v.timestamp >= 4.0 AND v.modality IN ('IMAGE','VIDEO')
        GROUP BY v.media_id
        ORDER BY v.media_id
        """,
    ).fetchall()
    return [r["id"] for r in rows]


def get_project_total_duration(conn: sqlite3.Connection) -> float:
    row = conn.execute(
        "SELECT SUM(duration) FROM media WHERE media_type IN ('VIDEO','AV','AUDIO')"
    ).fetchone()
    return float(row[0] or 0.0)


def get_counts(conn: sqlite3.Connection) -> Dict[str, int]:
    return {
        "num_vectors": conn.execute("SELECT COUNT(*) FROM vectors").fetchone()[0],
        "num_media_files": conn.execute("SELECT COUNT(*) FROM media").fetchone()[0],
    }

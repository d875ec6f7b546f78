"""SQLite metadata database.

Schema mirrors the reference's SQLAlchemy Core tables
(ox-vgg/WISE/src/db/tables/__init__.py:5-76) so existing WiseProject
databases read/write unchanged. Enum-typed columns store the enum *name*
(e.g. "VIDEO"), matching SQLAlchemy's ``sa.Enum`` persistence.

The reference layers SQLAlchemy over sqlite; we use stdlib sqlite3 directly:
the DB is host-side metadata, not TPU compute, and dropping the ORM removes
per-row overhead in the ingestion hot loop (reference commits per-vector via
repo.create, extract-features.py:347-375 — we batch with executemany).

Copy of ``wise_tpu/db/__init__.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path


PROJECT_SCHEMA = """
CREATE TABLE IF NOT EXISTS source_collections (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    location VARCHAR(1024) NOT NULL,
    type VARCHAR(10) NOT NULL
);
CREATE TABLE IF NOT EXISTS media (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    source_collection_id INTEGER NOT NULL
        REFERENCES source_collections(id) ON DELETE CASCADE,
    path VARCHAR(1024) NOT NULL,
    checksum BLOB,
    size_in_bytes INTEGER,
    date_modified DATETIME,
    media_type VARCHAR(5) NOT NULL,
    format VARCHAR(5) NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    num_frames INTEGER,
    duration FLOAT
);
CREATE TABLE IF NOT EXISTS vectors (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    modality VARCHAR(5) NOT NULL,
    media_id INTEGER NOT NULL REFERENCES media(id) ON DELETE CASCADE,
    timestamp FLOAT,
    end_timestamp FLOAT
);
CREATE TABLE IF NOT EXISTS imported_metadata (
    media_id INTEGER NOT NULL REFERENCES media(id) ON DELETE CASCADE,
    external_id VARCHAR(2048),
    metadata TEXT NOT NULL DEFAULT '{}'
);
CREATE INDEX IF NOT EXISTS ix_vectors_media_id ON vectors (media_id);
CREATE INDEX IF NOT EXISTS ix_media_source_collection_id
    ON media (source_collection_id);
"""

THUMBS_SCHEMA = """
CREATE TABLE IF NOT EXISTS thumbnails (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    media_id INTEGER NOT NULL,
    timestamp FLOAT,
    content BLOB NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_thumbnails_media_id ON thumbnails (media_id);
CREATE INDEX IF NOT EXISTS ix_thumbnails_timestamp ON thumbnails (timestamp);
CREATE INDEX IF NOT EXISTS ix_thumbnails_media_id_and_timestamp
    ON thumbnails (media_id, timestamp);
"""


def connect(db_path: Path, readonly: bool = False) -> sqlite3.Connection:
    db_path = Path(db_path)
    if readonly:
        conn = sqlite3.connect(
            f"file:{db_path.absolute()}?mode=ro", uri=True, check_same_thread=False
        )
    else:
        db_path.parent.mkdir(parents=True, exist_ok=True)
        conn = sqlite3.connect(str(db_path), check_same_thread=False)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
    conn.row_factory = sqlite3.Row
    conn.execute("PRAGMA foreign_keys=ON")
    return conn


def init_project(db_path: Path) -> sqlite3.Connection:
    conn = connect(db_path)
    conn.executescript(PROJECT_SCHEMA)
    conn.commit()
    return conn


def init_thumbs(db_path: Path) -> sqlite3.Connection:
    conn = connect(db_path)
    conn.executescript(THUMBS_SCHEMA)
    conn.commit()
    return conn

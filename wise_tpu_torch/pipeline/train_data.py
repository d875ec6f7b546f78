"""(frame, caption) pair sampling for CLIP fine-tuning.

Imported metadata segments (``__filename/__starttime/__stoptime`` + a caption
column, see cli/metadata.py) pair a video frame at the segment midpoint with
the caption text, yielding contrastive batches for
parallel.train.CLIPTrainer.

Copy of ``wise_tpu/pipeline/train_data.py`` (numpy, sqlite3, and cv2 inside
``sample_frame`` only), its imports bound to this package.
"""

from __future__ import annotations

import logging
import sqlite3
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import db as wdb
from ..project import WiseProject

logger = logging.getLogger(__name__)


def load_caption_segments(
    project: WiseProject, metadata_id: str, caption_column: str
) -> List[Tuple[str, float, str]]:
    """Returns [(abs_media_path, midpoint_s, caption)]."""
    assets = project.discover_assets()
    if metadata_id not in assets.get("metadata", {}):
        raise ValueError(f"metadata id {metadata_id!r} not found in project")
    meta = assets["metadata"][metadata_id]
    conn = wdb.connect(project.db_path, readonly=True)
    loc_by_path = {
        row["path"]: row["location"]
        for row in conn.execute(
            "SELECT m.path, s.location FROM media m "
            "JOIN source_collections s ON m.source_collection_id = s.id"
        )
    }
    out = []
    with sqlite3.connect(meta["metadata_db"]) as mconn:
        mconn.row_factory = sqlite3.Row
        for row in mconn.execute(
            f"SELECT __filename, __starttime, __stoptime, "
            f'"{caption_column}" AS cap FROM {meta["metadata_table"]}'
        ):
            fname = row["__filename"]
            if fname not in loc_by_path:
                continue
            mid = 0.5 * (row["__starttime"] + row["__stoptime"])
            out.append(
                (str(Path(loc_by_path[fname]) / fname), float(mid), row["cap"])
            )
    return out


def sample_frame(path: str, timestamp: float, size: int) -> Optional[np.ndarray]:
    """Decode one frame near `timestamp`, resized to (size, size) RGB uint8."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    cap.set(cv2.CAP_PROP_POS_MSEC, timestamp * 1000.0)
    ok, img = cap.read()
    cap.release()
    if not ok:
        return None
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)


def caption_batches(
    segments: List[Tuple[str, float, str]],
    tokenizer,
    batch_size: int,
    image_size: int,
    seed: int = 0,
    epochs: int = 1,
    rank: int = 0,
    world: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (images (B,S,S,3) f32 in [0,1]-ish raw uint8->float, tokens
    (B, ctx) int32). Frames are decoded lazily and cached per segment.

    With ``world`` > 1, ``batch_size`` is the global batch and rank
    ``rank`` yields its B = batch_size / world rows of each: every rank
    draws the same seeded order, and of its stream (the epochs' orders one
    after another) rank r takes the r-th run of B segments in every run of
    batch_size, so it decodes and tokenizes only its own rows. Where every
    frame decodes, rank r's rows are rows r*B..(r+1)*B of the one-process
    global batch; a frame that does not decode is skipped by its rank
    alone, which fills its rows from its next run."""
    rng = np.random.default_rng(seed)
    cache = {}
    rows = batch_size // world
    # the partial batch carries ACROSS epochs: with fewer segments than
    # batch_size, per-epoch resets would discard every partial batch and
    # the generator would yield nothing (observed as a train CLI run
    # finishing at step 0 on a 2-segment project)
    batch_imgs, batch_txts = [], []
    position = 0
    for _ in range(epochs):
        order = rng.permutation(len(segments))
        for i in order:
            position += 1
            if (position - 1) // rows % world != rank:
                continue
            path, mid, cap = segments[i]
            if i not in cache:
                cache[i] = sample_frame(path, mid, image_size)
            if cache[i] is None:
                continue
            batch_imgs.append(cache[i])
            batch_txts.append(cap)
            if len(batch_imgs) == rows:
                yield (
                    np.stack(batch_imgs).astype(np.float32) / 255.0,
                    tokenizer(batch_txts),
                )
                batch_imgs, batch_txts = [], []

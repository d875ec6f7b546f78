"""Shot boundary detection over decoded frame streams, on the card.

Port of ``wise_tpu/pipeline/shots.py``: the same names, signatures and
scores. Each frame becomes a 32x32 thumbnail on the device (the reference's
``jax.image.resize(..., "linear")``, which antialiases: its triangle kernel
widens by src / 32, applied here as two products with the exact separable
weights of ``models/clip/preprocess.py`` ``resize_weights``); adjacent thumbnails are scored by
colour-histogram intersection distance plus mean absolute pixel difference;
boundaries are thresholded adaptively (median / MAD) on the host. Results
land in a ``shots`` table inside the project's internal DB, and the
serve-time shot merging keeps working unchanged on top.

Frames go to the device a chunk at a time, and only the chunk's thumbnails
stay there (the last one carried into the next chunk, so the chunks overlap
by one frame): no whole video sits on the card, and
``detect_shots_for_project`` keeps each decoded chunk's thumbnails, not its
frames.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io.dataset import get_dataset
from ..models.clip.preprocess import resize_weights
from ..utils.device import default_device

logger = logging.getLogger(__name__)

SHOTS_SCHEMA = """
CREATE TABLE IF NOT EXISTS shots (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    media_id INTEGER NOT NULL,
    start_time FLOAT NOT NULL,
    end_time FLOAT NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_shots_media_id ON shots (media_id);
"""

#: thumbnail side, and frames a chunk sends to the device at once
THUMB = 32
CHUNK = 128


def _thumbnails(frames: torch.Tensor) -> torch.Tensor:
    """frames (T, H, W, 3) uint8 on the device -> (T, 32, 32, 3) f32 in
    [0, 1]: channels moved first while still uint8, then the width resized
    (x @ Ww^T) and the height (Wh @ x) as f32 products; an axis already 32
    wide is left as it is, as jax.image.resize leaves it."""
    _, h, w, _ = frames.shape
    x = frames.permute(0, 3, 1, 2).contiguous().float() / 255.0
    if w != THUMB:
        ww = resize_weights(w, THUMB, "linear")
        x = x @ torch.from_numpy(ww.T).to(x.device)
    if h != THUMB:
        wh = resize_weights(h, THUMB, "linear")
        x = torch.from_numpy(wh).to(x.device) @ x
    return x.permute(0, 2, 3, 1)


def _scores(small: torch.Tensor, bins: int) -> torch.Tensor:
    """(T, 32, 32, 3) thumbnails -> (T-1,) change scores: histogram
    intersection distance (bins per channel, counted by bincount) plus the
    mean absolute pixel difference."""
    t = small.shape[0]
    q = torch.clamp((small * bins).to(torch.int32), 0, bins - 1)
    # bin index t * 3 * bins + channel * bins + q of every pixel
    base = (torch.arange(t, device=small.device)[:, None, None, None] * 3
            + torch.arange(3, device=small.device)) * bins
    hist = torch.bincount((base + q).reshape(-1).long(),
                          minlength=t * 3 * bins).reshape(t, 3, bins)
    hist = hist.float() / (THUMB * THUMB)
    inter = torch.minimum(hist[:-1], hist[1:]).sum(dim=(1, 2)) / 3.0
    pix = (small[1:] - small[:-1]).abs().mean(dim=(1, 2, 3))
    return (1.0 - inter) + pix


class ChangeScorer:
    """Change scores of a frame stream fed chunk by chunk: each chunk goes
    to the device, becomes thumbnails, and is scored with the last
    thumbnail of the chunk before it; only that thumbnail is kept."""

    def __init__(self, bins: int = 16):
        self.bins = bins
        self.device = default_device()
        self._last: Optional[torch.Tensor] = None
        self._scores: List[torch.Tensor] = []

    def add(self, frames) -> None:
        """frames (n, H, W, 3) uint8, numpy or a tensor."""
        if len(frames) == 0:
            return
        x = torch.as_tensor(frames).to(self.device)
        small = _thumbnails(x)
        if self._last is not None:
            small = torch.cat([self._last, small])
        if small.shape[0] > 1:
            self._scores.append(_scores(small, self.bins))
        self._last = small[-1:]

    def scores(self) -> np.ndarray:
        """(frames added - 1,) f32 on the host."""
        if not self._scores:
            return np.zeros((0,), np.float32)
        return torch.cat(self._scores).cpu().numpy()


def frame_change_scores(frames, bins: int = 16) -> np.ndarray:
    """frames (T, H, W, 3) uint8 -> (T-1,) change score in [0, 2].

    Score = histogram intersection distance + mean absolute pixel difference
    on 32x32 thumbnails; both in [0, 1]. The frames go to the card (the CPU
    when WISE_TORCH_DEVICE asks for it) CHUNK at a time."""
    scorer = ChangeScorer(bins)
    for i in range(0, len(frames), CHUNK):
        scorer.add(frames[i:i + CHUNK])
    return scorer.scores()


def _spans(scores: np.ndarray, pts: np.ndarray, threshold: float,
           adaptive_k: float) -> List[Tuple[float, float]]:
    """The reference's threshold and span walk over the scores of
    ``len(pts)`` frames."""
    med = float(np.median(scores))
    mad = float(np.median(np.abs(scores - med)))
    thr = max(threshold, med + adaptive_k * max(mad, 1e-4))
    boundaries = np.where(scores > thr)[0]  # boundary after frame i
    spans = []
    start = 0
    for b in boundaries:
        spans.append((float(pts[start]), float(pts[b])))
        start = b + 1
    spans.append((float(pts[start]), float(pts[len(pts) - 1])))
    return spans


def detect_shots(
    frames: np.ndarray,
    pts: np.ndarray,
    threshold: float = 0.2,
    adaptive_k: float = 8.0,
) -> List[Tuple[float, float]]:
    """Returns [(start_s, end_s)] shot spans covering the sampled frames.
    A boundary is declared between frames i, i+1 when the change score
    exceeds max(threshold, median + adaptive_k * MAD) — median/MAD so the
    boundaries themselves don't inflate the threshold."""
    if len(frames) < 2:
        if len(frames) == 1:
            return [(float(pts[0]), float(pts[0]))]
        return []
    return _spans(frame_change_scores(frames), np.asarray(pts), threshold,
                  adaptive_k)


def detect_shots_for_project(project_dir, feature_id: str = None,
                             threshold: float = 0.2) -> int:
    """Decode every video in the project at the configured fps and populate
    the shots table. Returns number of shots written. Each decoded chunk is
    scored on the card as it arrives; only its pts and the scores stay."""
    from .. import db as wdb
    from ..data_models import MediaType
    from ..project import WiseProject

    project = WiseProject(project_dir)
    cfg = project.load_config()
    conn = wdb.connect(project.db_path)
    conn.executescript(SHOTS_SCHEMA)
    rows = conn.execute(
        "SELECT m.id, m.path, s.location FROM media m "
        "JOIN source_collections s ON m.source_collection_id = s.id "
        "WHERE m.media_type IN ('VIDEO','AV')"
    ).fetchall()
    total = 0
    for row in rows:
        path = f"{row['location']}/{row['path']}"
        scorer = ChangeScorer()
        pts_all = []
        ds = get_dataset(MediaType.VIDEO, [path], video=cfg.video)
        for _, chunk in ds:
            scorer.add(chunk["video"].tensor)
            pts_all.append(chunk["video"].pts)
        if not pts_all:
            continue
        pts = np.concatenate(pts_all)
        if len(pts) < 2:
            spans = [(float(p), float(p)) for p in pts]
        else:
            spans = _spans(scorer.scores(), pts, threshold, 8.0)
        conn.execute("DELETE FROM shots WHERE media_id = ?", (row["id"],))
        for start, end in spans:
            conn.execute(
                "INSERT INTO shots (media_id, start_time, end_time) "
                "VALUES (?,?,?)",
                (row["id"], start, end),
            )
            total += 1
    conn.commit()
    conn.close()
    logger.info(f"wrote {total} shots for {len(rows)} videos")
    return total

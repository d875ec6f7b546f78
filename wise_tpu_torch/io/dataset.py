"""Chunked media datasets.

Equivalent to the reference's MediaDataset layer
(ox-vgg/WISE/src/dataloader/dataset.py): each media file streams as
fixed-length chunks per stream —

- ``video``: (frames_per_chunk, H, W, 3) uint8 RGB at `frame_rate` fps
  with per-frame pts,
- ``audio``: (segment_samples,) float32 mono at `sampling_rate` with
  segment start pts (short tail segments are yielded and filtered by the
  caller, matching extract-features.py:336-337 discard semantics),
- ``thumbnails``: list of (pts, jpeg_bytes) at thumbnail fps/height/quality.

Worker sharding: files are assigned to workers by ``worker_id`` stride
(reference: dataset.py:322-336). Preprocessing to model input space happens
downstream on-device (fused JAX kernels), not here — this layer only decodes.

Copy of ``wise_tpu/io/dataset.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import AudioIngestConfig, ThumbnailConfig, VideoIngestConfig
from ..data_models import MediaMetadata, MediaType
from ..utils import md5
from . import decode

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MediaChunk:
    tensor: np.ndarray
    pts: np.ndarray  # per-frame pts (video) or scalar start pts (audio)


class MediaDataset:
    """Iterates (path, {stream: MediaChunk | list}) chunks over many files."""

    def __init__(
        self,
        files: Sequence,
        media_type: MediaType,
        video: Optional[VideoIngestConfig] = None,
        audio: Optional[AudioIngestConfig] = None,
        thumbnails: Optional[ThumbnailConfig] = None,
        worker_id: int = 0,
        num_workers: int = 1,
    ):
        self.files = [Path(f) for f in files]
        self.media_type = MediaType(media_type)
        self.video = video
        self.audio = audio
        self.thumbnails = thumbnails
        self.worker_id = worker_id
        self.num_workers = max(1, num_workers)

    # -- per-file iterators -------------------------------------------------
    def _iter_video_file(self, path) -> Iterator[Dict]:
        v = self.video
        thumb = self.thumbnails
        for frames, pts in decode.iter_video_frames(
            path, v.frame_rate, v.frames_per_chunk
        ):
            out = {"video": MediaChunk(tensor=frames, pts=pts)}
            if thumb is not None:
                # thumbnail fps == sampling fps in the default config; sample
                # the decoded frames on the thumbnail grid
                stride = max(1, int(round(v.frame_rate / thumb.frame_rate)))
                thumbs = []
                for i in range(0, len(frames), stride):
                    small = decode.resize_height(frames[i], thumb.height)
                    thumbs.append((float(pts[i]), decode.encode_jpeg(small, thumb.jpeg_quality)))
                out["thumbnails"] = thumbs
            yield out

    def _iter_audio_file(self, path) -> Iterator[Dict]:
        a = self.audio
        segment_samples = int(a.sampling_rate * a.segment_length)
        for samples, pts0 in decode.iter_audio_segments(
            path, a.sampling_rate, segment_samples
        ):
            yield {"audio": MediaChunk(tensor=samples, pts=np.float64(pts0))}

    def _iter_av_file(self, path) -> Iterator[Dict]:
        """Interleave aligned video chunks and audio segments. Segment
        lengths must match (validated by the configs, reference:
        dataset.py:184-210)."""
        video_it = self._iter_video_file(path)
        audio_it = self._iter_audio_file(path)
        v_next = next(video_it, None)
        a_next = next(audio_it, None)
        while v_next is not None or a_next is not None:
            out = {}
            if v_next is not None:
                out.update(v_next)
                v_next = next(video_it, None)
            if a_next is not None:
                out.update(a_next)
                a_next = next(audio_it, None)
            yield out

    def _iter_image_file(self, path) -> Iterator[Dict]:
        img = decode.load_image(path)
        out = {"image": MediaChunk(tensor=img[None], pts=np.zeros(1))}
        if self.thumbnails is not None:
            small = decode.resize_height(img, self.thumbnails.height)
            out["thumbnails"] = [
                (0.0, decode.encode_jpeg(small, self.thumbnails.jpeg_quality))
            ]
        yield out

    def _get_media_iterator(self, path) -> Iterator[Dict]:
        mt = self.media_type
        if mt == MediaType.IMAGE:
            return self._iter_image_file(path)
        if mt == MediaType.VIDEO:
            return self._iter_video_file(path)
        if mt == MediaType.AUDIO:
            return self._iter_audio_file(path)
        if mt == MediaType.AV:
            return self._iter_av_file(path)
        raise ValueError(f"unknown media type {mt}")

    def __iter__(self) -> Iterator[Tuple[Path, Dict]]:
        for i, path in enumerate(self.files):
            if i % self.num_workers != self.worker_id:
                continue
            try:
                for chunk in self._get_media_iterator(path):
                    yield path, chunk
            except Exception:
                logger.exception(f"failed to stream {path}, skipping")


class VideoDataset(MediaDataset):
    def __init__(self, files, video=None, thumbnails=None, **kw):
        super().__init__(
            files, MediaType.VIDEO,
            video=video or VideoIngestConfig(),
            thumbnails=thumbnails, **kw,
        )


class AudioDataset(MediaDataset):
    def __init__(self, files, audio=None, **kw):
        super().__init__(
            files, MediaType.AUDIO, audio=audio or AudioIngestConfig(), **kw
        )


class AVDataset(MediaDataset):
    def __init__(self, files, video=None, audio=None, thumbnails=None, **kw):
        video = video or VideoIngestConfig()
        audio = audio or AudioIngestConfig()
        validate_segment_lengths(video, audio)
        super().__init__(
            files, MediaType.AV, video=video, audio=audio,
            thumbnails=thumbnails, **kw,
        )


class ImageDataset(MediaDataset):
    def __init__(self, files, thumbnails=None, **kw):
        super().__init__(files, MediaType.IMAGE, thumbnails=thumbnails, **kw)


def validate_segment_lengths(video: VideoIngestConfig, audio: AudioIngestConfig):
    """AV chunks must cover the same time span (reference:
    dataset.py validate_segment_lengths_from_options :184-210)."""
    video_span = video.frames_per_chunk / video.frame_rate
    if abs(video_span - audio.segment_length) > 1e-6:
        raise ValueError(
            f"video chunk span {video_span}s != audio segment {audio.segment_length}s"
        )


def get_dataset(media_type, files, **kw) -> MediaDataset:
    mt = MediaType(media_type)
    cls = {
        MediaType.VIDEO: VideoDataset,
        MediaType.AUDIO: AudioDataset,
        MediaType.AV: AVDataset,
        MediaType.IMAGE: ImageDataset,
    }[mt]
    return cls(files, **kw)


# ---------------------------------------------------------------------------
# metadata probing (reference: dataset.py get_media_metadata :50-147,
# get_metadata_for_valid_files :470-496)
# ---------------------------------------------------------------------------

def get_media_metadata(path, source_collection_id: int = 0) -> MediaMetadata:
    path = Path(path)
    media_type = decode.get_media_type(path)
    if media_type is None:
        raise IOError(f"cannot determine media type of {path}")
    info = decode.probe_media(path)
    if info is None:
        raise IOError(f"cannot probe {path}")
    stat = path.stat()
    return MediaMetadata(
        source_collection_id=source_collection_id,
        path=str(path),
        checksum=md5(path),
        size_in_bytes=stat.st_size,
        date_modified=datetime.datetime.fromtimestamp(stat.st_mtime),
        media_type=media_type,
        format=path.suffix.lstrip(".").lower(),
        width=info.width,
        height=info.height,
        num_frames=info.num_frames or None,
        duration=info.duration or None,
    )


def get_metadata_for_valid_files(
    files: Sequence,
) -> Tuple[List[Tuple[Path, MediaMetadata]], List[Path]]:
    """Probes every file; returns (valid [(path, metadata)], unknown_files).
    Invalid/undecodable files are skipped with a logged exception, matching
    the reference's best-effort semantics (dataset.py:470-496)."""
    valid, unknown = [], []
    for f in files:
        f = Path(f)
        try:
            valid.append((f, get_media_metadata(f)))
        except Exception:
            logger.exception(f"invalid media file {f}")
            unknown.append(f)
    return valid, unknown

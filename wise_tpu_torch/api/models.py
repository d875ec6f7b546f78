"""REST response models — field-compatible with the reference's FastAPI
response models (ox-vgg/WISE/api/routes.py:419-520) so the existing
React frontend's API contract (frontend/src/misc/types.ts:85-101) holds.

Copy of ``wise_tpu/api/models.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from pydantic import BaseModel, field_validator

PRECISION = 3


class MediaMetadataOut(BaseModel):
    id: str
    filename: str
    width: int
    height: int
    media_type: str
    format: str
    duration: float
    title: str = ""
    caption: str = ""
    copyright: str = ""


class MediaInfo(MediaMetadataOut):
    link: str
    thumbnail: str
    distance: Optional[float] = None

    @field_validator("distance")
    @classmethod
    def _round(cls, v):
        return round(v, PRECISION) if v is not None else v


class ImageInfo(MediaInfo):
    pass


class AudioInfo(MediaInfo):
    pass


class VideoInfo(MediaInfo):
    timeline_hover_thumbnails: str


class VectorResult(BaseModel):
    vector_id: str
    media_id: str
    link: str
    distance: float

    @field_validator("distance")
    @classmethod
    def _round(cls, v):
        return round(v, PRECISION)


class ImageVector(VectorResult):
    thumbnail: str
    thumbnail_score: float

    @field_validator("thumbnail_score")
    @classmethod
    def _round_ts(cls, v):
        return round(v, PRECISION)


class MediaSegment(VectorResult):
    ts: float
    te: float


class AudioSegment(MediaSegment):
    pass


class VideoSegment(MediaSegment):
    thumbnail: str
    thumbnail_score: float

    @field_validator("thumbnail_score")
    @classmethod
    def _round_ts(cls, v):
        return round(v, PRECISION)


class AudioResults(BaseModel):
    total: int
    unmerged_windows: List[AudioSegment]
    audios: Dict[str, AudioInfo]


class VideoAudioResults(BaseModel):
    total: int
    unmerged_windows: List[VideoSegment]
    merged_windows: List[VideoSegment]
    videos: Dict[str, VideoInfo]


class VideoResults(BaseModel):
    total: int
    unmerged_windows: List[VideoSegment]
    merged_windows: List[VideoSegment]
    videos: Dict[str, VideoInfo]


class ImageResults(BaseModel):
    total: int
    vectors: List[ImageVector]
    images: Dict[str, ImageInfo]


class SearchResponse(BaseModel):
    time: float
    audio_results: Optional[AudioResults] = None
    video_audio_results: Optional[VideoAudioResults] = None
    video_results: Optional[VideoResults] = None
    image_results: Optional[ImageResults] = None


class InfoResponse(BaseModel):
    project_id: str
    num_media_files: int
    num_vectors: int
    total_duration: float
    media_types: List[str]

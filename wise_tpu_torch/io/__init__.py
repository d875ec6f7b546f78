"""Copy of ``wise_tpu/io/__init__.py``, with its imports bound to wise_tpu_torch."""

from .decode import MediaInfo, probe_media, get_media_type
from .dataset import (
    AVDataset,
    AudioDataset,
    ImageDataset,
    MediaChunk,
    MediaDataset,
    VideoDataset,
    get_dataset,
    get_media_metadata,
    get_metadata_for_valid_files,
)

__all__ = [
    "MediaInfo",
    "probe_media",
    "get_media_type",
    "MediaChunk",
    "MediaDataset",
    "AVDataset",
    "VideoDataset",
    "AudioDataset",
    "ImageDataset",
    "get_dataset",
    "get_media_metadata",
    "get_metadata_for_valid_files",
]

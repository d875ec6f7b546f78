"""Core enums and pydantic data models.

Contract-compatible with the reference's ``src/data_models.py`` (see
ox-vgg/WISE/src/data_models.py:7-85) so that serialized rows, REST
payloads, and store layouts interoperate.

Copy of ``wise_tpu/data_models.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import datetime
import enum
from typing import Any, Dict, Optional

from pydantic import BaseModel, ConfigDict


class SourceCollectionType(str, enum.Enum):
    DIR = "dir"
    WEBDATASET = "webdataset"


class MediaType(str, enum.Enum):
    IMAGE = "image"
    VIDEO = "video"
    AUDIO = "audio"
    AV = "av"


class ModalityType(str, enum.Enum):
    TEXT = "text"
    IMAGE = "image"
    VIDEO = "video"
    AUDIO = "audio"


class QueryType(str, enum.Enum):
    NATURAL_LANGUAGE_QUERY = "NATURAL_LANGUAGE_QUERY"
    IMAGE_QUERY = "IMAGE_QUERY"
    IMAGE_CLASSIFICATION_QUERY = "IMAGE_CLASSIFICATION_QUERY"


class IndexType(str, enum.Enum):
    IndexFlatIP = "IndexFlatIP"
    IndexIVFFlat = "IndexIVFFlat"
    IndexIVFPQ = "IndexIVFPQ"


class MetadataType(str, enum.Enum):
    SEGMENT = "segment"
    FILE = "file"
    FRAME = "frame"
    REGION = "region"


class SourceCollection(BaseModel):
    id: Optional[int] = None
    location: str
    type: SourceCollectionType
    model_config = ConfigDict(from_attributes=True, use_enum_values=True)


class MediaMetadata(BaseModel):
    id: Optional[int] = None
    source_collection_id: int
    path: str
    checksum: Optional[bytes] = None
    size_in_bytes: Optional[int] = None
    date_modified: Optional[datetime.datetime] = None
    media_type: MediaType
    format: str
    width: int
    height: int
    num_frames: Optional[int] = None
    duration: Optional[float] = None
    model_config = ConfigDict(from_attributes=True)


class VectorMetadata(BaseModel):
    id: Optional[int] = None
    modality: ModalityType
    media_id: int
    timestamp: Optional[float] = None
    end_timestamp: Optional[float] = None


class VectorAndMediaMetadata(VectorMetadata, MediaMetadata):
    pass


class ThumbnailMetadata(BaseModel):
    id: Optional[int] = None
    media_id: int
    timestamp: Optional[float] = None
    content: bytes


class ExtraMediaMetadata(BaseModel):
    media_id: int
    external_id: Optional[str] = None
    metadata: Dict[str, Any]


class Project(BaseModel):
    id: str
    version: Optional[int] = None
    model_config = ConfigDict(from_attributes=True)

"""Host-side helpers: hashing, mime sniffing, globbing, small utilities.

Replaces the reference's src/dataloader/utils.py (md5/libmagic/glob) and
src/utils.py; libmagic is replaced by a magic-number signature table so no
native dependency is needed.

Copy of ``wise_tpu/utils/__init__.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import base64
import hashlib
import itertools
from pathlib import Path
from typing import Iterable, Iterator, List, Sequence, Tuple


def md5(path) -> bytes:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.digest()


# (prefix_offset, signature_bytes, mime)
_SIGNATURES: List[Tuple[int, bytes, str]] = [
    (0, b"\xff\xd8\xff", "image/jpeg"),
    (0, b"\x89PNG\r\n\x1a\n", "image/png"),
    (0, b"GIF87a", "image/gif"),
    (0, b"GIF89a", "image/gif"),
    (0, b"BM", "image/bmp"),
    (0, b"RIFF", "__riff__"),          # wav or webp or avi, disambiguated below
    (0, b"ID3", "audio/mpeg"),
    (0, b"\xff\xfb", "audio/mpeg"),
    (0, b"\xff\xf3", "audio/mpeg"),
    (0, b"\xff\xf2", "audio/mpeg"),
    (0, b"fLaC", "audio/flac"),
    (0, b"OggS", "__ogg__"),
    (0, b"\x1a\x45\xdf\xa3", "video/x-matroska"),
    (4, b"ftyp", "__iso__"),           # mp4 family
    (0, b"FLV\x01", "video/x-flv"),
    (0, b"\x30\x26\xb2\x75", "video/x-ms-asf"),
]

_EXT_MIME = {
    ".jpg": "image/jpeg", ".jpeg": "image/jpeg", ".png": "image/png",
    ".gif": "image/gif", ".bmp": "image/bmp", ".webp": "image/webp",
    ".mp4": "video/mp4", ".m4v": "video/mp4", ".mov": "video/quicktime",
    ".mkv": "video/x-matroska", ".webm": "video/webm", ".avi": "video/x-msvideo",
    ".wav": "audio/x-wav", ".mp3": "audio/mpeg", ".flac": "audio/flac",
    ".ogg": "audio/ogg", ".oga": "audio/ogg", ".m4a": "audio/mp4",
    ".aac": "audio/aac",
}


def get_mime_type(path) -> str:
    """Sniff mime type from file magic; fall back to extension."""
    p = Path(path)
    try:
        with open(p, "rb") as f:
            head = f.read(32)
    except OSError:
        head = b""
    for off, sig, mime in _SIGNATURES:
        if head[off : off + len(sig)] == sig:
            if mime == "__riff__":
                sub = head[8:12]
                if sub == b"WAVE":
                    return "audio/x-wav"
                if sub == b"WEBP":
                    return "image/webp"
                if sub == b"AVI ":
                    return "video/x-msvideo"
                return "application/octet-stream"
            if mime == "__ogg__":
                return "audio/ogg"
            if mime == "__iso__":
                brand = head[8:12]
                if brand in (b"qt  ",):
                    return "video/quicktime"
                if brand in (b"M4A ", b"M4B "):
                    return "audio/mp4"
                return "video/mp4"
            return mime
    return _EXT_MIME.get(p.suffix.lower(), "application/octet-stream")


def get_files_from_directory_with_extensions(
    root, extensions: Sequence[str]
) -> List[Path]:
    root = Path(root)
    out: List[Path] = []
    exts = {e.lower() if e.startswith(".") else "." + e.lower() for e in extensions}
    for p in sorted(root.rglob("*")):
        if p.is_file() and p.suffix.lower() in exts:
            out.append(p)
    return out


def argsort(seq: Sequence, reverse: bool = False) -> List[int]:
    return sorted(range(len(seq)), key=seq.__getitem__, reverse=reverse)


def batched(iterable: Iterable, n: int) -> Iterator[tuple]:
    it = iter(iterable)
    while True:
        chunk = tuple(itertools.islice(it, n))
        if not chunk:
            return
        yield chunk


def jpeg_data_uri(jpeg_bytes: bytes) -> str:
    return "data:image/jpeg;charset=utf-8;base64," + base64.b64encode(
        jpeg_bytes
    ).decode("ascii")

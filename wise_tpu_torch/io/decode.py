"""Unified media decode API with backend fallbacks.

Primary backend: the native FFmpeg extension (wise_tpu/native, loaded via
ctypes). Fallbacks: OpenCV (video, no audio), stdlib ``wave`` (PCM wav
audio), OpenCV imread (images). Equivalent role to the reference's
streamreader probing + streaming (src/dataloader/streamreader.py:132-260).

Copy of ``wise_tpu/io/decode.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import logging
import wave
from typing import Iterator, Optional, Tuple

import numpy as np

from ..data_models import MediaType
from ..utils import get_mime_type
from . import native_decoder

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MediaInfo:
    duration: float = 0.0
    width: int = 0
    height: int = 0
    fps: float = 0.0
    num_frames: int = 0
    has_video: bool = False
    has_audio: bool = False
    sample_rate: int = 0
    channels: int = 0


def get_media_type(path) -> Optional[MediaType]:
    """Infer MediaType from mime sniffing (reference:
    streamreader.py get_media_type :236-260), refined by stream probing for
    containers that may hold either/both streams."""
    mime = get_mime_type(path)
    if mime.startswith("image/"):
        return MediaType.IMAGE
    if mime.startswith("audio/"):
        return MediaType.AUDIO
    if mime.startswith("video/"):
        info = probe_media(path)
        if info is None:
            return None
        if info.has_video and info.has_audio:
            return MediaType.AV
        if info.has_video:
            return MediaType.VIDEO
        if info.has_audio:
            return MediaType.AUDIO
        return None
    return None


def probe_media(path) -> Optional[MediaInfo]:
    if native_decoder.available():
        try:
            with native_decoder.NativeDecoder(path, mode=2) as d:
                raw = d.info()
            return MediaInfo(**raw)
        except IOError:
            return None
    return _probe_fallback(path)


def _probe_fallback(path) -> Optional[MediaInfo]:
    mime = get_mime_type(path)
    if mime == "audio/x-wav":
        try:
            with wave.open(str(path), "rb") as w:
                frames = w.getnframes()
                rate = w.getframerate()
                return MediaInfo(
                    duration=frames / rate,
                    has_audio=True,
                    sample_rate=rate,
                    channels=w.getnchannels(),
                )
        except Exception:
            return None
    if mime.startswith("video/"):
        import cv2

        cap = cv2.VideoCapture(str(path))
        if not cap.isOpened():
            return None
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        info = MediaInfo(
            duration=n / fps if fps > 0 else 0.0,
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=fps,
            num_frames=n,
            has_video=True,
        )
        cap.release()
        return info
    if mime.startswith("image/"):
        import cv2

        img = cv2.imread(str(path))
        if img is None:
            return None
        return MediaInfo(width=img.shape[1], height=img.shape[0], has_video=False)
    return None


# ---------------------------------------------------------------------------
# streaming decode
# ---------------------------------------------------------------------------

def iter_video_frames(
    path, fps: float, frames_per_chunk: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (frames (n,H,W,3) uint8 RGB, pts (n,) float64) chunks sampled
    at `fps`."""
    if native_decoder.available():
        with native_decoder.NativeDecoder(path, mode=0, fps=fps) as d:
            info = d.info()
            w, h = info["width"], info["height"]
            if w <= 0 or h <= 0:
                return
            while True:
                frames, pts = d.read_video(frames_per_chunk, w, h)
                if frames is None:
                    return
                yield frames, pts
        return
    yield from _iter_video_cv2(path, fps, frames_per_chunk)


def _iter_video_cv2(path, fps, frames_per_chunk):
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    step = 1.0 / fps if fps > 0 else None
    frames, pts = [], []
    next_tick = 0
    prev = None
    prev_pts = -1.0
    frame_idx = 0
    try:
        while True:
            ok, img = cap.read()
            if not ok:
                break
            t = frame_idx / src_fps
            frame_idx += 1
            rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if step is None:
                frames.append(rgb)
                pts.append(t)
            else:
                while next_tick * step <= t + 1e-9:
                    target = next_tick * step
                    pick = prev if (prev is not None and prev_pts <= target) else rgb
                    frames.append(pick if pick is not None else rgb)
                    pts.append(target)
                    next_tick += 1
                    if len(frames) == frames_per_chunk:
                        yield np.stack(frames), np.asarray(pts)
                        frames, pts = [], []
                prev, prev_pts = rgb, t
            if step is None and len(frames) == frames_per_chunk:
                yield np.stack(frames), np.asarray(pts)
                frames, pts = [], []
    finally:
        cap.release()
    if frames:
        yield np.stack(frames), np.asarray(pts)


def iter_audio_segments(
    path, sample_rate: int, segment_samples: int
) -> Iterator[Tuple[np.ndarray, float]]:
    """Yields (mono float32 samples (n,), start_pts) segments."""
    if native_decoder.available():
        with native_decoder.NativeDecoder(
            path, mode=1, sample_rate=sample_rate
        ) as d:
            while True:
                samples, pts0 = d.read_audio(segment_samples)
                if samples is None:
                    return
                yield samples, pts0
        return
    yield from _iter_audio_wave(path, sample_rate, segment_samples)


def _iter_audio_wave(path, sample_rate, segment_samples):
    with wave.open(str(path), "rb") as w:
        src_rate = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        total = w.getnframes()
        raw = w.readframes(total)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise IOError(f"unsupported wav sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    if src_rate != sample_rate:
        # linear resample (fallback path only; native backend uses swresample)
        n_out = int(round(len(data) * sample_rate / src_rate))
        x_old = np.arange(len(data)) / src_rate
        x_new = np.arange(n_out) / sample_rate
        data = np.interp(x_new, x_old, data).astype(np.float32)
    for start in range(0, len(data), segment_samples):
        seg = data[start : start + segment_samples]
        if len(seg) == 0:
            break
        yield seg, start / sample_rate


def load_image(path) -> np.ndarray:
    """(H,W,3) uint8 RGB."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def encode_jpeg(rgb: np.ndarray, quality: int = 80) -> bytes:
    import cv2

    ok, buf = cv2.imencode(
        ".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
        [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)],
    )
    if not ok:
        raise IOError("jpeg encode failed")
    return bytes(buf)


def resize_height(rgb: np.ndarray, target_height: int) -> np.ndarray:
    import cv2

    h, w = rgb.shape[:2]
    if h <= target_height:
        return rgb
    new_w = max(1, int(round(w * target_height / h)))
    return cv2.resize(rgb, (new_w, target_height), interpolation=cv2.INTER_AREA)

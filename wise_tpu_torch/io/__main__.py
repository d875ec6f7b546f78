"""Standalone dataloader CLI (reference: src/dataloader/__main__.py) —
exercise decode/chunking without the rest of the pipeline.

    python -m wise_tpu_torch.io DIR --media-type video --frame-rate 2

Copy of ``wise_tpu/io/__main__.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

from ..config import AudioIngestConfig, ThumbnailConfig, VideoIngestConfig
from ..data_models import MediaType
from ..pipeline.extract import (
    AUDIO_EXTENSIONS,
    IMAGE_EXTENSIONS,
    VIDEO_EXTENSIONS,
)
from ..utils import get_files_from_directory_with_extensions
from .dataset import get_dataset, get_metadata_for_valid_files


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="wise_tpu_torch.io", description=__doc__)
    p.add_argument("media_dir")
    p.add_argument("--media-type", default="video",
                   choices=["video", "audio", "av", "image"])
    p.add_argument("--frame-rate", type=float, default=2.0)
    p.add_argument("--frames-per-chunk", type=int, default=None,
                   help="frames per decoded chunk (defaults from --preset)")
    p.add_argument(
        "--preset", default="clip", choices=["clip", "internvideo"],
        help="model-family chunking preset (reference "
             "src/dataloader/__main__.py:34-69): 'clip' embeds frames "
             "independently (1 frame/chunk at 2 fps); 'internvideo' feeds "
             "8-frame clips per chunk",
    )
    p.add_argument("--audio-rate", type=int, default=48000)
    p.add_argument("--segment-length", type=float, default=4.0)
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--thumbnails", action="store_true")
    p.add_argument("--probe-only", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    exts = {
        "video": VIDEO_EXTENSIONS,
        "av": VIDEO_EXTENSIONS,
        "audio": AUDIO_EXTENSIONS,
        "image": IMAGE_EXTENSIONS,
    }[args.media_type]
    files = get_files_from_directory_with_extensions(args.media_dir, exts)
    valid, unknown = get_metadata_for_valid_files(files)
    print(f"{len(valid)} valid files, {len(unknown)} unknown")
    for path, meta in valid:
        print(
            f"  {meta.path or path}: {meta.media_type.value} "
            f"{meta.width}x{meta.height} {meta.duration or 0:.1f}s"
        )
    if args.probe_only:
        return 0

    mt = MediaType(args.media_type)
    # preset defaults (reference src/dataloader/__main__.py:92-175: CLIP
    # embeds single frames, InternVideo consumes 8-frame clips)
    fpc = args.frames_per_chunk
    if fpc is None:
        fpc = 8 if args.preset == "internvideo" else 1
    kw = {}
    if mt in (MediaType.VIDEO, MediaType.AV):
        kw["video"] = VideoIngestConfig(
            frame_rate=args.frame_rate,
            frames_per_chunk=fpc,
            segment_length=fpc / args.frame_rate,
        )
    if mt in (MediaType.AUDIO, MediaType.AV):
        kw["audio"] = AudioIngestConfig(
            sampling_rate=args.audio_rate, segment_length=args.segment_length
        )
    if args.thumbnails and mt != MediaType.AUDIO:
        kw["thumbnails"] = ThumbnailConfig()

    ds = get_dataset(mt, [p for p, _ in valid], num_workers=0, **kw)
    t0 = time.time()
    n_chunks, n_frames, n_samples = 0, 0, 0
    for path, chunk in ds:
        n_chunks += 1
        if "video" in chunk:
            n_frames += chunk["video"].tensor.shape[0]
        if "image" in chunk:
            n_frames += chunk["image"].tensor.shape[0]
        if "audio" in chunk:
            n_samples += chunk["audio"].tensor.shape[0]
    dt = time.time() - t0
    print(
        f"{n_chunks} chunks ({n_frames} frames, {n_samples} audio samples) "
        f"in {dt:.2f}s -> {n_frames/dt if dt else 0:.1f} frames/s decode"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

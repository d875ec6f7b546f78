"""extract-features CLI (argument surface compatible with the reference's
extract-features.py:132-231).

Copy of ``wise_tpu/cli/extract_features.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..pipeline.extract import extract_features

DEFAULT_IMAGE_FEATURE_ID = "mlfoundations/open_clip/ViT-B-32/laion2b_s34b_b79k"
DEFAULT_AUDIO_FEATURE_ID = "microsoft/clap/2023/four-datasets"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="extract-features",
        description=(
            "Initialise a WISE project by extracting features from images, "
            "audio and videos (TPU-native pipeline)."
        ),
    )
    p.add_argument("media_dir_list", nargs="+",
                   help="process images, audio and video from these folders")
    p.add_argument("--media-include", action="append", dest="media_include_list",
                   default=[], type=str,
                   help="shell-style glob matched against the file name, e.g. '*.mp4' "
                        "(reference extract-features.py:145-152; its Kinetics "
                        "script passes globs)")
    from ..config import StoreConfig

    _store_defaults = StoreConfig()
    p.add_argument("--shard-maxcount", type=int,
                   default=_store_defaults.shard_maxcount)
    p.add_argument("--shard-maxsize", type=int,
                   default=_store_defaults.shard_maxsize)
    p.add_argument("--num-workers", type=int, default=0,
                   help="host decode worker threads")
    p.add_argument("--feature-store", dest="feature_store_type",
                   default=_store_defaults.store_type,
                   choices=["webdataset", "numpy"])
    p.add_argument("--image-feature-id", default=DEFAULT_IMAGE_FEATURE_ID)
    p.add_argument("--video-feature-id", default=DEFAULT_IMAGE_FEATURE_ID)
    p.add_argument("--audio-feature-id", default=DEFAULT_AUDIO_FEATURE_ID)
    p.add_argument("--batch-size", type=int, default=256,
                   help="encoder batch size (frames)")
    p.add_argument("--project-dir", required=True, type=str)
    p.add_argument("--thumbnails", default=True,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--ingest-worker", type=int, default=0,
                   help="this host's rank in a multi-host ingest (see "
                        "--ingest-workers)")
    p.add_argument("--ingest-workers", type=int, default=1,
                   help="total ingest hosts; each processes every N-th file "
                        "of the sorted scan into its own --project-dir, "
                        "combined afterwards with merge-projects.py")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not (0 <= args.ingest_worker < args.ingest_workers):
        parser.error(
            f"--ingest-worker {args.ingest_worker} must be in "
            f"[0, --ingest-workers={args.ingest_workers})"
        )
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s (%(threadName)s): %(name)s - %(levelname)s - %(message)s",
    )
    stats = extract_features(
        media_dir_list=args.media_dir_list,
        project_dir=args.project_dir,
        image_feature_id=args.image_feature_id,
        video_feature_id=args.video_feature_id,
        audio_feature_id=args.audio_feature_id,
        feature_store_type=args.feature_store_type,
        shard_maxcount=args.shard_maxcount,
        shard_maxsize=args.shard_maxsize,
        num_workers=args.num_workers,
        thumbnails=args.thumbnails,
        media_include_list=args.media_include_list,
        batch_size=args.batch_size,
        ingest_worker=args.ingest_worker,
        ingest_workers=args.ingest_workers,
    )
    print(
        f"extracted {stats.num_video_vectors} video, "
        f"{stats.num_audio_vectors} audio, {stats.num_image_vectors} image "
        f"vectors from {stats.num_files} files in {stats.elapsed_sec:.1f}s "
        f"({stats.frames_per_sec:.1f} frames/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

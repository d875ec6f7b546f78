"""create-index CLI (argument surface compatible with the reference's
create-index.py:20-60).

Copy of ``wise_tpu/cli/create_index.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..index.factory import SearchIndexFactory
from ..project import WiseProject


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="create-index",
        description="Create a nearest neighbour search index for extracted features.",
    )
    p.add_argument("--media-type", action="append",
                   choices=["audio", "video", "metadata", "image"],
                   help="create index only for these media types (default: all)")
    p.add_argument("--index-type", default="IndexFlatIP",
                   choices=["IndexFlatIP", "IndexIVFFlat", "IndexIVFPQ"])
    p.add_argument("--overwrite", action="store_true", default=False)
    p.add_argument("--project-dir", required=True, type=str)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    project = WiseProject(args.project_dir)
    assets = project.discover_assets()
    config = project.load_config()

    media_type_list = args.media_type or list(assets.keys())
    for media_type in media_type_list:
        for asset_id, asset in assets.get(media_type, {}).items():
            index = SearchIndexFactory(
                media_type, asset_id, asset, config=config.index
            )
            if media_type == "metadata":
                index.create_index("fts5", args.overwrite)
            else:
                index.create_index(args.index_type, args.overwrite)
    return 0


if __name__ == "__main__":
    sys.exit(main())

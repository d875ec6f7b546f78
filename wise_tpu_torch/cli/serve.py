"""serve CLI (reference: serve.py:21-58).

Copy of ``wise_tpu/cli/serve.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser(
        prog="serve", description="Serve the WISE REST API + frontend."
    )
    p.add_argument("project_dir", type=str)
    p.add_argument("--hostname", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9670)
    p.add_argument("--index-type", default="IndexFlatIP",
                   choices=["IndexFlatIP", "IndexIVFFlat", "IndexIVFPQ"])
    p.add_argument("--storage-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="HBM dtype for the resident index (bfloat16 halves scan bandwidth)")
    p.add_argument("--query-blocklist", type=str, default=None,
                   help="file with one blocked query per line")
    p.add_argument("--frontend-dir", type=str, default=None,
                   help="prebuilt frontend bundle to mount at /{project}/")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s: %(name)s - %(levelname)s - %(message)s",
    )
    from ..api.server import serve
    from ..project import WiseProject

    project = WiseProject(args.project_dir)
    config = project.load_config().apply_env_overrides()
    if args.storage_dtype:
        config.index.storage_dtype = args.storage_dtype
    if args.frontend_dir is None:
        bundled = Path(__file__).resolve().parents[2] / "frontend"
        if (bundled / "index.html").exists():
            args.frontend_dir = str(bundled)
    if args.query_blocklist:
        blocked = [
            line.strip()
            for line in Path(args.query_blocklist).read_text().splitlines()
            if line.strip()
        ]
        config.search.query_blocklist = tuple(blocked)
    serve(
        args.project_dir,
        hostname=args.hostname,
        port=args.port,
        config=config,
        frontend_dir=args.frontend_dir,
        index_type=args.index_type,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

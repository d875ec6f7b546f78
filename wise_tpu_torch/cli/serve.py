"""serve CLI (wise_tpu/cli/serve.py): the REST API and frontend on the
port's search engine."""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from wise_tpu.cli import serve as _ref
from wise_tpu.project import WiseProject

build_parser = _ref.build_parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s: %(name)s - %(levelname)s - %(message)s",
    )
    from ..api.server import serve

    config = WiseProject(args.project_dir).load_config().apply_env_overrides()
    if args.storage_dtype:
        config.index.storage_dtype = args.storage_dtype
    if args.frontend_dir is None:
        bundled = Path(__file__).resolve().parents[2] / "frontend"
        if (bundled / "index.html").exists():
            args.frontend_dir = str(bundled)
    if args.query_blocklist:
        text = Path(args.query_blocklist).read_text()
        config.search.query_blocklist = tuple(
            line.strip() for line in text.splitlines() if line.strip())
    serve(args.project_dir, hostname=args.hostname, port=args.port,
          config=config, frontend_dir=args.frontend_dir,
          index_type=args.index_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())

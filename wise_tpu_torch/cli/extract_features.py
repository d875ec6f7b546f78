"""extract-features CLI (wise_tpu/cli/extract_features.py) on the port's
ingestion driver."""

from __future__ import annotations

import sys

from wise_tpu.cli import extract_features as _ref

from .._host import rebind
from ..pipeline.extract import extract_features

build_parser = _ref.build_parser
main = rebind(_ref.main, extract_features=extract_features)

if __name__ == "__main__":
    sys.exit(main())

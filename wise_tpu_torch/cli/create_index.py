"""create-index CLI (wise_tpu/cli/create_index.py) on the port's index."""

from __future__ import annotations

import sys

from wise_tpu.cli import create_index as _ref

from .._host import rebind
from ..index.factory import SearchIndexFactory

build_parser = _ref.build_parser
main = rebind(_ref.main, SearchIndexFactory=SearchIndexFactory)

if __name__ == "__main__":
    sys.exit(main())

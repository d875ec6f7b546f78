"""search CLI (wise_tpu/cli/search.py): one-shot queries, CSV batches and
the interactive console, on the port's indices."""

from __future__ import annotations

import sys

from wise_tpu.cli import search as _ref

from .._host import rebind
from ..index.factory import SearchIndexFactory

build_parser = _ref.build_parser
load_search_indices = rebind(_ref.load_search_indices,
                             SearchIndexFactory=SearchIndexFactory)
main = rebind(_ref.main, load_search_indices=load_search_indices)

if __name__ == "__main__":
    sys.exit(main())

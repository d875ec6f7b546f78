"""The search engine (wise_tpu/api/engine.py) over the port's indices: the
reference's engine (query fusion, coalesced device dispatch, temporal
merge, hydration) with the port's SearchIndexFactory."""

from __future__ import annotations

from wise_tpu.api import engine as _ref

from .._host import rebind
from ..index.factory import SearchIndexFactory


class SearchEngine(_ref.SearchEngine):
    __init__ = rebind(_ref.SearchEngine.__init__,
                      SearchIndexFactory=SearchIndexFactory)

"""Copy of ``wise_tpu/search/__init__.py``, with its imports bound to wise_tpu_torch."""

from .query_parser import parse_search_query

__all__ = ["parse_search_query"]

"""The REST server (wise_tpu/api/server.py): the reference's request
handler (``WiseAPIHandler``) bound to the port's SearchEngine."""

from __future__ import annotations

from wise_tpu.api import server as _ref

from .._host import rebind
from .engine import SearchEngine

WiseAPIHandler = _ref.WiseAPIHandler
create_server = rebind(_ref.create_server, SearchEngine=SearchEngine)
serve = rebind(_ref.serve, create_server=create_server)

"""The host layers the port shares with wise_tpu.

Project layout, the SQLite DB, feature stores, media IO, the ``.widx``
format, temporal merge and hydration, the REST handler, the coalescer and
the CLI argument surfaces are framework-free in wise_tpu and are reused as
they are. Two numpy-only modules sit in a package whose ``__init__`` imports
the JAX towers (``wise_tpu/models/clip/__init__.py``), so they are loaded by
file path: the CLIP tokenizer and the OpenCLIP checkpoint reader. The
drivers that reach a JAX factory through a module global are reused through
``rebind``.
"""

from __future__ import annotations

import importlib.util
import sys
import types
from pathlib import Path

import wise_tpu
# the reused host layers, re-exported (none of them imports jax)
from wise_tpu import config, data_models, db, io, project, search, store  # noqa: F401
from wise_tpu.db import repository  # noqa: F401

_WISE_TPU = Path(wise_tpu.__file__).resolve().parent


def _load_by_path(name: str, relpath: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _WISE_TPU / relpath)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


#: wise_tpu/models/clip/tokenizer.py (BPETokenizer, HashTokenizer)
clip_tokenizer = _load_by_path("wise_tpu_torch._clip_tokenizer",
                               "models/clip/tokenizer.py")
#: wise_tpu/models/clip/convert.py (open_clip state dict -> parameter tree)
clip_convert = _load_by_path("wise_tpu_torch._clip_convert",
                             "models/clip/convert.py")


def rebind(fn, **names):
    """A copy of the wise_tpu function ``fn`` whose module globals ``names``
    resolve to the port's objects instead: how the port reuses a host-side
    driver (extract, engine, server, CLI) that reaches a JAX factory through
    a module global. ``fn`` and its module are left as they are."""
    missing = [n for n in names if n not in fn.__globals__]
    if missing:
        raise AttributeError(f"{fn.__module__} has no globals {missing}")
    new = types.FunctionType(fn.__code__, {**fn.__globals__, **names},
                             fn.__name__, fn.__defaults__, fn.__closure__)
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__doc__ = fn.__doc__
    new.__qualname__ = fn.__qualname__
    return new

"""The host layers the port shares with wise_tpu.

Project layout, the SQLite DB, feature stores, media IO, the ``.widx``
format, temporal merge and hydration, the REST handler, the coalescer and
the CLI argument surfaces are framework-free in wise_tpu and are reused as
they are. Four numpy-only modules sit in packages whose ``__init__`` imports
the JAX towers (``wise_tpu/models/clip/__init__.py``,
``models/clap/__init__.py``), so they are loaded by file path: the CLIP
tokenizer, the OpenCLIP checkpoint reader, the CLAP caption tokenizer and
the msclap checkpoint converter. The pipeline, engine and CLI functions
that reach a JAX factory through a module global are reused through
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
clip_tokenizer = _load_by_path("wise_tpu_torch._ref.clip.tokenizer",
                               "models/clip/tokenizer.py")
#: wise_tpu/models/clip/convert.py (open_clip state dict -> parameter tree)
clip_convert = _load_by_path("wise_tpu_torch._ref.clip.convert",
                             "models/clip/convert.py")
#: wise_tpu/models/clap/tokenizer.py (get_caption_tokenizer). Its hash
#: fallback runs ``from ..clip.tokenizer import HashTokenizer`` when called;
#: loaded under ``wise_tpu_torch._ref.clap``, that import resolves to the
#: CLIP tokenizer loaded above (already in sys.modules), not to wise_tpu.
clap_tokenizer = _load_by_path("wise_tpu_torch._ref.clap.tokenizer",
                               "models/clap/tokenizer.py")
#: wise_tpu/models/clap/convert.py (msclap state dict -> parameter tree)
clap_convert = _load_by_path("wise_tpu_torch._ref.clap.convert",
                             "models/clap/convert.py")


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

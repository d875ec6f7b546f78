"""Vector search index over a feature store, on the port's device ops.

The exact flat index (IndexFlatIP semantics) with an ``.widx`` on-disk
format. The host half (``.widx`` build and load, the streaming build of a
store larger than RAM, id mapping, reconstruction, ``search`` and
``search_batch*``) is numpy; the device half is PyTorch: the vectors live on
the card, padded to a multiple of GROUP rows (f32, or bf16 with
``storage_dtype="bfloat16"``), and queries run ``ops.topk.flat_topk``.
IVF-Flat, IVF-PQ and int8 storage are not ported yet and raise
``NotImplementedError``.

Query prompts per modality are the reference's
(ox-vgg/WISE/src/index/feature_search_index.py:24-28).

The host half is copied from ``wise_tpu/index/feature_index.py`` (the flat
path's share of it).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import IndexConfig
from ..ops.topk import flat_topk, pad_rows
from ..store.factory import FeatureStoreFactory
from ..utils.device import default_device
from .format import IndexFileWriter, read_index_file, write_index_file
from .search_index import SearchIndex

logger = logging.getLogger(__name__)

QUERY_PROMPTS = {
    "image": "This is a photo of a ",
    "video": "This is a photo of a ",
    "audio": "this is the sound of ",
}


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP Queue A item 7)")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class FeatureSearchIndex(SearchIndex):
    GROUP = 4096  # top-k group size; DB rows pad to a multiple of this
    STREAM_BATCH = 4096

    def __init__(self, media_type: str, asset_id: str, asset: dict,
                 config: Optional[IndexConfig] = None, device=None):
        self.media_type = media_type
        self.asset_id = asset_id
        self.asset = asset
        self.config = config or IndexConfig()
        self.index_dir = Path(asset["index_dir"])
        self.device = torch.device(device) if device else default_device()
        self._extractor = None
        self._arrays = None
        self._metadata = None
        self._device_db = None

    # ------------------------------------------------------------------
    def index_path(self, index_type: str) -> Path:
        return self.index_dir / f"{self.media_type}-{index_type}.widx"

    @property
    def extractor(self):
        if self._extractor is None:
            from ..models.factory import FeatureExtractorFactory

            self._extractor = FeatureExtractorFactory(self.asset_id)
        return self._extractor

    # ------------------------------------------------------------------
    def _open_store(self):
        store = FeatureStoreFactory.load_store(
            self.media_type, Path(self.asset["features_dir"])
        )
        store.enable_read()
        return store

    def _load_store_matrix(self, store) -> Tuple[np.ndarray, np.ndarray]:
        n, d = store.feature_count, store.feature_dim
        ids = np.empty(n, dtype=np.int64)
        vecs = np.empty((n, d), dtype=np.float32)
        row = 0
        for batch_ids, batch in store.iter_batch(4096):
            m = len(batch_ids)
            ids[row : row + m] = batch_ids
            vecs[row : row + m] = batch.reshape(m, d)
            row += m
        assert row == n
        return ids, vecs

    def create_index(self, index_type: str, overwrite: bool = False) -> bool:
        if index_type != "IndexFlatIP":
            raise _unported(index_type)
        out = self.index_path(index_type)
        if out.exists() and not overwrite:
            logger.info(f"index {out} exists, skipping (overwrite=False)")
            return False
        self.index_dir.mkdir(parents=True, exist_ok=True)
        store = self._open_store()
        n, d = store.feature_count, store.feature_dim
        meta = {"index_type": "IndexFlatIP", "metric": "inner_product",
                "dim": d, "count": n}
        if n * d * 4 > self.config.stream_build_threshold_bytes:
            # a single sequential pass that never materialises the (N, D)
            # matrix; readers cannot tell the file from the in-memory one
            logger.info(f"streaming index build: type={index_type} n={n} d={d}")
            specs = {"ids": (np.int64, (n,)), "vectors": (np.float32, (n, d))}
            with IndexFileWriter(out, specs, meta) as w:
                row = 0
                for batch_ids, batch in store.iter_batch(self.STREAM_BATCH):
                    m = len(batch_ids)
                    w.write_rows("ids", row, np.asarray(batch_ids, np.int64))
                    w.write_rows("vectors", row, batch.reshape(m, d))
                    row += m
                assert row == n
            logger.info(f"wrote {out} (streamed)")
            return True
        ids, vecs = self._load_store_matrix(store)
        write_index_file(out, {"ids": ids, "vectors": vecs}, meta)
        logger.info(f"wrote {out}")
        return True

    # ------------------------------------------------------------------
    def load_index(self, index_type: str) -> bool:
        path = self.index_path(index_type)
        if not path.exists():
            return False
        self._metadata, self._arrays = read_index_file(path)
        self._index_type = self._metadata["index_type"]
        self._device_db = None  # drop a stale device copy
        return True

    def _ensure_device_db(self):
        """The vectors on the device once, rows padded to a multiple of
        GROUP (zero rows, masked by n_valid at search)."""
        if self._device_db is None:
            dtype = self.config.storage_dtype
            if dtype not in ("float32", "bfloat16"):
                raise _unported(f"storage_dtype={dtype}")
            host = np.array(self._arrays["vectors"], dtype=np.float32)
            db = pad_rows(torch.from_numpy(host).to(self.device), self.GROUP)
            self._device_db = db.to(getattr(torch, dtype))
        return self._device_db

    # ------------------------------------------------------------------
    def search(
        self, media_type: str, query, topk: int, query_type: str = "text"
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self._arrays is None:
            raise RuntimeError("load_index() must be called before search()")
        if query_type == "text":
            prompt = QUERY_PROMPTS.get(media_type, "")
            qvec = self.extractor.extract_text_features([prompt + str(query)])
        else:
            qvec = np.atleast_2d(np.asarray(query, dtype=np.float32))

        scores, rows = self._dispatch_search(qvec, topk)
        ids = self._rows_to_ids(scores, rows)
        return scores[0], ids[0]

    def _rows_to_ids(self, scores, rows):
        """Map result rows to vector ids; empty (-inf) slots — IVF/PQ probes
        can return fewer than k candidates — report id -1 so consumers drop
        them (faiss convention)."""
        ids = np.asarray(self._arrays["ids"])[rows]
        ids[np.isneginf(scores)] = -1
        return ids

    def _flat(self, qvec, topk):
        """Device (scores, rows) of the exact flat search, unrealised."""
        if self._index_type != "IndexFlatIP":
            raise _unported(self._index_type)
        if self.config.flat_approx_recall > 0.0 and not getattr(
                self, "_warned_approx", False):
            self._warned_approx = True
            logger.warning("flat_approx_recall is not ported; searching "
                           "exactly")
        n_valid = int(self._metadata["count"])
        q = torch.from_numpy(np.ascontiguousarray(qvec, dtype=np.float32))
        return flat_topk(q, self._ensure_device_db(), n_valid=n_valid,
                         k=min(int(topk), n_valid), group=self.GROUP)

    def _dispatch_search(self, qvec, topk):
        vals, rows = self._flat(qvec, topk)
        return _host(vals), _host(rows)

    def search_batch(
        self, query_vectors: np.ndarray, topk: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) query vectors -> (scores (Q, k), ids (Q, k))."""
        qvec = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        scores, rows = self._dispatch_search(qvec, topk)
        return scores, self._rows_to_ids(scores, rows)

    def search_batch_dispatch(self, query_vectors: np.ndarray, topk: int):
        """Dispatch-only half of ``search_batch`` for the serving coalescer
        (api/coalesce.py two-phase mode): the handle holds the unrealised
        device tensors, so the caller's critical section costs the enqueue
        and readbacks overlap across requester threads;
        ``search_batch_finalize`` realises one row."""
        qvec = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        return self._flat(qvec, topk)

    def search_batch_finalize(self, handle, i: int):
        """Realise row ``i`` of a ``search_batch_dispatch`` handle ->
        (scores (k,), ids (k,)); blocks until the batch has landed."""
        vals, rows = handle
        v, r = _host(vals[i:i + 1]), _host(rows[i:i + 1])
        return v[0], self._rows_to_ids(v, r)[0]

    def reconstruct_rows(self, rows) -> np.ndarray:
        """Stored vectors by row (faiss reconstruct_batch parity)."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        return np.asarray(self._arrays["vectors"][rows], np.float32)

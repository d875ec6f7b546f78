"""Vector search index on the port's device ops
(wise_tpu/index/feature_index.py).

Subclasses wise_tpu's FeatureSearchIndex, whose host side (.widx build and
load, id mapping, reconstruction) is numpy and stays as it is. The device
side is PyTorch: the IndexFlatIP vectors live on the card, padded to a
multiple of GROUP rows (f32, or bf16 with ``storage_dtype="bfloat16"``), and
queries run ``ops.topk.flat_topk``. IVF-Flat, IVF-PQ and int8 storage are not
ported yet.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from wise_tpu.index import feature_index as _ref

from ..models.clip.extractor import default_device
from ..ops.topk import flat_topk, pad_rows

logger = logging.getLogger(__name__)


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP Queue A item 7)")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class FeatureSearchIndex(_ref.FeatureSearchIndex):
    def __init__(self, media_type: str, asset_id: str, asset: dict,
                 config=None, device=None):
        super().__init__(media_type, asset_id, asset, config=config)
        self.device = torch.device(device) if device else default_device()

    @property
    def extractor(self):
        if self._extractor is None:
            from ..models.factory import FeatureExtractorFactory

            self._extractor = FeatureExtractorFactory(self.asset_id)
        return self._extractor

    def create_index(self, index_type: str, overwrite: bool = False) -> bool:
        if index_type != "IndexFlatIP":
            raise _unported(index_type)
        return super().create_index(index_type, overwrite)

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

    def _flat(self, qvec, topk):
        """Device (scores, rows) of the exact flat search, unrealised."""
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
        if self._index_type != "IndexFlatIP":
            raise _unported(self._index_type)
        return self._search_flat(qvec, topk)

    def _search_flat(self, qvec, topk):
        vals, rows = self._flat(qvec, topk)
        return _host(vals), _host(rows)

    def search_batch_dispatch(self, query_vectors, topk):
        """Dispatch-only half of ``search_batch``: the handle holds the
        device tensors, realised per row by ``search_batch_finalize``."""
        qvec = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        if self._index_type != "IndexFlatIP":
            raise _unported(self._index_type)
        return self._flat(qvec, topk)

    def search_batch_finalize(self, handle, i: int):
        vals, rows = handle
        v, r = _host(vals[i:i + 1]), _host(rows[i:i + 1])
        return v[0], self._rows_to_ids(v, r)[0]

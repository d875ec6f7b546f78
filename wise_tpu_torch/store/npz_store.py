"""Sharded .npz feature store.

Layout-compatible with the reference's NumpySaveStore
(ox-vgg/WISE/src/feature/store/numpy_save_store.py): shards named
``<store_name>-%06d.npz`` holding arrays ``feature_id`` (N,) and
``features`` (N, dim), at most shard_maxcount rows per shard.

Copy of ``wise_tpu/store/npz_store.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import glob
import os
import random
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from .feature_store import FeatureStore


class NpzShardStore(FeatureStore):
    EXTENSION = "npz"

    def __init__(self, store_name: str, store_data_dir):
        self.store_name = store_name
        self.store_data_dir = Path(store_data_dir)
        self.store_data_filename = str(
            self.store_data_dir / (store_name + "-%06d." + self.EXTENSION)
        )
        self.feature_count = -1
        self.feature_dim = -1
        self._shard_index = -1
        self._ids: List[int] = []
        self._rows: List[np.ndarray] = []
        self.shard_maxcount = 0
        self._writing = False
        self._shard_files: List[str] = []

    # -- write -------------------------------------------------------------
    def enable_write(self, shard_maxcount: int, shard_maxsize: int = 0, verbose: int = 0):
        self.shard_maxcount = int(shard_maxcount)
        self.store_data_dir.mkdir(parents=True, exist_ok=True)
        self._writing = True
        self._shard_index = -1
        # append mode: continue after any existing shards (resumable ingest)
        existing = self._discover_shards()
        if existing:
            last = Path(existing[-1]).stem
            self._shard_index = int(last.rsplit("-", 1)[1])
        self._ids, self._rows = [], []

    def add(self, id: int, features: np.ndarray) -> None:
        if not self._writing:
            raise ValueError("enable_write() must be called before add()")
        self._ids.append(int(id))
        self._rows.append(np.asarray(features).reshape(-1))
        if len(self._ids) >= self.shard_maxcount:
            self.save_current_shard()

    def save_current_shard(self) -> None:
        if not self._ids:
            return
        self._shard_index += 1
        path = self.store_data_filename % self._shard_index
        np.savez(
            path,
            feature_id=np.asarray(self._ids, dtype=np.int64),
            features=np.stack(self._rows),
        )
        self._ids, self._rows = [], []

    # -- read --------------------------------------------------------------
    def _discover_shards(self) -> List[str]:
        pattern = str(self.store_data_dir / (self.store_name + "-*.npz"))
        return sorted(glob.glob(pattern))

    def enable_read(self, shard_shuffle: bool = False, shuffle_values: bool = False,
                    shuffle_bufsize: int = 10000):
        self.shard_shuffle = shard_shuffle
        self.shuffle_values = shuffle_values
        self._shard_files = self._discover_shards()
        if not self._shard_files:
            raise ValueError(
                f"no shards matching {self.store_name}-*.npz in {self.store_data_dir}"
            )
        self.feature_count = 0
        self.feature_dim = -1
        for f in self._shard_files:
            with np.load(f) as z:
                self.feature_count += int(z["feature_id"].shape[0])
                if self.feature_dim < 0:
                    self.feature_dim = int(z["features"].shape[1])

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        shards = list(self._shard_files)
        if getattr(self, "shard_shuffle", False):
            random.shuffle(shards)
        for f in shards:
            with np.load(f) as z:
                ids = z["feature_id"]
                feats = z["features"]
                order = range(len(ids))
                if getattr(self, "shuffle_values", False):
                    order = list(order)
                    random.shuffle(order)
                for i in order:
                    yield int(ids[i]), feats[i : i + 1]

    def iter_batch(self, batch_size: int = 512):
        ids: List[int] = []
        rows: List[np.ndarray] = []
        for f in self._shard_files:
            with np.load(f) as z:
                sids = z["feature_id"]
                feats = z["features"]
                for i in range(len(sids)):
                    ids.append(int(sids[i]))
                    rows.append(feats[i])
                    if len(ids) == batch_size:
                        yield ids, np.stack(rows)
                        ids, rows = [], []
        if ids:
            yield ids, np.stack(rows)

    def close(self) -> None:
        if self._writing:
            self.save_current_shard()
            self._writing = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""Sharded tar feature store, layout-compatible with webdataset.

Matches the on-disk format of the reference's WebdatasetStore
(ox-vgg/WISE/src/feature/store/webdataset_store.py): shards named
``<store_name>-%06d.tar``, one regular tar member per vector named
``<'%010d' % id>.features.pyd`` whose payload is ``np.save`` bytes of a
(1, dim) float array. Stores written here are readable by webdataset and
vice versa. Implemented on stdlib tarfile — no webdataset dependency.

Copy of ``wise_tpu/store/tar_store.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import glob
import io
import os
import random
import tarfile
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .feature_store import FeatureStore


def _np_save_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _np_load_bytes(b: bytes) -> np.ndarray:
    return np.load(io.BytesIO(b), allow_pickle=True)


class TarShardStore(FeatureStore):
    EXTENSION = "tar"

    def __init__(self, store_name: str, store_data_dir):
        self.store_name = store_name
        self.store_data_dir = Path(store_data_dir)
        self.store_data_filename = str(
            self.store_data_dir / (store_name + "-%06d." + self.EXTENSION)
        )
        self.feature_count = -1
        self.feature_dim = -1
        self._writer: Optional[tarfile.TarFile] = None
        self._shard_index = -1
        self._shard_count = 0
        self._shard_size = 0
        self.shard_maxcount = 0
        self.shard_maxsize = 0
        self._shard_files: List[str] = []

    # -- write -------------------------------------------------------------
    def enable_write(self, shard_maxcount: int, shard_maxsize: int, verbose: int = 0):
        self.shard_maxcount = int(shard_maxcount)
        self.shard_maxsize = int(shard_maxsize)
        self.store_data_dir.mkdir(parents=True, exist_ok=True)
        # append mode: continue after any existing shards (resumable ingest)
        existing = self._discover_shards()
        if existing:
            last = Path(existing[-1]).stem  # e.g. video-000004
            self._shard_index = int(last.rsplit("-", 1)[1])
        self._next_shard()

    def _next_shard(self):
        if self._writer is not None:
            self._writer.close()
        self._shard_index += 1
        self._shard_count = 0
        self._shard_size = 0
        path = self.store_data_filename % self._shard_index
        self._writer = tarfile.open(path, "w")

    def add(self, id: int, features: np.ndarray) -> None:
        if self._writer is None:
            raise ValueError("enable_write() must be called before add()")
        payload = _np_save_bytes(np.asarray(features))
        if self._shard_count > 0 and (
            self._shard_count >= self.shard_maxcount
            or self._shard_size + len(payload) >= self.shard_maxsize
        ):
            self._next_shard()
        info = tarfile.TarInfo(name=("%010d" % int(id)) + ".features.pyd")
        info.size = len(payload)
        self._writer.addfile(info, io.BytesIO(payload))
        self._shard_count += 1
        self._shard_size += len(payload) + 512  # header overhead

    # -- read --------------------------------------------------------------
    def _discover_shards(self) -> List[str]:
        pattern = str(self.store_data_dir / (self.store_name + "-*.tar"))
        return sorted(glob.glob(pattern))

    def enable_read(self, shard_shuffle: bool = False, shuffle_values: bool = False,
                    shuffle_bufsize: int = 10000):
        self.shard_shuffle = shard_shuffle
        self.shuffle_values = shuffle_values
        self.shuffle_bufsize = shuffle_bufsize
        self._shard_files = self._discover_shards()
        if not self._shard_files:
            raise ValueError(
                f"no shards matching {self.store_name}-*.tar in {self.store_data_dir}"
            )
        # dim probe from the first record
        for _, vec in self._iter_shard(self._shard_files[0]):
            self.feature_dim = int(np.atleast_2d(vec).shape[1])
            break
        # exact count by scanning tar headers only (cheap: no payload reads).
        # The reference approximates via a filesize->count cache
        # (webdataset_store.py:79-91) which miscounts when tar padding makes
        # shards with different record counts the same size.
        self.feature_count = 0
        for f in self._shard_files:
            with tarfile.open(f) as tf:
                self.feature_count += sum(1 for m in tf if m.isreg())

    @staticmethod
    def _iter_shard(path: str) -> Iterator[Tuple[int, np.ndarray]]:
        with tarfile.open(path) as tf:
            for member in tf:
                if not member.isreg():
                    continue
                name = os.path.basename(member.name)
                if not name.endswith(".features.pyd"):
                    continue
                key = name[: -len(".features.pyd")]
                data = tf.extractfile(member).read()
                yield int(key), _np_load_bytes(data)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        shards = list(self._shard_files)
        if getattr(self, "shard_shuffle", False):
            random.shuffle(shards)
        if getattr(self, "shuffle_values", False):
            buf = []
            for shard in shards:
                for item in self._iter_shard(shard):
                    buf.append(item)
                    if len(buf) >= self.shuffle_bufsize:
                        idx = random.randrange(len(buf))
                        yield buf.pop(idx)
            random.shuffle(buf)
            yield from buf
        else:
            for shard in shards:
                yield from self._iter_shard(shard)

    def iter_batch(self, batch_size: int = 512):
        ids: List[int] = []
        rows: List[np.ndarray] = []
        for fid, vec in self:
            ids.append(fid)
            rows.append(np.asarray(vec).reshape(-1))
            if len(ids) == batch_size:
                yield ids, np.stack(rows)
                ids, rows = [], []
        if ids:
            yield ids, np.stack(rows)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            if self._shard_count == 0:
                # nothing was added to the last shard (e.g. a resumed run
                # with no new files) — drop the empty tar
                path = Path(self.store_data_filename % self._shard_index)
                if path.exists():
                    path.unlink()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""Vector search index over a feature store, on the port's device ops.

Two index types with an ``.widx`` on-disk format that the JAX package reads
and writes alike: the exact flat index (IndexFlatIP semantics) and IVF-Flat
(k-means coarse quantizer, cell-sorted storage, nprobe search). The host half
(``.widx`` build and load, the streaming build of a store larger than RAM, id
mapping, reconstruction, ``search`` and ``search_batch*``) is numpy; the
device half is PyTorch on one card:

- IndexFlatIP: the vectors live on the card, padded to a multiple of GROUP
  rows. f32, or bf16 with ``storage_dtype="bfloat16"``: queries run
  ``ops.topk.flat_topk`` (on a card: the fused scan + top-k kernels), or
  with ``flat_approx_recall > 0`` the approximate ``flat_topk_approx``.
  ``storage_dtype="int8"``: per-row quantized codes on the card propose
  ``int8_rerank_mult * k`` candidates (``int8_candidates``), which the host
  re-scores in f32 from the memmapped index.
- IndexIVFFlat: the paged layout of ``ops/ivf_paged.py`` on the card (f32, or
  bf16 with ``storage_dtype="bfloat16"``), searched at ``nprobe`` cells.

Heuristics of the reference (feature_search_index.py:53-59): nlist =
3*sqrt(N) if N < 200k else 10*sqrt(N); train on min(N, 100*nlist) samples.
Query prompts per modality are the reference's
(ox-vgg/WISE/src/index/feature_search_index.py:24-28).

IndexIVFPQ is not ported yet and raises ``NotImplementedError``; the paths
that shard an index over several cards are not ported either.

The host half is copied from ``wise_tpu/index/feature_index.py``.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import IndexConfig
from ..ops.topk import (flat_topk, flat_topk_approx, int8_candidates,
                        pad_rows, quantize_rows_int8, rerank_exact_f32)
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
        f"{what} is not ported to PyTorch yet: IVF-PQ (ops/pq.py, the paged "
        f"ADC core, OPQ and the refine and rerank paths) is ROADMAP Queue A "
        f"item 7")


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
        self._device_db = self._int8_db = None
        self._ivf_dev = self._ivf_paged = None

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

    def _ivf_params(self, n: int) -> Tuple[int, int]:
        cfg = self.config
        if n < cfg.ivf_nlist_threshold:
            nlist = int(cfg.ivf_nlist_small_factor * math.sqrt(n))
        else:
            nlist = int(cfg.ivf_nlist_large_factor * math.sqrt(n))
        nlist = max(1, min(nlist, n))
        return nlist, min(n, cfg.ivf_train_per_cell * nlist)

    def create_index(self, index_type: str, overwrite: bool = False) -> bool:
        if index_type == "IndexIVFPQ":
            raise _unported(index_type)
        if index_type not in ("IndexFlatIP", "IndexIVFFlat"):
            raise ValueError(f"unsupported index_type {index_type}")
        out = self.index_path(index_type)
        if out.exists() and not overwrite:
            logger.info(f"index {out} exists, skipping (overwrite=False)")
            return False
        self.index_dir.mkdir(parents=True, exist_ok=True)
        store = self._open_store()
        n, d = store.feature_count, store.feature_dim
        if n * d * 4 > self.config.stream_build_threshold_bytes:
            return self._create_index_streaming(index_type, out, store, n, d)
        ids, vecs = self._load_store_matrix(store)
        meta = {"metric": "inner_product", "dim": d, "count": n}
        if index_type == "IndexFlatIP":
            write_index_file(out, {"ids": ids, "vectors": vecs},
                             {"index_type": "IndexFlatIP", **meta})
        else:
            from ..ops.kmeans import assign_cells, kmeans

            nlist, train_count = self._ivf_params(n)
            rng = np.random.default_rng(0)
            train_idx = rng.permutation(n)[:train_count]
            logger.info(f"IVF training: nlist={nlist} "
                        f"train_count={train_count}")
            centroids, _ = kmeans(vecs[train_idx], nlist, iters=20, seed=0,
                                  device=self.device)
            assign = assign_cells(vecs, centroids, self.device)
            perm = np.argsort(assign, kind="stable")
            counts = np.bincount(assign, minlength=nlist)
            offsets = np.zeros(nlist + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            write_index_file(
                out,
                {"ids": ids[perm], "vectors": vecs[perm],
                 "centroids": centroids, "cell_offsets": offsets},
                {"index_type": "IndexIVFFlat", **meta, "nlist": int(nlist)},
            )
        logger.info(f"wrote {out}")
        return True

    # ------------------------------------------------------------------
    # streaming (> RAM) build: never materialises the (N, D) f32 matrix.
    # Flat is a single sequential pass. IVF-Flat: pass 1 gathers bounded
    # training samples, pass 2 assigns cells batch by batch (device matmul),
    # pass 3 scatter-writes each row to its cell-sorted destination through
    # IndexFileWriter (sequential read, seek-write). RAM stays O(N) ints +
    # O(train) vectors. Readers cannot tell the files from the in-memory
    # path's.
    # ------------------------------------------------------------------
    def _create_index_streaming(self, index_type, out, store, n, d) -> bool:
        logger.info(f"streaming index build: type={index_type} n={n} d={d}")
        meta = {"metric": "inner_product", "dim": d, "count": n}
        if index_type == "IndexFlatIP":
            specs = {"ids": (np.int64, (n,)), "vectors": (np.float32, (n, d))}
            with IndexFileWriter(
                out, specs, {"index_type": "IndexFlatIP", **meta}
            ) as w:
                row = 0
                for batch_ids, batch in store.iter_batch(self.STREAM_BATCH):
                    m = len(batch_ids)
                    w.write_rows("ids", row, np.asarray(batch_ids, np.int64))
                    w.write_rows("vectors", row, batch.reshape(m, d))
                    row += m
                assert row == n
            logger.info(f"wrote {out} (streamed)")
            return True

        from ..ops.kmeans import assign_cells, kmeans

        nlist, train_count = self._ivf_params(n)
        train_count = min(train_count, self.config.ivf_stream_train_max)
        rng = np.random.default_rng(0)
        train_idx = rng.permutation(n)[:train_count]
        logger.info(f"IVF training: nlist={nlist} train_count={train_count}")
        sampled = self._gather_rows(store, [train_idx], d)
        centroids, _ = kmeans(sampled[0], nlist, iters=20, seed=0,
                              device=self.device)

        # pass 2: cell assignment for every row (device matmul per batch)
        assign = np.empty(n, dtype=np.int32)
        ids = np.empty(n, dtype=np.int64)
        row = 0
        for batch_ids, batch in store.iter_batch(self.STREAM_BATCH):
            m = len(batch_ids)
            ids[row : row + m] = batch_ids
            assign[row : row + m] = assign_cells(batch.reshape(m, d),
                                                 centroids, self.device)
            row += m
        assert row == n
        counts = np.bincount(assign, minlength=nlist)
        offsets = np.zeros(nlist + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        order = np.argsort(assign, kind="stable")
        dest = np.empty(n, dtype=np.int64)
        dest[order] = np.arange(n)
        specs = {
            "ids": (np.int64, (n,)),
            "vectors": (np.float32, (n, d)),
            "centroids": (np.float32, centroids.shape),
            "cell_offsets": (np.int64, (nlist + 1,)),
        }
        header = {"index_type": "IndexIVFFlat", **meta, "nlist": int(nlist)}

        # pass 3: scatter rows to their cell-sorted destinations
        with IndexFileWriter(out, specs, header) as w:
            w.write_rows("ids", 0, ids[order])
            w.write_rows("centroids", 0, centroids)
            w.write_rows("cell_offsets", 0, offsets)
            row = 0
            for _, batch in store.iter_batch(self.STREAM_BATCH):
                batch = batch.reshape(-1, d)
                m = batch.shape[0]
                self._scatter_rows(w, "vectors", dest[row : row + m], batch)
                row += m
        logger.info(f"wrote {out} (streamed)")
        return True

    @staticmethod
    def _gather_rows(store, index_lists, d):
        """One sequential pass collecting the given global-row samples, each
        returned in its original (permutation) order."""
        outs = [np.empty((len(s), d), np.float32) for s in index_lists]
        orders = [np.argsort(s) for s in index_lists]
        sorted_rows = [s[o] for s, o in zip(index_lists, orders)]
        row = 0
        for _, batch in store.iter_batch(FeatureSearchIndex.STREAM_BATCH):
            batch = batch.reshape(-1, d)
            m = batch.shape[0]
            for out, srows, order in zip(outs, sorted_rows, orders):
                lo = np.searchsorted(srows, row)
                hi = np.searchsorted(srows, row + m)
                if hi > lo:
                    out[order[lo:hi]] = batch[srows[lo:hi] - row]
            row += m
        return outs

    @staticmethod
    def _scatter_rows(writer, name, dest, data):
        """Write batch rows to non-contiguous destinations, coalescing
        consecutive runs into single writes."""
        order = np.argsort(dest, kind="stable")
        dest_sorted = dest[order]
        data_sorted = data[order]
        cuts = np.nonzero(np.diff(dest_sorted) != 1)[0] + 1
        start = 0
        for stop in list(cuts) + [len(dest_sorted)]:
            writer.write_rows(
                name, int(dest_sorted[start]), data_sorted[start:stop]
            )
            start = stop

    # ------------------------------------------------------------------
    def load_index(self, index_type: str) -> bool:
        if index_type == "IndexIVFPQ":
            raise _unported(index_type)
        path = self.index_path(index_type)
        if not path.exists():
            return False
        self._metadata, self._arrays = read_index_file(path)
        self._index_type = self._metadata["index_type"]
        # drop stale device copies
        self._device_db = self._int8_db = None
        self._ivf_dev = self._ivf_paged = None
        return True

    def _ensure_device_db(self):
        """The vectors on the device once, rows padded to a multiple of
        GROUP (zero rows, masked by n_valid at search); bf16 with
        ``storage_dtype="bfloat16"``."""
        if self._device_db is None:
            if self.config.storage_dtype not in ("float32", "bfloat16"):
                raise ValueError(f"storage_dtype {self.config.storage_dtype!r}"
                                 " not in (float32, bfloat16, int8)")
            host = np.array(self._arrays["vectors"], dtype=np.float32)
            db = pad_rows(torch.from_numpy(host).to(self.device), self.GROUP)
            if self.config.storage_dtype == "bfloat16":
                db = db.to(torch.bfloat16)
            self._device_db = db
        return self._device_db

    def _ensure_int8_db(self):
        """int8 device copy: (codes (N_pad, D) int8, per-row scales
        (N_pad,)). Quantizes row chunks straight off the memmap into a
        preallocated int8 buffer: the transient is one 64k-row f32 chunk,
        not a full padded f32 copy of the database."""
        if self._int8_db is None:
            vecs = self._arrays["vectors"]
            n, d = vecs.shape
            n_pad = max(self.GROUP, -(-n // self.GROUP) * self.GROUP)
            codes = np.zeros((n_pad, d), np.int8)
            scales = np.zeros((n_pad,), np.float32)
            chunk = 65536
            for s in range(0, n, chunk):
                e = min(n, s + chunk)
                codes[s:e], scales[s:e] = quantize_rows_int8(vecs[s:e])
            self._int8_db = (torch.from_numpy(codes).to(self.device),
                             torch.from_numpy(scales).to(self.device))
        return self._int8_db

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
        """Device (scores, rows) of the exact f32 / bf16 flat search,
        unrealised."""
        n_valid = int(self._metadata["count"])
        q = torch.from_numpy(np.ascontiguousarray(qvec, dtype=np.float32))
        return flat_topk(q, self._ensure_device_db(), n_valid=n_valid,
                         k=min(int(topk), n_valid), group=self.GROUP)

    def _search_flat(self, qvec, topk):
        n_valid = int(self._metadata["count"])
        k = min(int(topk), n_valid)
        q = torch.from_numpy(np.ascontiguousarray(qvec, dtype=np.float32))
        if self.config.storage_dtype == "int8":
            # the device proposes rerank_mult * k candidates from the
            # 1-byte/element quantized copy; the host re-scores them in f32
            if self.config.flat_approx_recall > 0.0 and not getattr(
                    self, "_warned_int8_approx", False):
                self._warned_int8_approx = True
                logger.warning("storage_dtype=int8 searches by candidates "
                               "and exact rerank; flat_approx_recall does "
                               "not apply")
            kc = min(self.config.int8_rerank_mult * k, n_valid)
            codes, scales = self._ensure_int8_db()
            _, cand = int8_candidates(q, codes, scales, n_valid=n_valid,
                                      kc=kc, k=k, group=self.GROUP)
            return rerank_exact_f32(qvec, _host(cand),
                                    self._arrays["vectors"], k,
                                    n_valid=n_valid)
        if self.config.flat_approx_recall > 0.0:
            vals, rows = flat_topk_approx(
                q, self._ensure_device_db(), n_valid=n_valid, k=k,
                recall_target=float(self.config.flat_approx_recall))
            return _host(vals), _host(rows)
        vals, rows = self._flat(qvec, topk)
        return _host(vals), _host(rows)

    def _dispatch_search(self, qvec, topk):
        if (
            self.config.storage_dtype == "int8"
            and self._index_type != "IndexFlatIP"
            and not getattr(self, "_warned_int8_ivf", False)
        ):
            self._warned_int8_ivf = True
            logger.warning(
                "storage_dtype=int8 only applies to IndexFlatIP; the %s "
                "paged device copy keeps its own dtype (f32, or bf16 via "
                "storage_dtype=bfloat16)", self._index_type,
            )
        if self._index_type == "IndexFlatIP":
            return self._search_flat(qvec, topk)
        if self._index_type == "IndexIVFFlat":
            return self._search_ivf_device(qvec, topk, self.config.nprobe)
        if self._index_type == "IndexIVFPQ":
            raise _unported(self._index_type)
        raise ValueError(f"unknown index type {self._index_type}")

    # ------------------------------------------------------------------
    def _ensure_ivf_coarse(self):
        """Centroids + cell offsets on the device."""
        if self._ivf_dev is None:
            offsets = np.array(self._arrays["cell_offsets"], dtype=np.int32)
            centroids = np.array(self._arrays["centroids"], np.float32)
            self._ivf_dev = (torch.from_numpy(centroids).to(self.device),
                             torch.from_numpy(offsets).to(self.device))
        return self._ivf_dev

    def _ensure_paged(self):
        """Device-resident paged layout (ops/ivf_paged.py) over the
        cell-sorted rows, built once per load; bf16 with
        ``storage_dtype="bfloat16"``."""
        if self._ivf_paged is None:
            from ..ops.ivf_paged import build_paged_layout

            lay = build_paged_layout(
                np.asarray(self._arrays["vectors"]),
                np.asarray(self._arrays["cell_offsets"]),
                self.config.ivf_page_rows,
            )
            paged = torch.from_numpy(lay["paged"]).to(self.device)
            if self.config.storage_dtype == "bfloat16":
                paged = paged.to(torch.bfloat16)
            self._ivf_paged = {
                "paged": paged,
                "page_rows": torch.from_numpy(lay["page_rows"]).to(
                    self.device),
                "page_first": torch.from_numpy(lay["page_first"]).to(
                    self.device),
                "page_count": torch.from_numpy(lay["page_count"]).to(
                    self.device),
                "page_count_host": lay["page_count"],
            }
        return self._ivf_paged

    def _paged_plan(self, pg, nprobe, nq=1):
        from ..ops.ivf_paged import default_chunk, paged_budget

        budget = paged_budget(pg["page_count_host"], nprobe)
        lpad = pg["paged"].shape[1]
        chunk = default_chunk(lpad, int(self._metadata["dim"]), budget,
                              nq=nq)
        return budget, chunk

    @staticmethod
    def _pad_device_topk(vals, rows, topk):
        """Match the host convention: empty (-inf) slots report row 0, and
        results pad out to the requested k."""
        vals, rows = _host(vals), _host(rows).astype(np.int64)
        rows[np.isneginf(vals)] = 0
        if vals.shape[1] < topk:
            pad = topk - vals.shape[1]
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=-np.inf)
            rows = np.pad(rows, ((0, 0), (0, pad)))
        return vals, rows

    def _search_ivf_device(self, qvec, topk, nprobe):
        from ..ops.ivf_paged import ivf_search_paged

        centroids, _ = self._ensure_ivf_coarse()
        pg = self._ensure_paged()
        nprobe = min(int(nprobe), centroids.shape[0])
        budget, chunk = self._paged_plan(pg, nprobe, nq=qvec.shape[0])
        q = torch.from_numpy(np.ascontiguousarray(qvec, dtype=np.float32))
        vals, rows = ivf_search_paged(
            q, centroids, pg["page_first"], pg["page_count"], pg["paged"],
            pg["page_rows"], nprobe=nprobe, budget=budget, chunk=chunk,
            k=int(topk),
        )
        return self._pad_device_topk(vals, rows, topk)

    # ------------------------------------------------------------------
    def search_batch(
        self, query_vectors: np.ndarray, topk: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) query vectors -> (scores (Q, k), ids (Q, k))."""
        qvec = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        scores, rows = self._dispatch_search(qvec, topk)
        return scores, self._rows_to_ids(scores, rows)

    def search_batch_dispatch(self, query_vectors: np.ndarray, topk: int):
        """Dispatch-only half of ``search_batch`` for the serving coalescer
        (api/coalesce.py two-phase mode): returns an opaque handle whose rows
        ``search_batch_finalize`` realises. On the exact f32 / bf16 flat path
        (the serve default) the handle holds the unrealised device tensors,
        so the caller's critical section costs the enqueue and readbacks
        overlap across requester threads. The other paths (int8 rerank,
        approximate flat, IVF-Flat) compute here; their handle is
        already-realised numpy and finalize is a cheap slice."""
        qvec = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        if (
            self._index_type == "IndexFlatIP"
            and self.config.storage_dtype != "int8"
            and self.config.flat_approx_recall <= 0.0
        ):
            return self._flat(qvec, topk)
        return self._dispatch_search(qvec, topk)

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

"""Vector search index over a feature store, on the port's device ops.

Three index types with an ``.widx`` on-disk format that the JAX package reads
and writes alike: the exact flat index (IndexFlatIP semantics), IVF-Flat
(k-means coarse quantizer, cell-sorted storage, nprobe search) and IVF-PQ
(the same cells over product-quantized residual codes). The host half
(``.widx`` build and load, the streaming build of a store larger than RAM, id
mapping, reconstruction, ``search`` and ``search_batch*``) is numpy; the
device half is PyTorch on one card, or sharded over a mesh of several:

- IndexFlatIP: the vectors live on the card, padded to a multiple of GROUP
  rows. f32, or bf16 with ``storage_dtype="bfloat16"``: queries run
  ``ops.topk.flat_topk`` (on a card: the fused scan + top-k kernels), or
  with ``flat_approx_recall > 0`` the approximate ``flat_topk_approx``.
  ``storage_dtype="int8"``: per-row quantized codes on the card propose
  ``int8_rerank_mult * k`` candidates (``int8_candidates``), which the host
  re-scores in f32 from the memmapped index.
- IndexIVFFlat: the paged layout of ``ops/ivf_paged.py`` on the card (f32, or
  bf16 with ``storage_dtype="bfloat16"``), searched at ``nprobe`` cells.
- IndexIVFPQ: the paged layout over the uint8 codes and the f32 codebooks on
  the card, searched by ADC (``ivfpq_search_paged``) at ``nprobe`` cells, with
  an OPQ rotation of the query where the file has one. With
  ``pq_exact_rerank`` the ADC proposes ``pq_rerank_mult * k`` candidates,
  which the host re-scores from the asset's IndexFlatIP file when it exists,
  else from the file's int8 refine codes.

Heuristics of the reference (feature_search_index.py:53-59): nlist =
3*sqrt(N) if N < 200k else 10*sqrt(N); train on min(N, 100*nlist) samples.
Query prompts per modality are the reference's
(ox-vgg/WISE/src/index/feature_search_index.py:24-28).

When ``$WISE_TORCH_DEVICE`` names a list of devices (``utils/device.py``
``named_devices``), each search is sharded over them, as the reference's is
with more than one JAX device (parallel/sharded_search.py): IndexFlatIP's
rows split over the devices, each scanned by the same kernels, the exact
sharded scan taking precedence over ``flat_approx_recall``; int8 candidates
proposed shard by shard and reranked on the host. IVF-Flat and IVF-PQ
always run through the sharded paged search, each device over its
contiguous range of cells at the worst shard's page budget; one device is a
mesh of one. The reference shards whenever it sees several devices; the
port leaves a machine's other cards alone unless the list names them,
because a collection that fits on one card searches faster there.

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
from ..utils.device import named_devices
from .format import IndexFileWriter, read_index_file, write_index_file
from .search_index import SearchIndex

logger = logging.getLogger(__name__)

QUERY_PROMPTS = {
    "image": "This is a photo of a ",
    "video": "This is a photo of a ",
    "audio": "this is the sound of ",
}


#: ``_flat_sibling`` before the asset's IndexFlatIP file was looked for
_UNREAD = object()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class FeatureSearchIndex(SearchIndex):
    GROUP = 4096  # top-k group size; DB rows pad to a multiple of this
    STREAM_BATCH = 4096

    def __init__(self, media_type: str, asset_id: str, asset: dict,
                 config: Optional[IndexConfig] = None, device=None):
        """``device``: the one device to search on; by default the devices
        that ``$WISE_TORCH_DEVICE`` names (``named_devices``), sharded over
        when they are more than one."""
        self.media_type = media_type
        self.asset_id = asset_id
        self.asset = asset
        self.config = config or IndexConfig()
        self.index_dir = Path(asset["index_dir"])
        from ..parallel.mesh import get_mesh

        self._mesh = get_mesh(devices=[device] if device
                              else named_devices())
        self.device = self._mesh.devices[0]
        self._extractor = None
        self._arrays = None
        self._metadata = None
        self._drop_device_copies()

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
        if index_type not in ("IndexFlatIP", "IndexIVFFlat", "IndexIVFPQ"):
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
            logger.info(f"wrote {out}")
            return True

        from ..ops.kmeans import assign_cells, kmeans

        cfg = self.config
        nlist, train_count = self._ivf_params(n)
        rng = np.random.default_rng(0)
        train_idx = rng.permutation(n)[:train_count]
        logger.info(f"IVF training: nlist={nlist} train_count={train_count}")
        centroids, _ = kmeans(vecs[train_idx], nlist, iters=20, seed=0,
                              device=self.device)
        assign = assign_cells(vecs, centroids, self.device)
        perm = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=nlist)
        offsets = np.zeros(nlist + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        meta["nlist"] = int(nlist)
        if index_type == "IndexIVFFlat":
            write_index_file(
                out,
                {"ids": ids[perm], "vectors": vecs[perm],
                 "centroids": centroids, "cell_offsets": offsets},
                {"index_type": "IndexIVFFlat", **meta},
            )
            logger.info(f"wrote {out}")
            return True

        from ..ops.pq import encode_pq

        residuals = vecs - centroids[assign]
        pq_train = residuals[
            rng.permutation(n)[: min(n, cfg.pq_train_samples)]]
        rot, codebooks = self._train_pq(pq_train)
        arrays = {}
        centroids_out = centroids
        if rot is not None:
            residuals = residuals @ rot
            centroids_out = (centroids @ rot).astype(np.float32)
            arrays["opq_rotation"] = rot
        codes = encode_pq(residuals, codebooks)
        if cfg.pq_refine == "int8":
            # int8 refine codes in the ORIGINAL basis (the rerank scores
            # q . x directly; the OPQ rotation applies to the ADC only)
            rcodes, rscales = quantize_rows_int8(vecs)
            arrays["refine_codes"] = rcodes[perm]
            arrays["refine_scales"] = rscales[perm]
        write_index_file(
            out,
            {"ids": ids[perm], "codes": codes[perm],
             "centroids": centroids_out, "pq_codebooks": codebooks,
             "cell_offsets": offsets, **arrays},
            {"index_type": "IndexIVFPQ", "pq_m": int(cfg.pq_m), **meta},
        )
        logger.info(f"wrote {out}")
        return True

    def _train_pq(self, residuals):
        """PQ (or OPQ, with ``pq_opq``) on coarse-cell residuals -> (rotation
        (D, D) f32 or None, codebooks (M, ksub, D/M) f32)."""
        from ..ops.pq import train_opq, train_pq

        cfg = self.config
        logger.info(f"PQ training: M={cfg.pq_m} ksub={cfg.pq_ksub} "
                    f"on {len(residuals)} residuals (opq={cfg.pq_opq})")
        if cfg.pq_opq:
            return train_opq(residuals, cfg.pq_m, cfg.pq_ksub,
                             opq_iters=cfg.pq_opq_iters, device=self.device)
        return None, train_pq(residuals, cfg.pq_m, cfg.pq_ksub,
                              device=self.device)

    # ------------------------------------------------------------------
    # streaming (> RAM) build: never materialises the (N, D) f32 matrix.
    # Flat is a single sequential pass. IVF-Flat and IVF-PQ: pass 1 gathers
    # bounded training samples, pass 2 assigns cells batch by batch (device
    # matmul), pass 3 scatter-writes each row (or its codes) to its
    # cell-sorted destination through IndexFileWriter (sequential read,
    # seek-write). RAM stays O(N) ints + O(train) vectors. Readers cannot
    # tell the files from the in-memory path's.
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

        cfg = self.config
        pq = index_type == "IndexIVFPQ"
        nlist, train_count = self._ivf_params(n)
        train_count = min(train_count, cfg.ivf_stream_train_max)
        rng = np.random.default_rng(0)
        samples = [rng.permutation(n)[:train_count]]
        if pq:
            samples.append(rng.permutation(n)[: min(n, cfg.pq_train_samples)])
        logger.info(f"IVF training: nlist={nlist} train_count={train_count}")
        sampled = self._gather_rows(store, samples, d)
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
        meta["nlist"] = int(nlist)

        rot = None
        refine = pq and cfg.pq_refine == "int8"
        centroids_out = centroids
        if pq:
            from ..ops.pq import encode_pq

            pq_rows = sampled[1]
            pq_assign = assign_cells(pq_rows, centroids, self.device)
            rot, codebooks = self._train_pq(pq_rows - centroids[pq_assign])
            if rot is not None:
                centroids_out = (centroids @ rot).astype(np.float32)
            specs = {
                "ids": (np.int64, (n,)),
                "codes": (np.uint8, (n, cfg.pq_m)),
                "centroids": (np.float32, centroids.shape),
                "pq_codebooks": (np.float32, codebooks.shape),
                "cell_offsets": (np.int64, (nlist + 1,)),
            }
            if rot is not None:
                specs["opq_rotation"] = (np.float32, rot.shape)
            if refine:
                specs["refine_codes"] = (np.int8, (n, d))
                specs["refine_scales"] = (np.float32, (n,))
            header = {"index_type": "IndexIVFPQ", "pq_m": int(cfg.pq_m),
                      **meta}
        else:
            specs = {
                "ids": (np.int64, (n,)),
                "vectors": (np.float32, (n, d)),
                "centroids": (np.float32, centroids.shape),
                "cell_offsets": (np.int64, (nlist + 1,)),
            }
            header = {"index_type": "IndexIVFFlat", **meta}

        # pass 3: scatter rows (or codes) to their cell-sorted destinations
        with IndexFileWriter(out, specs, header) as w:
            w.write_rows("ids", 0, ids[order])
            w.write_rows("centroids", 0, centroids_out)
            w.write_rows("cell_offsets", 0, offsets)
            if pq:
                w.write_rows("pq_codebooks", 0, codebooks)
            if rot is not None:
                w.write_rows("opq_rotation", 0, rot)
            row = 0
            for _, batch in store.iter_batch(self.STREAM_BATCH):
                batch = batch.reshape(-1, d)
                m = batch.shape[0]
                to = dest[row : row + m]
                if refine:
                    rcodes, rscales = quantize_rows_int8(batch)
                    self._scatter_rows(w, "refine_codes", to, rcodes)
                    self._scatter_rows(w, "refine_scales", to, rscales)
                if pq:
                    resid = batch - centroids[assign[row : row + m]]
                    if rot is not None:
                        resid = resid @ rot
                    self._scatter_rows(w, "codes", to,
                                       encode_pq(resid, codebooks))
                else:
                    self._scatter_rows(w, "vectors", to, batch)
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
        path = self.index_path(index_type)
        if not path.exists():
            return False
        self._metadata, self._arrays = read_index_file(path)
        self._index_type = self._metadata["index_type"]
        self._drop_device_copies()
        return True

    def _drop_device_copies(self):
        """Forget the device copies of the last loaded file."""
        self._device_db = self._int8_db = None
        self._sharded_db = self._int8_shards = None
        self._ivf_dev = self._ivf_paged = self._pq_paged = None
        self._flat_sibling = _UNREAD

    @property
    def _sharded(self) -> bool:
        """Whether the searches shard over several devices."""
        return self._mesh.shape["dp"] > 1

    def _ensure_device_db(self):
        """The vectors on the device once, rows padded to a multiple of
        GROUP (zero rows, masked by n_valid at search); bf16 with
        ``storage_dtype="bfloat16"``."""
        if self._device_db is None:
            self._device_db = pad_rows(
                torch.from_numpy(self._host_vectors()).to(self.device),
                self.GROUP).to(self._flat_dtype())
        return self._device_db

    def _ensure_sharded_db(self):
        """The list of the vectors' row shards on the mesh
        (``pad_and_shard_db``: a multiple of dp x GROUP rows), in the dtype
        of ``_ensure_device_db``."""
        if self._sharded_db is None:
            from ..parallel.sharded_search import pad_and_shard_db

            shards, _ = pad_and_shard_db(self._mesh, self._host_vectors(),
                                         self.GROUP)
            self._sharded_db = [t.to(self._flat_dtype()) for t in shards]
        return self._sharded_db

    def _flat_dtype(self):
        if self.config.storage_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"storage_dtype {self.config.storage_dtype!r}"
                             " not in (float32, bfloat16, int8)")
        return (torch.bfloat16 if self.config.storage_dtype == "bfloat16"
                else torch.float32)

    def _host_vectors(self) -> np.ndarray:
        return np.array(self._arrays["vectors"], dtype=np.float32)

    def _int8_host(self, n_pad: int):
        """(codes (n_pad, D) int8, per-row scales (n_pad,)) on the host,
        zero past the vectors. Quantizes row chunks straight off the memmap
        into a preallocated int8 buffer: the transient is one 64k-row f32
        chunk, not a full padded f32 copy of the database."""
        vecs = self._arrays["vectors"]
        n, d = vecs.shape
        codes = np.zeros((n_pad, d), np.int8)
        scales = np.zeros((n_pad,), np.float32)
        chunk = 65536
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            codes[s:e], scales[s:e] = quantize_rows_int8(vecs[s:e])
        return codes, scales

    def _ensure_int8_db(self):
        """int8 device copy: (codes (N_pad, D) int8, per-row scales
        (N_pad,))."""
        if self._int8_db is None:
            n = self._arrays["vectors"].shape[0]
            n_pad = max(self.GROUP, -(-n // self.GROUP) * self.GROUP)
            codes, scales = self._int8_host(n_pad)
            self._int8_db = (torch.from_numpy(codes).to(self.device),
                             torch.from_numpy(scales).to(self.device))
        return self._int8_db

    def _ensure_int8_shards(self):
        """The int8 copy on the mesh: (codes shards, scales shards), split
        as ``pad_and_shard_db`` splits rows; padded rows quantize to scale
        0, so they score exactly 0 before masking."""
        if self._int8_shards is None:
            from ..parallel.mesh import shard_rows

            n = self._arrays["vectors"].shape[0]
            step = self._mesh.shape["dp"] * self.GROUP
            codes, scales = self._int8_host(max(1, -(-n // step)) * step)
            self._int8_shards = (shard_rows(self._mesh, codes),
                                 shard_rows(self._mesh, scales))
        return self._int8_shards

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
            if self._sharded:
                from ..parallel.sharded_search import sharded_int8_candidates

                _, cand = sharded_int8_candidates(
                    self._mesh, qvec, *self._ensure_int8_shards(), n_valid,
                    kc, group=self.GROUP)
            else:
                codes, scales = self._ensure_int8_db()
                _, cand = int8_candidates(q, codes, scales, n_valid=n_valid,
                                          kc=kc, k=k, group=self.GROUP)
            return rerank_exact_f32(qvec, _host(cand),
                                    self._arrays["vectors"], k,
                                    n_valid=n_valid)
        if self._sharded:
            from ..parallel.sharded_search import sharded_scan_topk

            return sharded_scan_topk(self._mesh, qvec,
                                     self._ensure_sharded_db(), n_valid, k,
                                     group=self.GROUP)
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
            return self._search_ivfpq(qvec, topk, self.config.nprobe)
        raise ValueError(f"unknown index type {self._index_type}")

    # ------------------------------------------------------------------
    def _ensure_ivf_coarse(self):
        """The f32 centroids on every mesh device (one copy a device)."""
        if self._ivf_dev is None:
            from ..parallel.mesh import replicate

            self._ivf_dev = replicate(self._mesh, np.array(
                self._arrays["centroids"], np.float32))
        return self._ivf_dev

    def _ensure_paged(self, attr, array_name, lpad, cast_bf16):
        """The paged layout (ops/ivf_paged.py) of the cell-sorted
        ``array_name`` rows (``vectors`` or the uint8 ``codes``), split by
        contiguous cell ranges over the mesh (``build_sharded_paged``; one
        shard on one device): lists of per-shard tensors, built once per
        load and kept in ``attr``. With ``cast_bf16`` and
        ``storage_dtype="bfloat16"`` the pages are bf16."""
        if getattr(self, attr) is None:
            from ..parallel.sharded_search import build_sharded_paged

            setattr(self, attr, build_sharded_paged(
                self._mesh, self._arrays[array_name],
                self._arrays["cell_offsets"], lpad,
                cast_bf16=cast_bf16
                and self.config.storage_dtype == "bfloat16"))
        return getattr(self, attr)

    def _paged_plan(self, pg, nprobe, nq=1, pq=False):
        """(budget, chunk) of every shard: the worst shard's budget."""
        from ..parallel.sharded_search import sharded_paged_plan

        dim = int(self._metadata["dim"])
        # PQ keeps the reference's sizing, max(D, 256) f32 a lane for its
        # one-hot ADC; the gather ADC holds ~20 M bytes a lane (the widened
        # codes, the gather's int64 indices, its f32 entries), 160 at M = 8
        return sharded_paged_plan(pg, nprobe, max(dim, 256) if pq else dim,
                                  nq=nq)

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
        """Paged IVF-Flat over the mesh's shards, merged on the first
        device."""
        from ..parallel.sharded_search import sharded_ivf_paged_topk

        centroids = self._ensure_ivf_coarse()
        pg = self._ensure_paged("_ivf_paged", "vectors",
                                self.config.ivf_page_rows, cast_bf16=True)
        nprobe = min(int(nprobe), centroids[0].shape[0])
        budget, chunk = self._paged_plan(pg, nprobe, nq=qvec.shape[0])
        vals, rows = sharded_ivf_paged_topk(
            self._mesh, qvec, centroids, pg, nprobe=nprobe, k=int(topk),
            chunk=chunk, budget=budget)
        return self._pad_device_topk(vals, rows, topk)

    # ------------------------------------------------------------------
    def _rotate_q_pq(self, qvec: np.ndarray) -> np.ndarray:
        """OPQ: the .widx stores ROTATED centroids + codebooks trained in
        rotated space; one orthogonal rotation of the query puts probe and
        ADC in that space (inner products invariant)."""
        if "opq_rotation" in self._arrays:
            rot = np.asarray(self._arrays["opq_rotation"], np.float32)
            return (qvec.astype(np.float32) @ rot).astype(np.float32)
        return qvec

    def _search_ivfpq(self, qvec, topk, nprobe):
        """IVF+PQ on one card: the ADC (``_search_ivfpq_device``), then the
        rerank backstop (``pq_exact_rerank``, on by default): the ADC
        proposes ``pq_rerank_mult * k`` candidates, which the host re-scores
        from the best source there is: the asset's IndexFlatIP file (exact
        f32 rows) where it exists, else the file's int8 refine codes
        (``pq_refine``; D bytes a row against the flat file's 4D). PQ's
        error then decides which candidates are considered, not their order
        beyond the rescore's precision (exact for flat, ~1e-3 for int8)."""
        k = int(topk)
        rerank = None
        if self.config.pq_exact_rerank:
            if self._ensure_flat_sibling() is not None:
                rerank = "flat"
            elif "refine_codes" in self._arrays:
                rerank = "refine"
        k_ask = k
        if rerank is not None:
            k_ask = min(self.config.pq_rerank_mult * k,
                        len(self._arrays["ids"]))
        vals, rows = self._search_ivfpq_device(qvec, k_ask, nprobe)
        if rerank == "flat":
            return self._rerank_pq_candidates(qvec, vals, rows, k)
        if rerank == "refine":
            return self._rerank_refine_candidates(qvec, vals, rows, k)
        return vals, rows

    def _ensure_flat_sibling(self):
        """(memmapped vectors, sorted ids, argsort(ids)) of the same asset's
        IndexFlatIP file, or None when it doesn't exist. The reference sorts
        the ids anew at every rerank, a gather of every id; here once a
        load."""
        if self._flat_sibling is _UNREAD:
            path = self.index_path("IndexFlatIP")
            if not path.exists():
                self._flat_sibling = None
            else:
                _, arrays = read_index_file(path)
                fids = np.asarray(arrays["ids"])
                order = np.argsort(fids)
                self._flat_sibling = (arrays["vectors"], fids[order], order)
        return self._flat_sibling

    def _rerank_pq_candidates(self, qvec, vals, rows, k: int):
        """Exact host rescoring of ADC candidates from the flat sibling:
        PQ rows -> vector ids -> flat rows -> f32 dot; ties prefer the
        lower vector id. Returns (scores, rows) in PQ row space."""
        vecs, sorted_ids, order = self._flat_sibling
        pq_ids = np.asarray(self._arrays["ids"])
        q32 = np.asarray(qvec, dtype=np.float32)
        out_v = np.full((q32.shape[0], k), -np.inf, np.float32)
        out_r = np.zeros((q32.shape[0], k), np.int64)
        for qi in range(q32.shape[0]):
            keep = ~np.isneginf(vals[qi])
            prows = np.unique(np.asarray(rows[qi])[keep]).astype(np.int64)
            if not len(prows):
                continue
            ids = pq_ids[prows]
            pos = np.searchsorted(sorted_ids, ids)
            pos = np.minimum(pos, len(sorted_ids) - 1)
            ok = sorted_ids[pos] == ids
            prows, ids, pos = prows[ok], ids[ok], pos[ok]
            frows = order[pos]
            scores = np.asarray(vecs[frows], np.float32) @ q32[qi]
            sel = np.lexsort((ids, -scores))[:k]
            out_v[qi, : len(sel)] = scores[sel]
            out_r[qi, : len(sel)] = prows[sel]
        return out_v, out_r

    def _rerank_refine_candidates(self, qvec, vals, rows, k: int):
        """Host rescoring of ADC candidates from the in-file int8 refine
        codes: score = (codes[row] . q) * scale[row] ~ x[row] . q to int8
        precision. Candidates are PQ rows already, so the gather is a
        direct memmap read (~kc * D bytes). Ties prefer the lower vector
        id, matching the flat-sibling rerank."""
        codes = self._arrays["refine_codes"]  # memmap (N, D) int8
        scales = self._arrays["refine_scales"]
        pq_ids = np.asarray(self._arrays["ids"])
        q32 = np.asarray(qvec, dtype=np.float32)
        out_v = np.full((q32.shape[0], k), -np.inf, np.float32)
        out_r = np.zeros((q32.shape[0], k), np.int64)
        for qi in range(q32.shape[0]):
            keep = ~np.isneginf(vals[qi])
            prows = np.unique(np.asarray(rows[qi])[keep]).astype(np.int64)
            if not len(prows):
                continue
            cand = np.asarray(codes[prows], np.float32)
            scores = (cand @ q32[qi]) * np.asarray(scales[prows], np.float32)
            ids = pq_ids[prows]
            sel = np.lexsort((ids, -scores))[:k]
            out_v[qi, : len(sel)] = scores[sel]
            out_r[qi, : len(sel)] = prows[sel]
        return out_v, out_r

    def _ensure_pq_paged(self):
        """The paged uint8 codes (never bf16) and the f32 codebooks on the
        mesh (one copy of the codebooks a device), built once per load."""
        pg = self._ensure_paged("_pq_paged", "codes",
                                self.config.ivfpq_page_rows, cast_bf16=False)
        if "codebooks" not in pg:
            from ..parallel.mesh import replicate

            pg["codebooks"] = replicate(self._mesh, np.array(
                self._arrays["pq_codebooks"], np.float32))
        return pg

    def _search_ivfpq_device(self, qvec, topk, nprobe):
        """Paged IVF-PQ ADC over the mesh's shards, merged on the first
        device."""
        from ..parallel.sharded_search import sharded_ivfpq_paged_topk

        qvec = self._rotate_q_pq(qvec)
        centroids = self._ensure_ivf_coarse()
        pg = self._ensure_pq_paged()
        nprobe = min(int(nprobe), centroids[0].shape[0])
        budget, chunk = self._paged_plan(pg, nprobe, nq=qvec.shape[0],
                                         pq=True)
        vals, rows = sharded_ivfpq_paged_topk(
            self._mesh, qvec, centroids, pg, pg["codebooks"], nprobe=nprobe,
            k=int(topk), chunk=chunk, budget=budget)
        return self._pad_device_topk(vals, rows, topk)

    def _search_ivfpq_host(self, qvec, topk, nprobe):
        """IVF+PQ asymmetric-distance search in numpy (``ops/pq.py``): score
        = q . cell_centroid + sum_m LUT[m, code_m] over the probed cells.
        The device path is held to it."""
        from ..ops.pq import adc_scores, adc_tables

        qvec = self._rotate_q_pq(qvec)
        centroids = np.asarray(self._arrays["centroids"])
        offsets = np.asarray(self._arrays["cell_offsets"])
        codebooks = np.asarray(self._arrays["pq_codebooks"])
        codes = self._arrays["codes"]  # memmap
        nlist = centroids.shape[0]
        nprobe = min(int(nprobe), nlist)
        cscores = qvec.astype(np.float32) @ centroids.T
        probe_cells = np.argsort(-cscores, axis=1, kind="stable")[:, :nprobe]

        out_scores = np.full((qvec.shape[0], topk), -np.inf, dtype=np.float32)
        out_rows = np.zeros((qvec.shape[0], topk), dtype=np.int64)
        for qi in range(qvec.shape[0]):
            tables = adc_tables(qvec[qi], codebooks)
            cand_scores = []
            cand_rows = []
            for c in np.sort(probe_cells[qi]):
                a, b = int(offsets[c]), int(offsets[c + 1])
                if b <= a:
                    continue
                s = adc_scores(np.asarray(codes[a:b]), tables)
                s += cscores[qi, c]
                cand_scores.append(s)
                cand_rows.append(np.arange(a, b, dtype=np.int64))
            if not cand_scores:
                continue
            s = np.concatenate(cand_scores)
            r = np.concatenate(cand_rows)
            k = min(int(topk), len(s))
            order = np.argsort(-s, kind="stable")[:k]
            out_scores[qi, :k] = s[order]
            out_rows[qi, :k] = r[order]
        return out_scores, out_rows

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
        approximate flat, IVF-Flat, IVF-PQ, sharded) compute here; their
        handle is already-realised numpy and finalize is a cheap slice."""
        qvec = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        if (
            self._index_type == "IndexFlatIP"
            and self.config.storage_dtype != "int8"
            and self.config.flat_approx_recall <= 0.0
            and not self._sharded
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
        """Stored vectors by row (faiss reconstruct_batch parity). Flat and
        IVF-Flat return exact rows; IVF-PQ with an int8 refine stage
        reconstructs from the refine codes (~1e-3 relative error, far
        closer than a PQ decode); codes-only IVF-PQ decodes cell_centroid +
        per-subspace codebook entries (lossy, like faiss), un-rotating
        OPQ-space reconstructions back to the original basis."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        if "vectors" in self._arrays:
            return np.asarray(self._arrays["vectors"][rows], np.float32)
        if "refine_codes" in self._arrays:
            cand = np.asarray(self._arrays["refine_codes"][rows], np.float32)
            scales = np.asarray(self._arrays["refine_scales"][rows],
                                np.float32)
            return cand * scales[:, None]
        from ..ops.pq import decode_pq

        codes = np.asarray(self._arrays["codes"][rows])
        centroids = np.asarray(self._arrays["centroids"])
        offsets = np.asarray(self._arrays["cell_offsets"])
        cells = np.searchsorted(offsets, rows, side="right") - 1
        out = centroids[cells] + decode_pq(
            codes, np.asarray(self._arrays["pq_codebooks"]))
        if "opq_rotation" in self._arrays:
            out = out @ np.asarray(self._arrays["opq_rotation"], np.float32).T
        return out.astype(np.float32)

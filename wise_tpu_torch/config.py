"""Central typed configuration.

The reference hard-codes its pipeline/model/index constants at call sites
(e.g. 2 fps and 8-frame chunks at extract-features.py:292-297, thumbnail
params at src/dataloader/dataset.py:154-155 & 262-267, merge tolerances at
search.py:717-740, the serve-time settings at config.py:6-20 of the
reference). Here every tunable lives in one typed config tree.

Copy of ``wise_tpu/config.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple


@dataclasses.dataclass
class VideoIngestConfig:
    """Video stream sampling (reference: extract-features.py:292-297)."""

    frame_rate: float = 2.0          # frames per second sampled
    frames_per_chunk: int = 8        # 8 frames @ 2 fps = 4 s segments
    segment_length: float = 4.0      # seconds per chunk


@dataclasses.dataclass
class AudioIngestConfig:
    """Audio stream sampling (reference: extract-features.py:292-312)."""

    sampling_rate: int = 48_000
    segment_length: float = 4.0      # seconds per segment
    # Segments shorter than this fraction of segment_length are discarded
    # (reference discards audio chunks < full length: extract-features.py:336-337).
    min_segment_fraction: float = 1.0


@dataclasses.dataclass
class ThumbnailConfig:
    """Thumbnail stream (reference: src/dataloader/dataset.py:154-155, 262-267)."""

    height: int = 192
    frame_rate: float = 2.0
    jpeg_quality: int = 80


@dataclasses.dataclass
class StoreConfig:
    """Feature store sharding (reference: extract-features.py store setup)."""

    shard_maxcount: int = 2048
    shard_maxsize: int = 20 * 1024 * 1024  # 20 MiB
    store_type: str = "webdataset"         # "webdataset" (tar) | "numpy" (npz)


@dataclasses.dataclass
class IndexConfig:
    """ANN index parameters (reference: src/index/feature_search_index.py:53-59,
    config.py:17, api/routes.py:899-911)."""

    index_type: str = "IndexFlatIP"
    # IVF: nlist = small_factor*sqrt(N) if N < large_threshold else large_factor*sqrt(N)
    ivf_nlist_small_factor: int = 3
    ivf_nlist_large_factor: int = 10
    ivf_nlist_threshold: int = 200_000
    ivf_train_per_cell: int = 100          # train on min(N, 100*nlist) samples
    nprobe: int = 1024
    # NOTE: the reference's `index_use_direct_map` knob (its config.py:18,
    # honoured at api/routes.py:905-911 to enable faiss reconstruct on IVF
    # indices) has NO equivalent here by design: every .widx layout keeps
    # row ids addressable, so `reconstruct` always works and a toggle
    # would be dead. (Round-4 review: dropped rather than left unread.)
    # PQ (IndexIVFPQ): M subquantizers x 256-entry codebooks over residuals
    pq_m: int = 8
    pq_ksub: int = 256
    pq_train_samples: int = 100_000
    # OPQ: learn an orthogonal rotation (ops/pq.py train_opq) minimising PQ
    # reconstruction error before codebook training. The .widx stores the
    # ROTATED centroids plus the rotation; queries rotate once at dispatch
    # (inner products are invariant), so every search kernel is unchanged.
    # Lifts standalone ADC ranking toward the reference's real-data class
    # without requiring the flat-sibling exact rerank.
    pq_opq: bool = True
    pq_opq_iters: int = 8
    # APPROXIMATE flat scan (ops/topk.flat_topk_approx): 0.0 = exact
    # (default); a recall target in (0, 1] switches single-chip flat
    # searches to the TPU PartialReduce top-k — measured 7.4x faster at
    # the 512-query x 1M x 768, k=1000 batch-eval geometry at
    # recall@1000 0.983 (BENCHMARKS.md "large-k variants"). The honest
    # analogue of serving from the reference's IndexIVFFlat batch mode.
    flat_approx_recall: float = 0.0
    # device-side scan parameters
    scan_block_rows: int = 4096            # DB rows per Pallas scan block
    # HBM copy of the flat database: "float32" (bit-parity with faiss),
    # "bfloat16" (2x less scan bandwidth), or "int8" (4x less: per-row
    # symmetric quantized scan proposes rerank_mult*k candidates on device,
    # then the true f32 rows from the memmapped index are re-scored on the
    # host). int8 returned scores are exact f32; ranking equals the f32
    # scan whenever the true top-k survives the candidate stage — always on
    # well-separated data; on data with many rows within the int8 noise
    # (~1e-3) of the k-th score, deep ranks can swap with just-missed rows
    # (raise int8_rerank_mult for margin). Strictly more accurate than
    # bfloat16 storage, and 2x less HBM traffic.
    storage_dtype: str = "float32"         # "float32" | "bfloat16" | "int8"
    int8_rerank_mult: int = 4              # candidates = mult * k
    # IVF-PQ recall backstop: when the same asset also has an IndexFlatIP
    # file, ADC proposes pq_rerank_mult*k candidates and the true f32 rows
    # from the flat file are re-scored on the host — PQ error then only
    # affects candidate selection, never returned scores or their order
    pq_exact_rerank: bool = True
    pq_rerank_mult: int = 4
    # int8 refine stage stored INSIDE the IVF-PQ file (faiss
    # IndexRefine/ScalarQuantizer class): per-row symmetric int8 codes
    # (D bytes/row + 4-byte scale — 25% of an f32 flat sibling, vs M bytes
    # for the PQ codes alone) kept host-side (memmap; never in HBM). At
    # search time, when no flat sibling exists, the ADC's pq_rerank_mult*k
    # candidates are re-scored from these codes on the host, so PQ
    # quantization error only affects WHICH candidates are considered;
    # returned scores carry int8 precision (~1e-3 relative) instead of
    # ADC's subspace-codebook error. A flat sibling still takes priority
    # (exact f32 rescore). "none" restores the codes-only round-2 format.
    pq_refine: str = "int8"               # "int8" | "none"
    # paged IVF layout (ops/ivf_paged.py): rows per page. Pages are the
    # gather granularity — big enough to DMA at HBM bandwidth; cells pad to
    # a page multiple, so smaller pages waste less on skewed cell sizes.
    ivf_page_rows: int = 64
    ivfpq_page_rows: int = 128
    # streaming (> RAM) index build: used when the (N, D) f32 matrix would
    # exceed this many bytes; 0 forces streaming (tests)
    stream_build_threshold_bytes: int = 2 << 30
    # cap on k-means training rows held in RAM during a streaming build
    ivf_stream_train_max: int = 1_000_000


@dataclasses.dataclass
class SearchConfig:
    """Query-time behaviour (reference: search.py:717-740, api/routes.py:523-602,
    759-850; config.py:6-20)."""

    top_k: int = 10
    precision: int = 3
    query_prefix: str = "This is a photo of a"
    audio_query_prefix: str = "this is the sound of"
    text_queries_weight: float = 2.0
    negative_queries_weight: float = 0.2
    # merge0 tolerances per media type (seconds), and rank tolerance
    merge_video_time_tolerance: float = 4.0
    merge_audio_time_tolerance: float = 8.0
    merge_rank_tolerance: int = 20
    shot_merge_gap: float = 4.0            # segments closer than this merge into shots
    query_blocklist: Tuple[str, ...] = ()


@dataclasses.dataclass
class ServeConfig:
    """REST server settings (reference: config.py:6-20)."""

    mode: str = "production"
    hostname: str = "0.0.0.0"
    port: int = 9670
    top_k: int = 10
    num_inline_thumbnails: int = 10        # first K thumbnails inlined as base64
    featured_max: int = 10_000
    featured_seed: int = 42
    # Cross-request micro-batching of text-tower embeds and index searches
    # (api/coalesce.py): concurrent requests queued while the device is
    # busy run as ONE dispatch, amortising one HBM database sweep over the
    # whole batch. OFF by default on measurement: the serve-load A/B
    # (scripts/bench_serve_load.py, BENCHMARKS.md "Coalescing under load")
    # showed 0.82x qps on the dev host, whose single CPU core — not the
    # device (~15% duty) — is the bottleneck, so added coordination can't
    # pay. Opt in (WISE_SERVE_COALESCE=1 or wise.json serve.coalesce) on
    # device-bound deployments: many-core host, local PCIe chip, large
    # corpora/towers where the per-request device time dominates.
    coalesce: bool = False
    coalesce_max_batch: int = 16


@dataclasses.dataclass
class MeshConfig:
    """Device mesh for sharded inference / index scan."""

    # axis names: "dp" (data/batch), "mp" (model/tensor). Index shards ride "dp".
    dp: int = -1                            # -1 = all available devices
    mp: int = 1


@dataclasses.dataclass
class WiseConfig:
    video: VideoIngestConfig = dataclasses.field(default_factory=VideoIngestConfig)
    audio: AudioIngestConfig = dataclasses.field(default_factory=AudioIngestConfig)
    thumbnail: ThumbnailConfig = dataclasses.field(default_factory=ThumbnailConfig)
    store: StoreConfig = dataclasses.field(default_factory=StoreConfig)
    index: IndexConfig = dataclasses.field(default_factory=IndexConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # DB commit batching (reference commits every 8192 chunks,
    # extract-features.py:400-402)
    db_commit_interval: int = 8192

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "WiseConfig":
        raw = json.loads(text)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in raw:
                continue
            v = raw[f.name]
            if dataclasses.is_dataclass(f.type) or f.name in (
                "video", "audio", "thumbnail", "store", "index",
                "search", "serve", "mesh",
            ):
                sub_cls = cls.__dataclass_fields__[f.name].default_factory  # type: ignore[union-attr]
                sub = sub_cls()
                for k, val in v.items():
                    if hasattr(sub, k):
                        if k == "query_blocklist":
                            val = tuple(val)
                        setattr(sub, k, val)
                kwargs[f.name] = sub
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    def apply_env_overrides(self) -> "WiseConfig":
        """Serve-time env overrides, matching the reference's
        pydantic-settings APIConfig behaviour (config.py:6-20 reads MODE,
        HOSTNAME, PORT, TOP_K, QUERY_PREFIX, ... from the environment)."""
        import os

        env = os.environ
        s, v = self.serve, self.search
        s.mode = env.get("MODE", s.mode)
        s.hostname = env.get("HOSTNAME_BIND", env.get("WISE_HOSTNAME", s.hostname))
        if env.get("PORT"):
            s.port = int(env["PORT"])
        if env.get("TOP_K"):
            s.top_k = int(env["TOP_K"])
        v.query_prefix = env.get("QUERY_PREFIX", v.query_prefix)
        if env.get("TEXT_QUERIES_WEIGHT"):
            v.text_queries_weight = float(env["TEXT_QUERIES_WEIGHT"])
        if env.get("NEGATIVE_QUERIES_WEIGHT"):
            v.negative_queries_weight = float(env["NEGATIVE_QUERIES_WEIGHT"])
        if env.get("NPROBE"):
            self.index.nprobe = int(env["NPROBE"])
        if env.get("FLAT_APPROX_RECALL"):
            self.index.flat_approx_recall = float(env["FLAT_APPROX_RECALL"])
        if env.get("INDEX_TYPE"):
            self.index.index_type = env["INDEX_TYPE"]
        if env.get("WISE_SERVE_COALESCE"):
            s.coalesce = env["WISE_SERVE_COALESCE"] not in ("0", "false", "")
        return self

    def save(self, path: Path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: Path) -> "WiseConfig":
        p = Path(path)
        if p.exists():
            return cls.from_json(p.read_text())
        return cls()

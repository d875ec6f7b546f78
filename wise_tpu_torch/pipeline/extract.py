"""Offline ingestion engine: decode -> embed -> store + record.

Equivalent to the reference's extract-features.py end-to-end pipeline
(ox-vgg/WISE/extract-features.py:75-415) rebuilt for TPU throughput:

- decode runs on host threads (the native FFmpeg ext releases the GIL), with
  an order-preserving prefetcher so vector ids stay deterministic;
- frames/segments accumulate into large device batches (not the reference's
  8-frame per-chunk forwards) so the encoder runs MXU-sized matmuls;
- DB writes are batched (executemany) and committed every
  ``db_commit_interval`` chunks (reference commits every 8192).

Semantics preserved: video vectors one per sampled frame (modality VIDEO,
timestamp = frame pts); audio vectors one per full segment (modality AUDIO,
[t, t+segment]); short trailing audio segments are discarded
(extract-features.py:336-337); thumbnails at 192 px / 2 fps / JPEG q80.

Copy of ``wise_tpu/pipeline/extract.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import WiseConfig
from ..data_models import (
    MediaType,
    ModalityType,
    SourceCollection,
    SourceCollectionType,
    ThumbnailMetadata,
    VectorMetadata,
)
from .. import db as wdb
from ..db.repository import (
    MediaRepo,
    SourceCollectionRepo,
    ThumbnailRepo,
    VectorRepo,
)
from ..io.dataset import get_dataset, get_metadata_for_valid_files
from ..models.factory import FeatureExtractorFactory
from ..project import WiseProject
from ..store.factory import FeatureStoreFactory
from ..utils import get_files_from_directory_with_extensions

logger = logging.getLogger(__name__)

# multi-host ingest: worker i allocates media/vector ids in
# [i * STRIDE, (i+1) * STRIDE) so merged projects never collide
INGEST_ID_STRIDE = 1 << 40

IMAGE_EXTENSIONS = ["jpg", "jpeg", "png", "bmp", "webp", "gif"]
VIDEO_EXTENSIONS = ["mp4", "m4v", "mov", "mkv", "webm", "avi"]
AUDIO_EXTENSIONS = ["wav", "mp3", "flac", "ogg", "m4a", "aac"]


@dataclasses.dataclass
class ExtractionStats:
    num_files: int = 0
    num_unknown_files: int = 0
    num_video_vectors: int = 0
    num_audio_vectors: int = 0
    num_image_vectors: int = 0
    num_thumbnails: int = 0
    elapsed_sec: float = 0.0
    frames_embedded: int = 0
    audio_segments_embedded: int = 0
    stage_timings: dict = dataclasses.field(default_factory=dict)

    @property
    def frames_per_sec(self) -> float:
        return self.frames_embedded / self.elapsed_sec if self.elapsed_sec else 0.0


def _scan_media_dirs(media_dir_list, include_patterns) -> List[Path]:
    """include_patterns are shell-style globs matched against the file
    name ('*.mp4'). The reference's --media-include help says "regular
    expression" but its own conformance script passes globs
    (tests/test-kinetics-6.sh: --media-include "*.mp4"), so glob
    semantics are the de-facto contract — the round-5 validation-kit
    dress rehearsal caught the previous regex interpretation crashing on
    exactly that flag value."""
    files: List[Path] = []
    exts = IMAGE_EXTENSIONS + VIDEO_EXTENSIONS + AUDIO_EXTENSIONS
    for d in media_dir_list:
        files.extend(get_files_from_directory_with_extensions(d, exts))
    if include_patterns:
        import fnmatch

        files = [f for f in files
                 if any(fnmatch.fnmatch(f.name, p)
                        for p in include_patterns)]
    return files


class _BatchedEmbedder:
    """Accumulates frames across chunks into large encoder batches while
    keeping (media_id, pts) bookkeeping aligned; flush order == arrival
    order, so vector ids are deterministic."""

    def __init__(self, extractor, store, conn, modality: ModalityType,
                 batch_size: int, stats: ExtractionStats, stat_field: str):
        self.extractor = extractor
        self.store = store
        self.conn = conn
        self.modality = modality
        self.batch_size = batch_size
        self.stats = stats
        self.stat_field = stat_field
        self._items: List[Tuple[int, float, Optional[float], np.ndarray]] = []
        self.vector_repo = VectorRepo()
        self._warmup_thread = None

    id_base = 0  # floor of this worker's vector-id range (set like .timer)

    def start_warmup(self, sample_shape):
        """Pre-compile the encoder's main batch bucket on a background thread
        so the (potentially minutes-long) XLA compile overlaps with decode."""
        import threading

        def _warm():
            try:
                dummy = np.zeros((self.batch_size,) + tuple(sample_shape),
                                 dtype=np.uint8
                                 if self.modality != ModalityType.AUDIO
                                 else np.float32)
                if self.modality == ModalityType.AUDIO:
                    self.extractor.extract_audio_features(
                        self.extractor.preprocess_audio(dummy)
                    )
                else:
                    self.extractor.extract_image_features(
                        self.extractor.preprocess_image(dummy)
                    )
            except Exception:
                logger.debug("encoder warmup failed (non-fatal)", exc_info=True)

        self._warmup_thread = threading.Thread(target=_warm, daemon=True)
        self._warmup_thread.start()

    def add_frames(self, media_id: int, frames: np.ndarray, pts: np.ndarray):
        for i in range(len(frames)):
            self._items.append((media_id, float(pts[i]), None, frames[i]))
        while len(self._items) >= self.batch_size:
            self._flush(self.batch_size)

    def add_segment(self, media_id: int, samples: np.ndarray, pts0: float,
                    pts1: float):
        self._items.append((media_id, pts0, pts1, samples))
        while len(self._items) >= self.batch_size:
            self._flush(self.batch_size)

    timer = None  # shared StageTimer, set by extract_features

    def _flush(self, count: Optional[int] = None):
        if not self._items:
            return
        take = self._items if count is None else self._items[:count]
        self._items = [] if count is None else self._items[count:]

        import contextlib

        encode_cm = (
            self.timer.stage("encode") if self.timer else contextlib.nullcontext()
        )
        with encode_cm:
            if self.modality == ModalityType.AUDIO:
                batch = np.stack([x[3] for x in take])
                feats = self.extractor.extract_audio_features(
                    self.extractor.preprocess_audio(batch)
                )
            else:
                batch = np.stack([x[3] for x in take])
                feats = self.extractor.extract_image_features(
                    self.extractor.preprocess_image(batch)
                )
        vectors = [
            VectorMetadata(
                modality=self.modality,
                media_id=mid,
                timestamp=t0,
                end_timestamp=t1,
            )
            for (mid, t0, t1, _) in take
        ]
        created = self.vector_repo.create_batch(
            self.conn, vectors, id_base=self.id_base
        )
        for v, feat in zip(created, feats):
            self.store.add(v.id, feat[None, :].astype(np.float32))
        setattr(
            self.stats, self.stat_field,
            getattr(self.stats, self.stat_field) + len(created),
        )
        if self.modality == ModalityType.AUDIO:
            self.stats.audio_segments_embedded += len(created)
        else:
            self.stats.frames_embedded += len(created)

    def finish(self):
        self._flush(None)


def _timed_iter(iterator, timer, name: str):
    """Accounts iterator-blocking time (decode wait) to a timer stage."""
    it = iter(iterator)
    while True:
        with timer.stage(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def _ordered_prefetch(dataset_factory, files, num_workers):
    """Decode files on worker threads but yield their chunk streams in file
    order (deterministic ids). Each worker fully materialises one file's
    chunks; the native decoder releases the GIL so threads overlap."""
    if num_workers <= 0:
        ds = dataset_factory(files)
        yield from ds
        return

    def decode_one(f):
        return list(dataset_factory([f]))

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = [pool.submit(decode_one, f) for f in files]
        for fut in futures:
            yield from fut.result()


def extract_features(
    media_dir_list: Sequence,
    project_dir,
    image_feature_id: str = "wise/random_features/512/default",
    video_feature_id: str = "wise/random_features/512/default",
    audio_feature_id: str = "wise/random_features/512/default",
    feature_store_type: str = "webdataset",
    shard_maxcount: int = 2048,
    shard_maxsize: int = 20 * 1024 * 1024,
    num_workers: int = 0,
    thumbnails: bool = True,
    media_include_list: Sequence[str] = (),
    batch_size: int = 256,
    config: Optional[WiseConfig] = None,
    ingest_worker: int = 0,
    ingest_workers: int = 1,
) -> ExtractionStats:
    """With ingest_workers > 1, this process ingests only files whose rank in
    the (deterministic, sorted) scan is ``rank % ingest_workers ==
    ingest_worker``, and allocates media/vector ids from a disjoint 2^40
    range per worker — so N hosts can ingest N-way in parallel into separate
    project dirs and ``merge-projects.py`` concatenates them without id
    remapping. (The reference is strictly single-process,
    extract-features.py; this is TPU-pod-scale ingest.)"""
    t0 = time.time()
    if not (0 <= ingest_worker < ingest_workers):
        raise ValueError(
            f"ingest_worker {ingest_worker} not in [0, {ingest_workers})"
        )
    cfg = config or WiseConfig()
    cfg.store.shard_maxcount = shard_maxcount
    cfg.store.shard_maxsize = shard_maxsize

    project = WiseProject(project_dir, create_project=True)
    project.save_config(cfg)
    conn = wdb.init_project(project.db_path)
    thumbs_conn = wdb.init_thumbs(project.thumbs_db_path)

    stats = ExtractionStats()
    from ..utils.profiling import StageTimer

    timer = StageTimer()
    _BatchedEmbedder.timer = timer
    _BatchedEmbedder.id_base = ingest_worker * INGEST_ID_STRIDE
    media_repo = MediaRepo()
    sc_repo = SourceCollectionRepo()
    thumb_repo = ThumbnailRepo()

    # -- 1. discover + register media files --------------------------------
    # Resumable by design (the reference cannot resume or extend a project,
    # extract-features.py:253-257): files already registered with the same
    # checksum AND already embedded are skipped; everything else is
    # (re)processed, with feature stores appending new shards.
    all_media: List[Tuple[Path, "MediaMetadata"]] = []
    skipped_existing = 0
    id_base = ingest_worker * INGEST_ID_STRIDE
    next_media_id = None
    if ingest_workers > 1:
        row = conn.execute("SELECT COALESCE(MAX(id), 0) FROM media").fetchone()
        next_media_id = max(row[0], id_base) + 1
    for media_dir in media_dir_list:
        files = _scan_media_dirs([media_dir], media_include_list)
        if ingest_workers > 1:  # deterministic stride over the sorted scan
            files = files[ingest_worker::ingest_workers]
        valid, unknown = get_metadata_for_valid_files(files)
        stats.num_unknown_files += len(unknown)
        sc = sc_repo.get_row_by_column_match(conn, "location", str(media_dir))
        if sc is None:
            sc = sc_repo.create(
                conn,
                SourceCollection(
                    location=str(media_dir), type=SourceCollectionType.DIR
                ),
            )
        for path, meta in valid:
            meta.source_collection_id = sc.id
            meta.path = str(Path(path).relative_to(media_dir))
            existing = conn.execute(
                "SELECT id, checksum FROM media WHERE path = ? AND "
                "source_collection_id = ?",
                (meta.path, sc.id),
            ).fetchone()
            if existing is not None and existing["checksum"] == meta.checksum:
                n_vec = conn.execute(
                    "SELECT COUNT(*) FROM vectors WHERE media_id = ?",
                    (existing["id"],),
                ).fetchone()[0]
                if n_vec > 0:
                    skipped_existing += 1
                    continue  # fully ingested previously
                meta.id = existing["id"]
                all_media.append((path, media_repo.update(conn, meta.id, meta)))
                continue
            if next_media_id is not None:
                meta.id = next_media_id
                next_media_id += 1
            created = media_repo.create(conn, meta)
            all_media.append((path, created))
    conn.commit()
    stats.num_files = len(all_media) + skipped_existing
    logger.info(
        f"registered {stats.num_files} media files "
        f"({stats.num_unknown_files} unknown skipped, "
        f"{skipped_existing} already ingested)"
    )

    # -- 2. group by modality ----------------------------------------------
    by_type: Dict[MediaType, List[Tuple[Path, object]]] = {}
    for path, meta in all_media:
        by_type.setdefault(MediaType(meta.media_type), []).append((path, meta))

    # -- 3. extractors + stores --------------------------------------------
    def make_store(feature_id, media_type_name):
        d = project.create_features_dir(feature_id)
        store = FeatureStoreFactory.create_store(
            feature_store_type, media_type_name, d
        )
        store.enable_write(cfg.store.shard_maxcount, cfg.store.shard_maxsize)
        return store

    extractors: Dict[str, object] = {}

    def get_extractor(feature_id, modality: str):
        if feature_id not in extractors:
            logger.info(f"loading feature extractor {feature_id}")
            extractors[feature_id] = FeatureExtractorFactory(feature_id)
        fe = extractors[feature_id]
        if modality == "audio" and not getattr(fe, "supports_audio", True):
            raise ValueError(
                f"{feature_id} cannot embed audio; pass an audio-capable "
                "--audio-feature-id (e.g. microsoft/clap/2023/four-datasets)"
            )
        if modality in ("image", "video") and not getattr(
            fe, "supports_image", True
        ):
            raise ValueError(
                f"{feature_id} cannot embed images/frames; pass an "
                "image-capable --image/--video-feature-id"
            )
        return fe

    chunk_counter = 0

    def maybe_commit():
        nonlocal chunk_counter
        chunk_counter += 1
        if chunk_counter % cfg.db_commit_interval == 0:
            conn.commit()
            thumbs_conn.commit()

    segment_samples = int(cfg.audio.sampling_rate * cfg.audio.segment_length)
    min_samples = int(segment_samples * cfg.audio.min_segment_fraction)

    # -- 4. images ----------------------------------------------------------
    if MediaType.IMAGE in by_type:
        entries = by_type[MediaType.IMAGE]
        extractor = get_extractor(image_feature_id, "image")
        store = make_store(image_feature_id, "image")
        embedder = _BatchedEmbedder(
            extractor, store, conn, ModalityType.IMAGE, batch_size, stats,
            "num_image_vectors",
        )
        id_by_path = {str(p): m.id for p, m in entries}

        def factory(files):
            return get_dataset(
                MediaType.IMAGE, files,
                thumbnails=cfg.thumbnail if thumbnails else None,
            )

        for path, chunk in _timed_iter(
            _ordered_prefetch(factory, [p for p, _ in entries], num_workers),
            timer, "decode",
        ):
            mid = id_by_path[str(path)]
            img = chunk["image"]
            embedder.add_frames(mid, img.tensor, np.atleast_1d(img.pts))
            for tpts, jpeg in chunk.get("thumbnails", []):
                thumb_repo.create(
                    thumbs_conn,
                    ThumbnailMetadata(media_id=mid, timestamp=tpts, content=jpeg),
                )
                stats.num_thumbnails += 1
            maybe_commit()
        embedder.finish()
        store.close()

    # -- 5. video / AV -------------------------------------------------------
    av_entries = by_type.get(MediaType.VIDEO, []) + by_type.get(MediaType.AV, [])
    if av_entries:
        v_extractor = get_extractor(video_feature_id, "video")
        v_store = make_store(video_feature_id, "video")
        v_embedder = _BatchedEmbedder(
            v_extractor, v_store, conn, ModalityType.VIDEO, batch_size, stats,
            "num_video_vectors",
        )
        if getattr(v_extractor, "input_size", None):
            v_embedder.start_warmup(tuple(v_extractor.input_size) + (3,))
        has_audio = [
            (p, m) for p, m in av_entries if MediaType(m.media_type) == MediaType.AV
        ]
        a_embedder = None
        a_store = None
        if has_audio:
            a_extractor = get_extractor(audio_feature_id, "audio")
            a_store = make_store(audio_feature_id, "audio")
            a_embedder = _BatchedEmbedder(
                a_extractor, a_store, conn, ModalityType.AUDIO,
                max(1, batch_size // 8), stats, "num_audio_vectors",
            )
        id_by_path = {str(p): m.id for p, m in av_entries}
        type_by_path = {str(p): MediaType(m.media_type) for p, m in av_entries}

        def factory(files):
            # per-file dataset choice: AV for files with audio, VIDEO otherwise
            mt = type_by_path[str(files[0])] if len(files) == 1 else MediaType.AV
            return get_dataset(
                mt, files,
                video=cfg.video,
                **({"audio": cfg.audio} if mt == MediaType.AV else {}),
                thumbnails=cfg.thumbnail if thumbnails else None,
            )

        def per_file_factory(files):
            for f in files:
                yield from factory([f])

        iterator = (
            _ordered_prefetch(factory, [p for p, _ in av_entries], num_workers)
            if num_workers > 0
            else per_file_factory([p for p, _ in av_entries])
        )
        for path, chunk in _timed_iter(iterator, timer, "decode"):
            mid = id_by_path[str(path)]
            if "video" in chunk:
                v = chunk["video"]
                v_embedder.add_frames(mid, v.tensor, v.pts)
            if "audio" in chunk and a_embedder is not None:
                a = chunk["audio"]
                if a.tensor.shape[0] >= min_samples:
                    pts0 = float(a.pts)
                    a_embedder.add_segment(
                        mid,
                        _pad_to(a.tensor, segment_samples),
                        pts0,
                        pts0 + cfg.audio.segment_length,
                    )
            for tpts, jpeg in chunk.get("thumbnails", []):
                thumb_repo.create(
                    thumbs_conn,
                    ThumbnailMetadata(media_id=mid, timestamp=tpts, content=jpeg),
                )
                stats.num_thumbnails += 1
            maybe_commit()
        v_embedder.finish()
        v_store.close()
        if a_embedder is not None:
            a_embedder.finish()
            a_store.close()

    # -- 6. audio-only files -------------------------------------------------
    if MediaType.AUDIO in by_type:
        entries = by_type[MediaType.AUDIO]
        extractor = get_extractor(audio_feature_id, "audio")
        store = make_store(audio_feature_id, "audio")
        embedder = _BatchedEmbedder(
            extractor, store, conn, ModalityType.AUDIO,
            max(1, batch_size // 8), stats, "num_audio_vectors",
        )
        id_by_path = {str(p): m.id for p, m in entries}

        def factory(files):
            return get_dataset(MediaType.AUDIO, files, audio=cfg.audio)

        for path, chunk in _timed_iter(
            _ordered_prefetch(factory, [p for p, _ in entries], num_workers),
            timer, "decode",
        ):
            mid = id_by_path[str(path)]
            a = chunk["audio"]
            if a.tensor.shape[0] >= min_samples:
                pts0 = float(a.pts)
                embedder.add_segment(
                    mid,
                    _pad_to(a.tensor, segment_samples),
                    pts0,
                    pts0 + cfg.audio.segment_length,
                )
            maybe_commit()
        embedder.finish()
        store.close()

    conn.commit()
    thumbs_conn.commit()
    conn.close()
    thumbs_conn.close()
    stats.elapsed_sec = time.time() - t0
    timer.add("total", stats.elapsed_sec)
    stats.stage_timings = timer.report()
    logger.info(f"stage timings: {timer.summary()}")
    logger.info(
        f"extraction done in {stats.elapsed_sec:.1f}s: "
        f"{stats.num_video_vectors} video / {stats.num_audio_vectors} audio / "
        f"{stats.num_image_vectors} image vectors, "
        f"{stats.num_thumbnails} thumbnails"
    )
    return stats


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] >= n:
        return x[:n]
    return np.pad(x, (0, n - x.shape[0]))

"""Frame ingest: decoded frames through the batched embedder, the feature
store and the DB.

The traffic is a closed stream of clips (one media row each) of frames at
the model's size, as a decoder hands them to the extract pipeline, through
``pipeline/extract.py``'s ``_BatchedEmbedder`` in the pipeline's batches,
as ``chip_smoke.py``'s ``_ingest`` drives it. Decode is outside: frames come
from a pool made from the seed in set-up and reused under new media ids and
timestamps, so making them never paces the window.

What the window produced is judged after it closes: every DB row's (media
id, timestamp) and every stored vector are accounted for, and a sample of
the window's vectors, drawn from the seed and read back from the feature
store through their DB rows, is compared with the plain reference's
float32 embedding of the same frames.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from h100bench import frames as F
from h100bench import reference, tracing, weights
from h100bench.harness import Check, Outcome, peak_bytes, sync


class _TimedExtractor:
    """The extractor as the embedder sees it, its calls timed."""

    def __init__(self, extractor, spans):
        self.preprocess_image = spans.wrap("extractor.preprocess_image",
                                           extractor.preprocess_image)
        self.extract_image_features = spans.wrap(
            "extractor.extract_image_features",
            extractor.extract_image_features)


class _Project:
    """A project under the run's temporary directory: its DB, the video
    feature store of the configuration's extractor, one source collection."""

    def __init__(self, root, extractor_id):
        from wise_tpu_torch import config, data_models as dm, db, project
        from wise_tpu_torch import store
        from wise_tpu_torch.db import repository

        cfg = config.WiseConfig()
        self.dm, self.repo = dm, repository
        self.proj = project.WiseProject(root / "project", create_project=True)
        self.proj.save_config(cfg)
        self.conn = db.init_project(self.proj.db_path)
        self.sc = repository.SourceCollectionRepo().create(
            self.conn, dm.SourceCollection(
                location=str(root / "media"),
                type=dm.SourceCollectionType.DIR))
        self.features_dir = self.proj.create_features_dir(extractor_id)
        self.store = store.FeatureStoreFactory.create_store(
            cfg.store.store_type, "video", self.features_dir)
        self.store.enable_write(cfg.store.shard_maxcount,
                                cfg.store.shard_maxsize)

    def media(self, k: int, n: int, size: int, fps: float) -> int:
        dm = self.dm
        row = self.repo.MediaRepo().create(self.conn, dm.MediaMetadata(
            source_collection_id=self.sc.id, path=f"clip{k:06d}.mp4",
            media_type=dm.MediaType.VIDEO, format="mp4", width=size,
            height=size, num_frames=n, duration=n / fps))
        return row.id

    def close(self):
        self.store.close()
        self.conn.commit()

    def vectors(self):
        """{vector id: unit vector} read back from the feature store."""
        from wise_tpu_torch.store import FeatureStoreFactory

        st = FeatureStoreFactory.load_store("video", self.features_dir)
        st.enable_read()
        return {int(i): np.asarray(v, np.float32).reshape(-1)
                for i, v in st}


def _extractor(ctx):
    """The configuration's extractor, built on the card, with the seed's
    vision weights loaded through its model's state_dict."""
    import torch
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    v = ctx.config["shapes"]["vision"]
    with torch.device(ctx.device):
        ext = OpenClipExtractor(ctx.config["port"]["extractor_id"],
                                device=ctx.device)
    vis = weights.make(weights.vision_spec(v), ctx.seed, ctx.device,
                       weights.served_dtype)
    missing, unexpected = ext.model.load_state_dict(vis, strict=False)
    stray = [k for k in missing if k.startswith("visual.")]
    if unexpected or stray:
        raise RuntimeError(f"the benchmark's vision weights do not match "
                           f"the port's tree: unexpected {unexpected[:5]}, "
                           f"missing {stray[:5]}")
    return ext


def _sample(ctx, window_ids):
    """The seed's sample of the window's vector ids, sorted."""
    n = min(ctx.traffic["sample"], len(window_ids))
    rng = np.random.default_rng([ctx.seed, 1])
    return sorted(rng.choice(sorted(window_ids), n, replace=False).tolist())


def run(ctx) -> Outcome:
    import torch

    tr, v = ctx.traffic, ctx.config["shapes"]["vision"]
    size, batch, clip = v["image_size"], tr["batch_size"], tr["clip_frames"]
    fps = tr["fps"]
    from wise_tpu_torch import data_models as dm
    from wise_tpu_torch.pipeline.extract import (ExtractionStats,
                                                 _BatchedEmbedder)

    ext = _extractor(ctx)
    pool = F.frames(ctx.seed, tr["pool_batches"] * batch, size)
    if len(pool) % clip:
        raise ValueError("the frame pool must hold whole clips")
    project = _Project(ctx.tmp, ctx.config["port"]["extractor_id"])
    spans = tracing.Spans()
    stats = ExtractionStats()
    embedder = _BatchedEmbedder(_TimedExtractor(ext, spans), project.store,
                                project.conn, dm.ModalityType.VIDEO, batch,
                                stats, "num_video_vectors")
    embedder._flush = spans.wrap("embedder.flush", embedder._flush)
    repo = embedder.vector_repo
    repo.create_batch = spans.wrap("db.vectors.create_batch",
                                   repo.create_batch)
    project.store.add = spans.wrap("store.add", project.store.add)
    pts = np.arange(clip, dtype=np.float64) / fps
    sent = {}

    def submit(k):
        off = (k * clip) % len(pool)
        mid = project.media(k, clip, size, fps)
        sent[mid] = off
        embedder.add_frames(mid, pool[off:off + clip], pts)

    for k in range(tr["warmup_clips"]):
        submit(k)
    sync(ctx.device)
    warm_ids = set(sent)
    k, before = tr["warmup_clips"], stats.frames_embedded
    spans.seconds.clear()
    trace_path = ctx.tmp / "trace.json"
    with tracing.profiled(trace_path, ctx.trace):
        t0 = time.perf_counter()
        with spans.span(tracing.WINDOW):
            while True:
                submit(k)
                k += 1
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
        window_s = time.perf_counter() - t0
    clips = k - tr["warmup_clips"]
    frames_done = stats.frames_embedded - before
    peak = peak_bytes(ctx.device)
    project.close()
    del embedder, ext
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    readings = {
        "spans": dict(spans.seconds),
        "trace": tracing.read_trace(trace_path) if ctx.trace else None,
        "frames": frames_done,
        "batches": frames_done // batch,
        "batch_size": batch,
        "vision": v,
        "window_s": window_s,
    }
    checks, fault = _judge(ctx, project, sent, warm_ids, clips * clip,
                           frames_done, pool, pts)
    project.conn.close()
    return Outcome(
        end_to_end={"frames_per_s": frames_done / window_s,
                    "setup_s": t0 - ctx.t_start},
        readings=readings, checks=checks, attempted=clips * clip,
        failed=clips * clip - frames_done, memory_peak_bytes=peak,
        fault=fault)


def _judge(ctx, project, sent, warm_ids, submitted, frames_done, pool, pts):
    """The window's accounting and the sample against the reference."""
    import torch

    fps = ctx.traffic["fps"]
    rows = project.conn.execute(
        "SELECT id, media_id, timestamp FROM vectors").fetchall()
    vectors = project.vectors()
    slot = {round(float(t) * fps): j for j, t in enumerate(pts)}
    wrong, seen, window_ids, frame_of = 0, set(), [], {}
    for vid, mid, ts in rows:
        j = slot.get(round(ts * fps)) if ts is not None else None
        key = (mid, j)
        if (mid not in sent or j is None or abs(pts[j] - ts) > 1e-9
                or key in seen or vid not in vectors):
            wrong += 1
            continue
        seen.add(key)
        frame_of[vid] = sent[mid] + j
        if mid not in warm_ids:
            window_ids.append(vid)
    expected = len(sent) * len(pts)
    wrong += abs(len(rows) - expected) + abs(len(vectors) - len(rows))
    wrong += abs(len(window_ids) - frames_done) + (submitted - frames_done)
    sample = _sample(ctx, window_ids)
    v = ctx.config["shapes"]["vision"]
    params = weights.make(weights.vision_spec(v), ctx.seed, ctx.device,
                          weights.served_dtype)
    idx = sorted({frame_of[i] for i in sample})
    frames = torch.from_numpy(pool[idx]).to(ctx.device)
    ref = reference.embed_frames(params, ctx.config["shapes"],
                                 frames).cpu().numpy()
    ref_of = dict(zip(idx, ref))
    gap = 0.0
    for vid in sample:
        got, want = vectors[vid], ref_of[frame_of[vid]]
        cos = float(got @ want) / max(float(np.linalg.norm(got)), 1e-30)
        gap = max(gap, 1.0 - cos)
    if not sample:
        gap = float("inf")
    got = {"rows_wrong": float(wrong), "cos_gap_max": gap}
    checks = [Check(name, got[name], limit)
              for name, limit in ctx.limits.items()]
    fault = "" if sample else "no vector of the window to compare"
    return checks, fault


def control(ctx, n: int):
    """The control's reading: the reference in float8 linear layers against
    the float32 reference, on ``n`` frames of the seed's pool."""
    import torch

    v = ctx.config["shapes"]["vision"]
    params = weights.make(weights.vision_spec(v), ctx.seed, ctx.device,
                          weights.served_dtype)
    pool = F.frames(ctx.seed, ctx.traffic["pool_batches"]
                    * ctx.traffic["batch_size"], v["image_size"])
    rng = np.random.default_rng([ctx.seed, 2])
    idx = np.sort(rng.choice(len(pool), n, replace=False))
    frames = torch.from_numpy(pool[idx]).to(ctx.device)
    want = reference.embed_frames(params, ctx.config["shapes"], frames)
    got = reference.embed_frames(params, ctx.config["shapes"], frames,
                                 linear="fp8")
    return {"cos_gap_max": float((1 - (got * want).sum(-1)).max())}

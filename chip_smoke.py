#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ViT-B/32 serve path once on one NVIDIA GPU.

    python3 chip_smoke.py                  # env, kernels, slice
    python3 chip_smoke.py --phase kernels  # env and kernels only

Phases, one line each; any failure exits non-zero:

1. env: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the kernel build (nvcc, sm_90a) from wise_tpu_torch/csrc.
2. kernels: each block kernel against its plain PyTorch version on the card,
   at the serve path's shapes and working dtypes, compared on the block's
   increment over its residual input: max abs error (must be <= 5% of the
   plain increment's max abs), minimum per-token cosine (must be >= 0.999),
   and ms per call of both. Two planted faults must fail the same check.
3. slice: a WiseProject built from seeded synthetic 224x224 uint8 frames,
   embedded by the port's OpenClipExtractor (ViT-B-32, production config,
   random weights) in batches of 256, written through the feature store and
   DB, indexed as IndexFlatIP, served by the port's REST server on
   localhost, and queried with text over HTTP. Checks the responses, that
   every block kernel launched during the run, and the served top-10 ids
   against a plain-PyTorch run of the same queries.

The line before the last is the kernels' JSON summary; the last is
{"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FRAMES = 4096  # synthetic 224x224 frames ingested by the slice phase
MODEL_ID = "mlfoundations/open_clip/ViT-B-32/laion2b_s34b_b79k"
QUERIES = ["a dog running on the beach", "people cooking in a kitchen",
           "a red car at night", "snow on the mountains", "a cat asleep",
           "children playing football", "a city street in the rain",
           "fireworks over a river"]
KERNEL_SOURCE = "wise_tpu_torch/csrc/block_kernels.cu"
REPLACES = {
    "fused_attn_block": "wise_tpu/ops/block.py:466",
    "fused_mlp_block": "wise_tpu/ops/block.py:916",
    "fused_attn_block_pooled": "wise_tpu/ops/block.py:634",
    "fused_attn_block_pooled_dyn": "wise_tpu/ops/block.py:811",
}


class PhaseError(RuntimeError):
    pass


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_env(torch, verbose_build: bool) -> str:
    from wise_tpu_torch.ops import build

    card = card_line()
    t0 = time.perf_counter()
    build.build(verbose=verbose_build)
    build.load_library()
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        build_s=f"{time.perf_counter() - t0:.3f}",
        nvcc_s=f"{build.build_seconds:.3f}")
    return card


def _cuda_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _block_inputs(torch, b, sp, d, dtype, seed, mlp=False):
    """x ~ N(0, 1); kernels at 1/sqrt(fan_in), as init_random_ draws them,
    so that each block adds about as much as x carries; biases and the
    LayerNorm offsets N(0, 0.02)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    f = 4 * d if mlp else d
    first = (d, 4 * d) if mlp else (d, 3 * d)
    x = r(b, sp, d, scale=1.0).to(dtype)
    ln = (1.0 + r(d), r(d))
    w = (r(*first, scale=d ** -0.5), r(first[1]), r(f, d, scale=f ** -0.5),
         r(d))
    return x, ln, tuple(t.to(torch.bfloat16) for t in w)


def _zero_q(w, d):
    """wqkv and bqkv with the q columns zeroed: every logit 0, so softmax
    attends uniformly over the unmasked keys."""
    wqkv, bqkv = w[0].clone(), w[1].clone()
    wqkv[:, :d] = 0
    bqkv[:d] = 0
    return (wqkv, bqkv, *w[2:])


def phase_kernels(torch):
    """Each kernel against its plain version at the serve path's shapes:
    vision layers (B=256 bucket, SP=50, D=768, f32 stream), text layers
    (B=8, SP=77, D=512, bf16 stream, causal). Each comparison is on the
    block's increment over its residual input (ops.block.
    increment_agreement), and must reject two planted faults: the kernel
    with its logits zeroed (for the MLP: its activation dropped), and a
    block that returns its residual input."""
    from wise_tpu_torch.ops import block as K

    f32, bf = torch.float32, torch.bfloat16
    vis = dict(b=256, sp=50, d=768, heads=12, dtype=f32)
    txt = dict(b=8, sp=77, d=512, heads=8, dtype=bf)
    rows = torch.tensor([3, 76, 0, 40, 11, 76, 25, 7], dtype=torch.int32,
                        device="cuda")
    results = []

    def case(name, tag, shape, seed, kernel, plain, base, fault, mlp=False):
        x, ln, w = _block_inputs(torch, shape["b"], shape["sp"], shape["d"],
                                 shape["dtype"], seed, mlp)
        with torch.inference_mode():
            got = kernel(x, ln, w)
            want = plain(x, ln, w)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise PhaseError(f"{name}[{tag}]: {tuple(got.shape)} "
                                 f"{got.dtype} vs {tuple(want.shape)} "
                                 f"{want.dtype}")
            check = K.increment_agreement(got, want, base(x))
            planted = {
                "faulted_kernel": K.increment_agreement(
                    fault(x, ln, w), want, base(x)),
                "block_skipped": K.increment_agreement(base(x), want,
                                                       base(x)),
            }
            ms = _cuda_ms(torch, lambda: kernel(x, ln, w), 20)
            plain_ms = _cuda_ms(torch, lambda: plain(x, ln, w), 20)
        caught = not any(c["ok"] for c in planted.values())
        ok = check["ok"] and caught
        say("kernels", name=f"{name}[{tag}]",
            shape="x".join(map(str, x.shape)), dtype=str(x.dtype)[6:],
            max_abs_err=f"{check['max_abs_err']:.6g}",
            err_bound=f"{check['err_bound']:.6g}",
            min_cos=f"{check['min_cos']:.6f}",
            planted_min_cos=",".join(f"{k}:{c['min_cos']:.4f}"
                                     for k, c in planted.items()),
            planted="FAIL(expected)" if caught else "PASSED(wrong)",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            status="ok" if ok else "FAIL")
        results.append(dict(name=name, tag=tag, key=(name, shape["sp"],
                                                     shape["d"]),
                            max_abs_err=check["max_abs_err"], ms=ms,
                            plain_ms=plain_ms, ok=ok))

    for tag, s, causal, seed in (("vision", vis, False, 1),
                                 ("text", txt, True, 2)):
        h, sp, d = s["heads"], s["sp"], s["d"]

        def attn(x, ln, w, h=h, sp=sp, c=causal):
            return K.fused_attn_block(x, *ln, *w, heads=h, n_valid=sp,
                                      causal=c)

        case("fused_attn_block", tag, s, seed, attn,
             lambda x, ln, w, h=h, sp=sp, c=causal: K.plain_attn_block(
                 x, *ln, *w, heads=h, n_valid=sp, causal=c),
             lambda x: x,
             lambda x, ln, w, attn=attn, d=d: attn(x, ln, _zero_q(w, d)))
        case("fused_mlp_block", tag, s, seed + 10,
             lambda x, ln, w: K.fused_mlp_block(x, *ln, *w, act="gelu"),
             lambda x, ln, w: K.plain_mlp_block(x, *ln, *w, act="gelu"),
             lambda x: x,
             lambda x, ln, w: K.fused_mlp_block(x, *ln, *w, act="none"),
             mlp=True)

    def pooled(x, ln, w):
        return K.fused_attn_block_pooled(x, *ln, *w, heads=12, n_valid=50,
                                         pool_row=0)

    case("fused_attn_block_pooled", "vision", vis, 3, pooled,
         lambda x, ln, w: K.plain_attn_block_pooled(
             x, *ln, *w, heads=12, n_valid=50, pool_row=0),
         lambda x: x[:, 0],
         lambda x, ln, w: pooled(x, ln, _zero_q(w, 768)))

    def dyn(x, ln, w):
        return K.fused_attn_block_pooled_dyn(x, rows, *ln, *w, heads=8,
                                             n_valid=77, causal=True)

    case("fused_attn_block_pooled_dyn", "text", txt, 4, dyn,
         lambda x, ln, w: K.plain_attn_block_pooled_dyn(
             x, rows, *ln, *w, heads=8, n_valid=77, causal=True),
         lambda x: x[torch.arange(8, device="cuda"), rows.long()],
         lambda x, ln, w: dyn(x, ln, _zero_q(w, 512)))
    bad = [f"{r['name']}[{r['tag']}]" for r in results if not r["ok"]]
    if bad:
        raise PhaseError(f"kernels disagree with their plain versions, or "
                         f"the check missed a planted fault: {bad}")
    return results


def _frames(seed: int, n: int, size: int):
    """Seeded synthetic frames: a coarse random 7x7 colour layout upsampled
    to the frame size, plus pixel noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cell = -(-size // 7)
    base = rng.integers(0, 256, (n, 7, 7, 3), dtype=np.int16)
    img = np.repeat(np.repeat(base, cell, 1), cell, 2)[:, :size, :size]
    img = img + rng.integers(-20, 21, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _ingest(project_dir: Path, extractor, model_id: str, clips):
    """Register one VIDEO media row per clip and embed its frames through
    the extract driver's batched embedder, feature store and DB writes."""
    import numpy as np
    from wise_tpu_torch._host import config, data_models as dm, db, project
    from wise_tpu_torch._host import repository, store
    from wise_tpu_torch.pipeline.extract import (BatchedEmbedder,
                                                 ExtractionStats)

    cfg = config.WiseConfig()
    proj = project.WiseProject(project_dir, create_project=True)
    proj.save_config(cfg)
    conn = db.init_project(proj.db_path)
    sc = repository.SourceCollectionRepo().create(conn, dm.SourceCollection(
        location=str(project_dir / "media"),
        type=dm.SourceCollectionType.DIR))
    fstore = store.FeatureStoreFactory.create_store(
        cfg.store.store_type, "video", proj.create_features_dir(model_id))
    fstore.enable_write(cfg.store.shard_maxcount, cfg.store.shard_maxsize)
    stats = ExtractionStats()
    embedder = BatchedEmbedder(extractor, fstore, conn, dm.ModalityType.VIDEO,
                               256, stats, "num_video_vectors")
    t0 = time.perf_counter()
    for i, frames in enumerate(clips):
        size = frames.shape[1]
        media = repository.MediaRepo().create(conn, dm.MediaMetadata(
            source_collection_id=sc.id, path=f"clip{i:03d}.mp4",
            media_type=dm.MediaType.VIDEO, format="mp4", width=size,
            height=size, num_frames=len(frames), duration=len(frames) / 2))
        embedder.add_frames(media.id, frames,
                            np.arange(len(frames), dtype=np.float64) / 2)
    embedder.finish()
    fstore.close()
    conn.commit()
    conn.close()
    return stats.frames_embedded, time.perf_counter() - t0


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=300) as r:
        if r.status != 200:
            raise PhaseError(f"GET {url}: HTTP {r.status}")
        return json.loads(r.read())


def _served_top(resp, k: int):
    """(vector ids, distances) of a /search response, best first."""
    vr = resp.get("video_results") or {}
    wins = vr.get("unmerged_windows")
    if not isinstance(wins, list) or len(wins) != k or not vr.get("videos"):
        raise PhaseError(f"malformed search response: {str(resp)[:300]}")
    pairs = [(int(w["vector_id"]), float(w["distance"])) for w in wins]
    if not all(math.isfinite(d) and -1.01 <= d <= 1.01 for _, d in pairs):
        raise PhaseError(f"non-finite or out-of-range distances: {pairs}")
    pairs.sort(key=lambda p: (-p[1], p[0]))
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _check_against_plain(served_ids, served_d, plain_scores, ids, k, tol):
    """The served top-k against the plain run's ranking: the same ids up to
    swaps between scores within ``tol``, distances within ``tol`` (plus the
    response's 3-decimal rounding) of the plain scores."""
    import numpy as np

    by_id = dict(zip(ids.tolist(), plain_scores.tolist()))
    order = np.lexsort((ids, -plain_scores))[:k]
    plain_top = plain_scores[order]
    got = np.array([by_id[i] for i in served_ids])
    if np.abs(np.sort(got)[::-1] - plain_top).max() > tol:
        raise PhaseError(
            f"served ids {served_ids} are not the plain top-{k} "
            f"{ids[order].tolist()} (plain scores {got} vs {plain_top})")
    if np.abs(got - np.array(served_d)).max() > tol + 5e-4:
        raise PhaseError(f"served distances {served_d} vs plain {got}")


def phase_slice(torch, card, model_id=MODEL_ID, size=224, k=10):
    """Ingest -> IndexFlatIP -> REST on the port; returns the launch counts
    of the main path's run, keyed by (wrapper, SP, D)."""
    import numpy as np
    from wise_tpu_torch._host import db, project
    from wise_tpu_torch.api.server import create_server
    from wise_tpu_torch.cli import create_index
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops.topk import flat_topk

    clip_len, n_frames = 256, FRAMES
    seeds = range((n_frames + clip_len - 1) // clip_len)
    clips = [_frames(s, min(clip_len, n_frames - s * clip_len), size)
             for s in seeds]
    with tempfile.TemporaryDirectory(prefix="wise_smoke_") as tmp:
        project_dir = Path(tmp) / "proj"
        extractor = OpenClipExtractor(model_id)
        with torch.inference_mode():  # first use: cuBLAS, kernel library
            extractor.extract_image_features(clips[0][:8])
            extractor.extract_text_features(["warm up"])

        K.reset_launches()
        n, ingest_s = _ingest(project_dir, extractor, model_id, clips)
        if n != n_frames:
            raise PhaseError(f"embedded {n} of {n_frames} frames")
        if create_index.main(["--project-dir", str(project_dir)]) != 0:
            raise PhaseError("create-index failed")
        config = project.WiseProject(project_dir).load_config()
        config.serve.coalesce = True
        server = create_server(project_dir, "127.0.0.1", 0, config=config)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = (f"http://127.0.0.1:{server.server_address[1]}/"
                f"{project_dir.name}/search?end={k}&q=")
        served, lat = {}, []
        try:
            _get_json(base + "warm")
            for _ in range(3):
                for q in QUERIES:
                    t0 = time.perf_counter()
                    resp = _get_json(base + urllib.parse.quote(q))
                    lat.append(time.perf_counter() - t0)
                    served[q] = _served_top(resp, k)
            burst = {}

            def fetch(q):
                burst[q] = _served_top(_get_json(base + urllib.parse.quote(q)),
                                       k)

            workers = [threading.Thread(target=fetch, args=(q,))
                       for q in QUERIES]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
            if set(burst) != set(QUERIES):
                raise PhaseError("concurrent requests failed")
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        launches = dict(K.LAUNCHES_BY_SHAPE)
        if not all(K.LAUNCHES.values()):
            raise PhaseError(f"a kernel did not launch on the path: "
                             f"{K.LAUNCHES}")
        for q in QUERIES:
            if burst[q][0] != served[q][0]:
                raise PhaseError(f"{q!r}: concurrent and sequential top-{k} "
                                 f"differ: {burst[q][0]} vs {served[q][0]}")

        # the same frames and queries through the plain PyTorch path
        os.environ["WISE_FUSED_BLOCK"] = "0"
        try:
            plain = OpenClipExtractor(model_id)
        finally:
            del os.environ["WISE_FUSED_BLOCK"]
        conn = db.connect(project.WiseProject(project_dir).db_path,
                          readonly=True)
        ids = np.array([r[0] for r in conn.execute(
            "SELECT id FROM vectors ORDER BY id")])
        conn.close()
        vecs = np.concatenate([
            np.concatenate([plain.extract_image_features(c[i:i + 256])
                            for i in range(0, len(c), 256)])
            for c in clips])
        prefix = config.search.query_prefix
        for q in QUERIES:
            qv = plain.extract_text_features([f"{prefix} {q}".strip()])[0]
            scores = (torch.from_numpy(vecs) @ torch.from_numpy(qv)).numpy()
            _check_against_plain(*served[q], scores, ids, k, 1e-3)

        # text embed + exact flat top-k p50 on a device-resident 1M x 512
        # database (flat_topk called directly: no index, HTTP or hydration)
        g = torch.Generator(device=extractor.device).manual_seed(0)
        big = torch.randn(1 << 20, extractor.output_dim, generator=g,
                          device=extractor.device)
        big = big / big.norm(dim=1, keepdim=True)
        lat_1m = []
        for i in range(25):
            t0 = time.perf_counter()
            qv = extractor.extract_text_features([QUERIES[i % 8]])
            _, rows = flat_topk(torch.from_numpy(qv), big,
                                n_valid=big.shape[0], k=k)
            rows.cpu()
            lat_1m.append(time.perf_counter() - t0)
        del big
        rates = {name: _encode_rates(torch, fe, clips[0])
                 for name, fe in (("kernels", extractor), ("plain", plain))}

    say("slice", card=repr(card), frames=n, ingest_s=f"{ingest_s:.3f}",
        frames_per_s=f"{n / ingest_s:.1f}", requests=len(lat) + 9,
        query_p50_ms=f"{1e3 * float(np.median(lat)):.3f}",
        embed_topk_1M_p50_ms=f"{1e3 * float(np.median(lat_1m[5:])):.3f}",
        launches=json.dumps({f"{n}[SP={sp},D={d}]": c for (n, sp, d), c
                             in sorted(launches.items())},
                            separators=(",", ":")),
        vs_plain="ok")
    for name, (fps, tower_ms) in rates.items():
        say("slice", card=repr(card), path=name, batch=len(clips[0]),
            extractor_frames_per_s=f"{fps:.1f}",
            device_ms_per_batch=f"{tower_ms:.3f}",
            device_frames_per_s=f"{1e3 * len(clips[0]) / tower_ms:.1f}")
    return launches


def _encode_rates(torch, extractor, frames, reps: int = 5):
    """(frames/s of extract_image_features on one batch, host to host;
    device ms of preprocess + image tower on that batch, CUDA events)."""
    extractor.extract_image_features(frames)
    t0 = time.perf_counter()
    for _ in range(reps):
        extractor.extract_image_features(frames)
    fps = reps * len(frames) / (time.perf_counter() - t0)
    x = torch.from_numpy(frames).to(extractor.device)
    size = extractor.config.image_size

    def tower():
        extractor.model.encode_image(extractor.preprocess_frames(x, size))

    with torch.inference_mode():
        ms = _cuda_ms(torch, tower, reps)
    return fps, ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["all", "kernels"], default="all")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, shared memory)")
    args = ap.parse_args(argv)

    if not (ROOT / "wise_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: wise_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        card = phase_env(torch, args.verbose_build)
        kernels = phase_kernels(torch)
        if args.phase == "kernels":
            return 0
        launches = phase_slice(torch, card)
        idle = [f"{r['name']}[{r['tag']}]" for r in kernels
                if not launches.get(r["key"])]
        if idle:
            raise PhaseError(f"not launched on the path at the shape "
                             f"checked: {idle}")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    print(card)
    print(json.dumps({"kernels": [
        {"name": f"{r['name']}[{r['tag']}]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES[r["name"]],
         "launches": launches[r["key"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for r in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

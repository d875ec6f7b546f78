"""The port's copies of the evaluation tools and the two small CLIs
(wise_tpu_torch/eval/retrieval.py, eval/index_recall.py,
cli/merge_projects.py, io/__main__.py) against their origins in the JAX
package, on the same inputs.

Tolerance: the copies are numpy and sqlite code, so their outputs are equal:
the mAP and the similarity matrix exactly; ``evaluate_index``'s recalls on
an IVF-PQ index of each package exactly (the two indexes return the same
ids); a merged project's database rows and store shards byte for byte.
"""

import csv
import importlib
import shutil

import numpy as np
import pytest

from tests.media_fixtures import make_image, make_video
from tests.test_index import _build_project_store
from tests.test_torch_slice import native_decoders_ready
from wise_tpu.config import IndexConfig as JIndexConfig
from wise_tpu.index import FeatureSearchIndex as JIndex
from wise_tpu_torch.config import IndexConfig
from wise_tpu_torch.index.feature_index import FeatureSearchIndex

PKGS = ("wise_tpu", "wise_tpu_torch")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")


def _both(module):
    return [importlib.import_module(f"{pkg}.{module}") for pkg in PKGS]


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return path


def test_retrieval_matches_reference(tmp_path):
    J, T = _both("eval.retrieval")
    for stamp in ("00:00:12.300", "01:02:03", "00:10:00.05"):
        assert T.hhmmss_to_sec(stamp) == J.hhmmss_to_sec(stamp)
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b = np.sort(rng.uniform(0, 10, 2)), np.sort(rng.uniform(0, 10, 2))
        thr = float(rng.uniform(0, 0.5))
        assert (T.segment_iou_overlap(a, b, thr)
                == J.segment_iou_overlap(a, b, thr))
    sim = rng.standard_normal((7, 30))
    rel = (rng.uniform(size=(7, 30)) < 0.2).astype(np.int64)
    rel[3] = 0                                   # a query with no relevant doc
    assert T.calculate_mAP(sim, rel) == J.calculate_mAP(sim, rel)

    gt = _write_csv(tmp_path / "gt.csv", [
        "narration_id", "participant_id", "video_id", "narration_timestamp",
        "start_timestamp", "stop_timestamp", "narration"], [
        ["n0", "p1", "P01_01", "00:00:01.00", "00:00:01.00", "00:00:04.50",
         "cut"],
        ["n1", "p1", "P01_01", "00:00:09.00", "00:00:09.00", "00:00:12.00",
         "wash"],
        ["n2", "p2", "P02_03", "00:01:00.00", "00:01:00.00", "00:01:03.00",
         "open"]])
    queries = _write_csv(tmp_path / "q.csv", ["id", "text"],
                         [["q0", "cut onion"], ["q1", "open fridge"]])
    results = _write_csv(tmp_path / "r.csv", [
        "query", "rank", "filename", "start_time", "end_time", "score"], [
        ["q0", 0, "videos/P01_01.mp4", 1.5, 4.0, 0.31],
        ["q0", 1, "videos/P01_01.mp4", 9.5, 11.0, 0.22],
        ["q1", 0, "videos/P02_03.MP4", 60.0, 62.5, 0.40],
        ["q9", 0, "videos/P02_03.MP4", 60.0, 62.5, 0.90],
        ["q1", 1, "videos/unknown.mp4", 0.0, 1.0, 0.10]])
    segs = {}
    for mod in (J, T):
        video_segments, n = mod.load_ground_truth_segments(gt)
        ids, texts = mod.load_queries(queries)
        segs[mod] = (video_segments, n, ids, texts, mod.build_similarity_matrix(
            results, ids, video_segments, n, 0.1))
    (jv, jn, jids, jt, jsim), (tv, tn, tids, tt, tsim) = segs[J], segs[T]
    assert (tv, tn, tids, tt) == (jv, jn, jids, jt)
    assert tsim.dtype == jsim.dtype and tsim.any()
    np.testing.assert_array_equal(tsim, jsim)
    from wise_tpu_torch.eval import build_similarity_matrix, calculate_mAP

    assert calculate_mAP is T.calculate_mAP
    assert build_similarity_matrix is T.build_similarity_matrix


def test_index_recall_matches_reference(tmp_path):
    J, T = _both("eval.index_recall")
    rng = np.random.default_rng(1)
    exact = rng.integers(0, 50, (6, 20))
    ann = np.where(rng.uniform(size=(6, 20)) < 0.7, exact,
                   rng.integers(50, 99, (6, 20)))
    for k in (1, 5, 20):
        assert T.recall_at_k(exact, ann, k) == J.recall_at_k(exact, ann, k)
        assert (T.top1_recall_at_n(exact, ann, k)
                == J.top1_recall_at_n(exact, ann, k))

    asset, ids, vecs = _build_project_store(tmp_path, n=800, dim=32, seed=7)
    cfg = dict(pq_train_samples=800, nprobe=6)
    fid = "wise/random_features/32/test"
    jidx = JIndex("video", fid, asset, config=JIndexConfig(**cfg))
    assert jidx.create_index("IndexIVFPQ")
    tidx = FeatureSearchIndex("video", fid, asset, config=IndexConfig(**cfg))
    queries = vecs[rng.permutation(800)[:16]]
    metrics = {}
    for mod, idx in ((J, jidx), (T, tidx)):
        assert idx.load_index("IndexIVFPQ")
        metrics[mod] = mod.evaluate_index(idx, queries, vecs, ids, topk=20,
                                          r1_n=10)
    for name in ("R0@10", "R0@100", "R1@10"):
        assert metrics[T][name] == metrics[J][name], name
    assert 0.5 < metrics[T]["R0@10"] <= 1.0 and metrics[T]["sec_per_query"] > 0


def _project_rows(db, proj):
    conn = db.connect(proj.db_path, readonly=True)
    out = {table: sorted(tuple(r) for r in conn.execute(
        f"SELECT * FROM {table}"))
        for table in ("source_collections", "media", "vectors")}
    conn.close()
    return out


def test_merge_projects_matches_reference(tmp_path):
    """Two workers' projects (disjoint id ranges, as ``--ingest-worker``
    makes them) merged by each package's CLI: the same rows and shards; ids
    that collide abort both."""
    from wise_tpu_torch import db
    from wise_tpu_torch.pipeline.extract import (INGEST_ID_STRIDE,
                                                 extract_features)
    from wise_tpu_torch.project import WiseProject

    media = tmp_path / "media"
    media.mkdir()
    make_video(media / "v1.mp4", seconds=3, fps=10)
    make_video(media / "v2.mp4", seconds=2, fps=10)
    make_image(media / "i1.png", value=60)
    fid = "wise/random_features/32/merge"
    for w in range(2):
        extract_features([media], tmp_path / f"w{w}", image_feature_id=fid,
                         video_feature_id=fid, audio_feature_id=fid,
                         batch_size=8, ingest_worker=w, ingest_workers=2)
    merged = {}
    for pkg in PKGS:
        main = importlib.import_module(f"{pkg}.cli.merge_projects").main
        target = tmp_path / f"merged-{pkg}"
        assert main(["--target-dir", str(target), "--source-dir",
                     str(tmp_path / "w0"), "--source-dir",
                     str(tmp_path / "w1")]) == 0
        proj = WiseProject(target)
        shards = {p.relative_to(target): p.read_bytes()
                  for p in sorted(target.rglob("*.tar"))}
        merged[pkg] = (_project_rows(db, proj), shards)
    (jrows, jshards), (trows, tshards) = merged["wise_tpu"], merged[
        "wise_tpu_torch"]
    assert trows == jrows and tshards == jshards
    assert len(trows["media"]) == 3 and len(tshards) >= 2
    assert max(r[0] for r in trows["vectors"]) > INGEST_ID_STRIDE

    shutil.copytree(tmp_path / "w0", tmp_path / "again")
    for pkg in PKGS:
        main = importlib.import_module(f"{pkg}.cli.merge_projects").main
        with pytest.raises(SystemExit, match="disjoint"):
            main(["--target-dir", str(tmp_path / f"clash-{pkg}"),
                  "--source-dir", str(tmp_path / "w0"),
                  "--source-dir", str(tmp_path / "again")])


def test_io_main_probe_matches_reference(tmp_path, capsys):
    native_decoders_ready()
    media = tmp_path / "media"
    media.mkdir()
    make_video(media / "v1.mp4", seconds=2, fps=10)
    make_image(media / "i1.png", value=40)
    out = {}
    for pkg in PKGS:
        main = importlib.import_module(f"{pkg}.io.__main__").main
        for media_type in ("video", "image"):
            assert main([str(media), "--media-type", media_type,
                         "--probe-only"]) == 0
        assert main([str(media), "--media-type", "image"]) == 0
        out[pkg] = capsys.readouterr().out
    lines = [o.splitlines() for o in out.values()]
    assert lines[0][:-1] == lines[1][:-1] and "1 valid files" in out[PKGS[1]]
    # the last line carries the decode rate: equal up to the rate
    assert [line.split(" in ")[0] for line in lines[0][-1:]] == [
        line.split(" in ")[0] for line in lines[1][-1:]]

"""The port's shot detection (wise_tpu_torch/pipeline/shots.py, the
detect-shots CLI) against the JAX package's.

- ``frame_change_scores`` against the JAX function to 1e-3 abs on odd frame
  sizes and lengths, with chunks of the port's stream ending anywhere. The
  two resizes sum in other orders, so a pixel on a bin edge may land in the
  next bin: one such flip moves a score by 1 / (3 x 1024) = 3.3e-4;
- ``detect_shots``' spans equal to the JAX package's on
  tests/test_shots.py's synthetic shots;
- both packages' ``detect_shots_for_project`` and CLI ``main`` writing the
  same rows on two copies of one project, each decoding with its own native
  decoder (``native_decoders_ready`` first).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from tests.media_fixtures import make_av_lossless, make_video
from tests.test_shots import _synthetic_shots
from tests.test_torch_slice import native_decoders_ready
from wise_tpu import db as jdb
from wise_tpu.cli import shots as jcli
from wise_tpu.pipeline import shots as JS
from wise_tpu_torch.cli import shots as tcli
from wise_tpu_torch.pipeline import shots as TS


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")


def _frames(t, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("t,h,w,chunk", [
    (2, 24, 24, 1),      # one pair, a chunk a frame
    (17, 37, 53, 16),    # the last chunk one frame long
    (33, 31, 45, 16),    # odd sides, a ragged last chunk
    (32, 32, 32, 16),    # no resize, chunks end on the length
    (40, 20, 100, 7),    # upsampled height, downsampled width
    (9, 72, 128, 128),   # one chunk
])
def test_frame_change_scores_match_jax(t, h, w, chunk):
    """The scores of ``frame_change_scores`` and of the stream fed ``chunk``
    frames at a time (as ``detect_shots_for_project`` feeds the decoder's
    chunks) against the JAX function."""
    frames = _frames(t, h, w, seed=t * 1000 + h)
    want = np.asarray(JS.frame_change_scores(jnp.asarray(frames)))
    got = TS.frame_change_scores(frames)
    scorer = TS.ChangeScorer()
    for i in range(0, t, chunk):
        scorer.add(frames[i:i + chunk])
    streamed = scorer.scores()
    assert got.shape == streamed.shape == want.shape == (t - 1,)
    assert got.dtype == streamed.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    np.testing.assert_allclose(streamed, want, atol=1e-3, rtol=0)


def test_linear_resize_weights_match_jax_resize():
    """One axis through the weights equals jax.image.resize's linear,
    antialiased resize of it (down and up)."""
    import jax

    from wise_tpu_torch.models.clip.preprocess import resize_weights

    x = np.random.default_rng(5).random((1, 45, 7)).astype(np.float32)
    for n in (32, 60):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, n, 7),
                                           "linear"))
        got = np.einsum("Hh,bhc->bHc", resize_weights(45, n, "linear"), x)
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_chunked_scores_are_the_whole_run():
    """Chunks that overlap by one frame give the scores of one pass, past
    CHUNK frames too."""
    frames = _frames(TS.CHUNK + 9, 40, 56, seed=3)
    whole = TS.frame_change_scores(frames)
    for chunk in (1, 2, 13, TS.CHUNK + 8):
        scorer = TS.ChangeScorer()
        for i in range(0, len(frames), chunk):
            scorer.add(frames[i:i + chunk])
        np.testing.assert_allclose(scorer.scores(), whole, atol=1e-6)


@pytest.mark.parametrize("n_shots,per_shot,threshold", [
    (3, 10, 0.15), (3, 10, 0.2), (5, 7, 0.2), (2, 20, 0.2), (1, 8, 0.2)])
def test_detect_shots_matches_jax(n_shots, per_shot, threshold):
    frames, pts = _synthetic_shots(n_shots, per_shot)
    want = JS.detect_shots(frames, pts, threshold=threshold)
    got = TS.detect_shots(frames, pts, threshold=threshold)
    assert got == want
    assert len(got) == n_shots


@pytest.mark.parametrize("n", [0, 1])
def test_detect_shots_short_streams(n):
    frames, pts = _synthetic_shots(1, 4)
    assert (TS.detect_shots(frames[:n], pts[:n])
            == JS.detect_shots(frames[:n], pts[:n]))


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A project with a video of three planted shots (lossless: both
    decoders give the same frames) and a video with none, of one frame size
    (the JAX package's ingest batches one size at a time: C 4)."""
    from wise_tpu.pipeline import extract_features

    native_decoders_ready()
    root = tmp_path_factory.mktemp("shots")
    media = root / "m"
    media.mkdir()
    make_av_lossless(media / "cuts.avi", seconds=6, fps=4, size=(64, 48),
                     block_seconds=2)
    make_video(media / "v.mp4", seconds=4, fps=10)
    pdir = root / "p"
    fid = "wise/random_features/16/shots"
    extract_features([media], pdir, image_feature_id=fid,
                     video_feature_id=fid, audio_feature_id=fid)
    return pdir


def _rows(pdir):
    from wise_tpu.project import WiseProject

    conn = jdb.connect(WiseProject(pdir).db_path, readonly=True)
    rows = [tuple(r) for r in conn.execute(
        "SELECT media_id, start_time, end_time FROM shots "
        "ORDER BY media_id, start_time").fetchall()]
    conn.close()
    return rows


def test_detect_shots_for_project_writes_the_reference_rows(project,
                                                           tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(project, jdir)
    shutil.copytree(project, tdir)
    n_j = JS.detect_shots_for_project(jdir)
    n_t = TS.detect_shots_for_project(tdir)
    assert n_t == n_j == len(_rows(tdir))
    assert _rows(tdir) == _rows(jdir)
    # a second run replaces a media's rows; at 0.1 the planted cuts (three
    # 2 s blocks of random pixels, 2 fps: scores ~0.2) are found
    n_j = JS.detect_shots_for_project(jdir, threshold=0.1)
    n_t = TS.detect_shots_for_project(tdir, threshold=0.1)
    assert n_t == n_j == len(_rows(tdir))
    assert _rows(tdir) == _rows(jdir)
    spans = {}
    for media_id, start, end in _rows(tdir):
        spans.setdefault(media_id, []).append((start, end))
    assert [(0.0, 1.5), (2.0, 3.5), (4.0, 5.5)] in spans.values()


def test_cli_main_writes_the_reference_rows(project, tmp_path, capsys):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(project, jdir)
    shutil.copytree(project, tdir)
    assert jcli.main(["--project-dir", str(jdir), "--threshold", "0.1"]) == 0
    assert tcli.main(["--project-dir", str(tdir), "--threshold", "0.1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rows = _rows(tdir)
    assert out[-1] == f"wrote {len(rows)} shots" == out[-2]
    assert rows == _rows(jdir) and len(rows) == 4
    assert tcli.build_parser().parse_args(
        ["--project-dir", "P"]).threshold == 0.2


def test_scores_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """Without a card and without WISE_TORCH_DEVICE the scores raise
    instead of running on the CPU."""
    import torch

    monkeypatch.delenv("WISE_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="WISE_TORCH_DEVICE"):
        TS.frame_change_scores(_frames(3, 8, 8, 0))

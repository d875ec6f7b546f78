"""The port's serve path end to end against the JAX package's.

Both packages drive the same media (tests/media_fixtures.py) through their
own extract-features -> create-index -> search CLI -> REST server, with a
tiny CLIP (ViT-Test-Tiny's shape with a vocabulary of 4,096, registered in
both registries for the test: the hash tokenizer's ids fall outside a
vocabulary under 3,000, which the port refuses where the JAX towers clamp)
loading one seeded open_clip-keyed ``.npz`` from a temporary
WISE_CHECKPOINT_DIR. In f32 (the conformance dtype) the two towers agree to
~1e-7, so the searches return the same results: the same CSV rows (scores
printed to 3 decimals, so they may differ by one unit in the last digit) and
the same REST vector ids. A subprocess runs the port's path alone and shows
that it never imports jax or flax.
"""

import csv
import importlib
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from tests.media_fixtures import make_image, make_video

ROOT = Path(__file__).resolve().parents[1]
MODEL, VOCAB = "ViT-Test-Slice", 4096
FID = f"mlfoundations/open_clip/{MODEL}/slice"
QUERIES = ["red", "a dog in the snow", "green light"]


def native_decoders_ready(timeout: float = 60.0) -> None:
    """Both packages' FFmpeg decoders loaded, or fail by name. The JAX
    package links its library in place at first use (``make -C
    wise_tpu/native``): a worker that loads it while another worker is
    linking gets a partial file, and its module keeps ``available()`` False
    for the worker's life, so its drives decode with OpenCV, whose frames
    differ from FFmpeg's. Such a worker clears the module's attempt and
    loads again until the link is done (up to ``timeout`` s)."""
    import time

    from wise_tpu.io import native_decoder as JN
    from wise_tpu_torch.io import native_decoder as TN

    deadline = time.monotonic() + timeout
    while (not JN.available() and JN._LIB_PATH.exists()
           and time.monotonic() < deadline):
        time.sleep(1.0)
        JN._lib, JN._load_attempted = None, False
    assert JN.available(), "the JAX package's native decoder did not load"
    assert TN.available(), "the port's native decoder did not load"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Media, the checkpoint, and the environment both drives run under;
    both packages decode with their native FFmpeg decoders."""
    import dataclasses

    from tests.test_convert_published_keysets import openclip_clip_keyset
    from wise_tpu.models.clip import model as JM
    from wise_tpu_torch.models.clip import config as TC

    native_decoders_ready()
    root = tmp_path_factory.mktemp("slice")
    media = root / "media"
    media.mkdir()
    make_video(media / "v1.mp4", seconds=6, fps=10)
    make_video(media / "v2.mp4", seconds=4, fps=10)
    make_image(media / "i1.png", value=50)
    make_image(media / "i2.png", value=200)
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(JM.get_clip_config("ViT-Test-Tiny"),
                              vocab_size=VOCAB)
    sd = {k: rng.normal(0.0, 0.02, np.shape(v)).astype(np.float32)
          for k, v in openclip_clip_keyset(cfg).items()}
    ckpt = root / "ckpts" / MODEL / "slice"
    ckpt.mkdir(parents=True)
    np.savez(ckpt / "open_clip_model.npz", **sd)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JM.CLIP_CONFIGS, MODEL, cfg)
        mp.setitem(TC.CLIP_CONFIGS, MODEL, dataclasses.replace(
            TC.get_clip_config("ViT-Test-Tiny"), vocab_size=VOCAB))
        mp.setenv("WISE_CHECKPOINT_DIR", str(root / "ckpts"))
        mp.setenv("WISE_CLIP_DTYPE", "float32")
        mp.setenv("WISE_TORCH_DEVICE", "cpu")
        yield root


def _rest(create_server, project_dir, query, k=5):
    server = create_server(project_dir, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = (f"http://127.0.0.1:{server.server_address[1]}/"
               f"{Path(project_dir).name}/search?end={k}&q="
               + urllib.parse.quote(query))
        with urllib.request.urlopen(url, timeout=120) as r:
            assert r.status == 200
            resp = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    wins = sorted(resp["video_results"]["unmerged_windows"],
                  key=lambda w: (-w["distance"], int(w["vector_id"])))
    return [int(w["vector_id"]) for w in wins], [w["distance"] for w in wins]


def _drive(pkg, root):
    """extract -> create-index -> search CLI (CSV) -> REST with ``pkg``."""
    def cli(name):
        return importlib.import_module(f"{pkg}.cli.{name}").main

    proj = root / pkg
    assert cli("extract_features")([
        str(root / "media"), "--project-dir", str(proj),
        "--video-feature-id", FID, "--image-feature-id", FID,
        "--batch-size", "8"]) == 0
    assert cli("create_index")(["--project-dir", str(proj)]) == 0
    out = {}
    for i, q in enumerate(QUERIES):
        csv_path = root / f"{pkg}-{i}.csv"
        assert cli("search")([
            "--project-dir", str(proj), "--query", q, "--in", "video",
            "--topk", "5", "--result-format", "csv",
            "--save-to-file", str(csv_path)]) == 0
        with open(csv_path) as f:
            rows = list(csv.reader(f))
        server = importlib.import_module(f"{pkg}.api.server")
        out[q] = rows, _rest(server.create_server, proj, q)
    return out


@pytest.fixture(scope="module")
def drives(env):
    return _drive("wise_tpu", env), _drive("wise_tpu_torch", env)


@pytest.mark.parametrize("query", QUERIES)
def test_search_cli_matches_jax(drives, query):
    (want, _), (got, _) = drives[0][query], drives[1][query]
    assert len(got) == len(want) > 1
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g[-1]) - float(w[-1])) <= 1.001e-3


@pytest.mark.parametrize("query", QUERIES)
def test_rest_matches_jax(drives, query):
    (_, (want_ids, want_d)), (_, (got_ids, got_d)) = (drives[0][query],
                                                      drives[1][query])
    assert len(got_ids) == 5
    assert got_ids == want_ids
    np.testing.assert_allclose(got_d, want_d, atol=1.001e-3)


def test_port_path_never_imports_jax(env):
    """extract -> index -> search -> REST through the port in a fresh
    interpreter: jax, flax and the JAX package stay out of sys.modules."""
    script = textwrap.dedent(f"""
        import dataclasses, json, sys
        from wise_tpu_torch.cli import create_index, extract_features, search
        from wise_tpu_torch.api.server import create_server
        from wise_tpu_torch.models.clip import config as TC
        TC.CLIP_CONFIGS[{MODEL!r}] = dataclasses.replace(
            TC.get_clip_config("ViT-Test-Tiny"), vocab_size={VOCAB})
        proj = {str(env / "nojax")!r}
        assert extract_features.main([{str(env / "media")!r},
            "--project-dir", proj, "--video-feature-id", {FID!r},
            "--image-feature-id", {FID!r}, "--batch-size", "8"]) == 0
        assert create_index.main(["--project-dir", proj]) == 0
        assert search.main(["--project-dir", proj, "--query", "red",
                            "--in", "video"]) == 0
        sys.path.insert(0, {str(ROOT / "tests")!r})
        from test_torch_slice import _rest
        ids, _ = _rest(create_server, proj, "red")
        assert len(ids) == 5
        print(json.dumps({{m: any(k == m or k.startswith(m + ".")
                                       for k in sys.modules)
                          for m in ("jax", "flax", "wise_tpu")}}))
    """)
    run = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             "WISE_TORCH_DEVICE": "cpu"},
    )
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == {
        "jax": False, "flax": False, "wise_tpu": False}

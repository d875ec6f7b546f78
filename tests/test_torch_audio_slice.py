"""The port's audio path end to end against the JAX package's.

Both packages drive the same WAV files through their own extract-features
(audio segments -> CLAP audio tower -> feature store and DB) ->
create-index (IndexFlatIP) -> search CLI ``--in audio`` -> REST
``search_in=audio``, with a tiny CLAP 2023 config registered in both and one
seeded msclap-layout ``.pth`` in a temporary WISE_CHECKPOINT_DIR, which both
load through the reference's converter. In f32 (the conformance dtype) the
extractors agree to 2e-4 on every embedding, so the searches return the same
results: the same CSV rows (scores printed to 3 decimals, so they may differ
by one unit in the last digit) and the same REST vector ids. A subprocess
runs the port's path alone and shows that it never imports jax or flax, the
caption tokenizer's hash fallback included.
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
import wave
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
FID = "microsoft/clap/tiny/slice"
QUERIES = ["a dog barking", "rain on a window", "violin"]
#: the tiny towers of tests/test_torch_clap.py, with a vocabulary large
#: enough for the hash tokenizer's ids ([1000, vocab - 1000))
TINY = dict(joint_dim=32, duration=0.5, spec_frames=64, freq_ratio=2,
            n_mels=16, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
            window_size=4, vocab_size=4096, context_length=12,
            text_width=128, text_heads=2, text_layers=2)


def _write_wav(path, seconds, seed, rate=48_000):
    """A seeded mix of a tone, a chirp and noise, 16-bit mono."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    f0, f1 = rng.uniform(100, 4000, 2)
    sig = (0.3 * np.sin(2 * np.pi * f0 * t)
           + 0.2 * np.sin(2 * np.pi * (f1 + 300 * t) * t)
           + 0.05 * rng.standard_normal(len(t)))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype(np.int16)
                      .tobytes())


def _register_tiny(mp):
    """The tiny config as CLAP version "tiny" in both packages."""
    import dataclasses

    from wise_tpu.models.clap import model as JM
    from wise_tpu_torch.models.clap import config as TC

    mp.setitem(JM.CLAP_CONFIGS, "tiny",
               dataclasses.replace(JM.CLAPConfig(), **TINY))
    mp.setitem(TC.CLAP_CONFIGS, "tiny",
               dataclasses.replace(TC.CLAPConfig(), **TINY))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """WAV media, the msclap checkpoint, and the environment both drives
    run under (f32 towers, the tiny config registered)."""
    import torch

    from tests.test_clap_convert import _fake_msclap_sd
    from wise_tpu_torch.models.clap.config import CLAPConfig

    root = tmp_path_factory.mktemp("audio_slice")
    media = root / "media"
    media.mkdir()
    for i, seconds in enumerate([8.0, 12.0, 4.5, 8.0]):
        _write_wav(media / f"a{i}.wav", seconds, seed=i)
    # the converter's keyset, with matrices at 1/sqrt(fan_in) and norm
    # scales near 1, so that the random towers separate the segments
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in _fake_msclap_sd(CLAPConfig(**TINY)).items():
        v, shape = np.asarray(v, np.float32), np.shape(v)
        if len(shape) >= 2 and "wte" not in k and "wpe" not in k:
            v = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
        elif len(shape) == 1 and k.endswith(".weight"):
            v = 1.0 + 0.02 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(np.asarray(v, np.float32))
    ckpt = root / "ckpts" / "clap" / "tiny" / "slice"
    ckpt.mkdir(parents=True)
    torch.save(sd, ckpt / "clap.pth")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WISE_CHECKPOINT_DIR", str(root / "ckpts"))
        mp.setenv("WISE_CLAP_DTYPE", "float32")
        mp.setenv("WISE_TORCH_DEVICE", "cpu")
        _register_tiny(mp)
        yield root


def _rest(create_server, project_dir, query, k=5):
    server = create_server(project_dir, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = (f"http://127.0.0.1:{server.server_address[1]}/"
               f"{Path(project_dir).name}/search?search_in=audio&end={k}&q="
               + urllib.parse.quote(query))
        with urllib.request.urlopen(url, timeout=120) as r:
            assert r.status == 200
            resp = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    wins = sorted(resp["audio_results"]["unmerged_windows"],
                  key=lambda w: (-w["distance"], int(w["vector_id"])))
    return [int(w["vector_id"]) for w in wins], [w["distance"] for w in wins]


def _drive(pkg, root):
    """extract -> create-index -> search CLI (CSV) -> REST with ``pkg``."""
    def cli(name):
        return importlib.import_module(f"{pkg}.cli.{name}").main

    proj = root / pkg
    assert cli("extract_features")([
        str(root / "media"), "--project-dir", str(proj),
        "--audio-feature-id", FID, "--batch-size", "32"]) == 0
    assert cli("create_index")(["--project-dir", str(proj)]) == 0
    out = {}
    for i, q in enumerate(QUERIES):
        csv_path = root / f"{pkg}-{i}.csv"
        assert cli("search")([
            "--project-dir", str(proj), "--query", q, "--in", "audio",
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


def test_extractors_match_jax(env):
    """The two ClapExtractors on the same 48 kHz segments (resample, tile
    to the model's duration, log-mel, towers) and captions: 2e-4 abs, the
    f32 torch-parity bar; batch sizes 1 and 3 (bucket 4) agree too."""
    from wise_tpu.models.clap.extractor import ClapExtractor as JE
    from wise_tpu_torch.models.clap.extractor import ClapExtractor as TE

    je, te = JE(FID), TE(FID)
    rng = np.random.default_rng(3)
    wav = (0.3 * rng.standard_normal((3, 48_000 * 4))).astype(np.float32)
    want = je.extract_audio_features(wav)
    got = te.extract_audio_features(wav)
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(te.extract_audio_features(wav[1]), got[1:2],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(te.extract_text_features(QUERIES),
                               je.extract_text_features(QUERIES), atol=2e-4,
                               rtol=0)


def test_port_audio_path_never_imports_jax(env):
    """audio extract -> index -> search CLI -> REST ``search_in=audio``
    through the port in a fresh interpreter: jax, flax and the JAX package
    stay out of sys.modules, through the caption tokenizer's hash fallback too."""
    script = textwrap.dedent(f"""
        import dataclasses, json, sys
        from wise_tpu_torch.models.clap import config as TC
        TC.CLAP_CONFIGS["tiny"] = dataclasses.replace(TC.CLAPConfig(),
                                                      **{TINY!r})
        from wise_tpu_torch.cli import create_index, extract_features, search
        from wise_tpu_torch.api.server import create_server
        proj = {str(env / "nojax")!r}
        assert extract_features.main([{str(env / "media")!r},
            "--project-dir", proj, "--audio-feature-id", {FID!r}]) == 0
        assert create_index.main(["--project-dir", proj]) == 0
        assert search.main(["--project-dir", proj, "--query", "rain",
                            "--in", "audio"]) == 0
        sys.path.insert(0, {str(ROOT / "tests")!r})
        from test_torch_audio_slice import _rest
        ids, _ = _rest(create_server, proj, "rain")
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

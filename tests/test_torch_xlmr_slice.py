"""The default backbone's serve path end to end, the port against the JAX
package: an OpenCLIP vision tower with the XLM-RoBERTa text tower.

Both packages drive the same media through their own extract-features ->
create-index -> search CLI -> REST server under the normal id
``mlfoundations/open_clip/xlm-roberta-large-ViT-H-14/frozen_laion5b_s13b_b90k``.
For this test only, that registry entry is replaced in both packages by a
tiny configuration of the same kind (``text_tower="hf_xlm_roberta"``, the
"mlp" projection head, a 4,096-token vocabulary so that the hash tokenizer's
ids fit), and both load one seeded open_clip-keyed ``.npz`` (``visual.*`` and
the HF ``text.transformer.*`` keys) from a temporary WISE_CHECKPOINT_DIR. In
f32 the towers agree to ~1e-6, so the searches return the same CSV rows
(scores to 3 decimals) and the same REST vector ids. A subprocess runs the
port's path alone and shows that it never imports jax or flax.
"""

import csv
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from tests.media_fixtures import make_image, make_video
from tests.test_torch_slice import _rest, native_decoders_ready

ROOT = Path(__file__).resolve().parents[1]
MODEL = "xlm-roberta-large-ViT-H-14"
FID = f"mlfoundations/open_clip/{MODEL}/frozen_laion5b_s13b_b90k"
QUERIES = ["red", "un chien dans la neige", "green light"]
TINY = dict(embed_dim=32, image_size=32, patch_size=16, vision_width=64,
            vision_layers=2, vision_heads=4, context_length=16,
            vocab_size=4096, text_width=128, text_heads=2, text_layers=2)


def _hf_text_state_dict(rng, width, layers, vocab, embed_dim):
    """open_clip's HFTextEncoder keys for an XLM-R tower with the "mlp"
    head, N(0, 0.02) (LayerNorm weights around 1)."""
    sd, b = {}, "text.transformer"

    def w(name, *shape, mean=0.0):
        sd[name] = (mean + 0.02 * rng.standard_normal(shape)).astype(
            np.float32)

    w(f"{b}.embeddings.word_embeddings.weight", vocab, width)
    w(f"{b}.embeddings.position_embeddings.weight", 514, width)
    w(f"{b}.embeddings.LayerNorm.weight", width, mean=1.0)
    w(f"{b}.embeddings.LayerNorm.bias", width)
    for i in range(layers):
        lp = f"{b}.encoder.layer.{i}"
        for name, dout, din in (
                ("attention.self.query", width, width),
                ("attention.self.key", width, width),
                ("attention.self.value", width, width),
                ("attention.output.dense", width, width),
                ("intermediate.dense", 4 * width, width),
                ("output.dense", width, 4 * width)):
            w(f"{lp}.{name}.weight", dout, din)
            w(f"{lp}.{name}.bias", dout)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            w(f"{lp}.{name}.weight", width, mean=1.0)
            w(f"{lp}.{name}.bias", width)
    hidden = (width + embed_dim) // 2
    w("text.proj.0.weight", hidden, width)
    w("text.proj.2.weight", embed_dim, hidden)
    return sd


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Media, the checkpoint, the tiny registry entries and the environment
    both drives run under; both packages decode with their native FFmpeg
    decoders."""
    from tests.test_convert_published_keysets import openclip_clip_keyset
    from wise_tpu.models.clip import model as JM
    from wise_tpu_torch.models.clip import config as TC

    native_decoders_ready()
    root = tmp_path_factory.mktemp("xlmr_slice")
    media = root / "media"
    media.mkdir()
    make_video(media / "v1.mp4", seconds=6, fps=10)
    make_video(media / "v2.mp4", seconds=4, fps=10)
    make_image(media / "i1.png", value=50)
    make_image(media / "i2.png", value=200)
    rng = np.random.default_rng(0)
    vision_like = dataclasses.replace(JM.get_clip_config("ViT-Test-Tiny"),
                                      **TINY)
    sd = {k: rng.normal(0.0, 0.02, np.shape(v)).astype(np.float32)
          for k, v in openclip_clip_keyset(vision_like).items()
          if k.startswith("visual.") or k == "logit_scale"}
    sd.update(_hf_text_state_dict(rng, TINY["text_width"],
                                  TINY["text_layers"], TINY["vocab_size"],
                                  TINY["embed_dim"]))
    ckpt = root / "ckpts" / MODEL / "frozen_laion5b_s13b_b90k"
    ckpt.mkdir(parents=True)
    np.savez(ckpt / "open_clip_model.npz", **sd)
    with pytest.MonkeyPatch.context() as mp:
        for registry in (JM.CLIP_CONFIGS, TC.CLIP_CONFIGS):
            mp.setitem(registry, MODEL,
                       dataclasses.replace(registry[MODEL], **TINY))
        mp.setenv("WISE_CHECKPOINT_DIR", str(root / "ckpts"))
        mp.setenv("WISE_CLIP_DTYPE", "float32")
        mp.setenv("WISE_TORCH_DEVICE", "cpu")
        yield root


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
    server = importlib.import_module(f"{pkg}.api.server")
    for i, q in enumerate(QUERIES):
        csv_path = root / f"{pkg}-{i}.csv"
        assert cli("search")([
            "--project-dir", str(proj), "--query", q, "--in", "video",
            "--topk", "5", "--result-format", "csv",
            "--save-to-file", str(csv_path)]) == 0
        with open(csv_path) as f:
            rows = list(csv.reader(f))
        out[q] = rows, _rest(server.create_server, proj, q)
    return out


@pytest.fixture(scope="module")
def drives(env):
    return _drive("wise_tpu", env), _drive("wise_tpu_torch", env)


def test_the_extractor_builds_the_hf_tower_with_roberta_padding(env):
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.models.clip.hf_text import XLMRobertaTextTower

    fe = OpenClipExtractor(FID)
    assert isinstance(fe.model.text, XLMRobertaTextTower)
    assert fe.tokenizer.pad_id == 1 and fe.tokenizer.vocab_size == 4096
    toks = fe.tokenizer(["a dog"])
    assert toks.shape == (1, 16) and (toks[0, 4:] == 1).all()
    one = fe.extract_text_features(["a dog"])
    three = fe.extract_text_features(["a dog", "a cat", "rain"])  # bucket 4
    assert one.shape == (1, 32) and three.shape == (3, 32)
    np.testing.assert_allclose(np.linalg.norm(three, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(three[0], one[0], atol=1e-5)


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
    """extract -> index -> search -> REST through the port with the HF text
    tower in a fresh interpreter: jax, flax and the JAX package stay out of
    sys.modules."""
    script = textwrap.dedent(f"""
        import dataclasses, json, sys
        from wise_tpu_torch.models.clip import config as TC
        TC.CLIP_CONFIGS[{MODEL!r}] = dataclasses.replace(
            TC.CLIP_CONFIGS[{MODEL!r}], **{TINY!r})
        from wise_tpu_torch.cli import create_index, extract_features, search
        from wise_tpu_torch.api.server import create_server
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

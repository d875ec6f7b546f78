"""wise_tpu_torch stands alone: it imports torch and numpy, never jax or
flax, and nothing of the JAX package ``wise_tpu``; and its entry points run
on the card unless the caller asks for the CPU.

(a) an ``ast`` walk over every source of the port finds no such import and
    no module loaded from a file path;
(b) a fresh interpreter runs the port's extract -> create-index -> search
    and ends with none of those packages loaded;
(c) ``default_device()`` raises without a card unless ``WISE_TORCH_DEVICE``
    names the CPU, and so do the extractors, the index and the CLIs;
(d) each copied host module still holds what its origin holds: the same
    public names, so a reader finds every counterpart.
"""

import ast
import importlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "wise_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("wise_tpu", "jax", "flax")
#: the host modules the port copied from the JAX package, path for path
COPIED = """config data_models utils project db db.repository store
store.feature_store store.factory store.npz_store store.tar_store io
io.decode io.dataset io.native_decoder search search.query_parser
search.results index.format index.search_index index.fts_index
models.feature_extractor models.random_features models.clip.tokenizer
models.clip.convert models.clap.tokenizer models.clap.convert
pipeline.extract api.models api.coalesce api.engine api.server
cli.extract_features cli.create_index cli.search cli.serve""".split()


def _rel(path):
    return str(path.relative_to(ROOT))


def _named(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=_rel)
def test_source_imports_nothing_of_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _named(a.name)]
            assert not bad, f"{_rel(path)}:{node.lineno} imports {bad}"
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _named(node.module or ""), (
                f"{_rel(path)}:{node.lineno} imports from {node.module}")
        elif isinstance(node, ast.Attribute):
            assert node.attr != "spec_from_file_location", (
                f"{_rel(path)}:{node.lineno} loads a module by file path")
        elif isinstance(node, ast.Call):
            # importlib.import_module("wise_tpu...") / __import__("jax")
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                assert not (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str)
                            and _named(arg.value)), (
                    f"{_rel(path)}:{node.lineno} imports {arg.value}")


def test_host_module_is_gone():
    assert not (PORT / "_host.py").exists()
    assert not any("rebind" in p.read_text() for p in SOURCES)


def test_port_main_path_loads_nothing_of_the_jax_package(tmp_path):
    """extract -> create-index -> search with the random-features extractor
    in a fresh interpreter: no ``wise_tpu``, ``jax`` or ``flax`` module in
    sys.modules afterwards."""
    from tests.media_fixtures import make_image, make_video

    media = tmp_path / "media"
    media.mkdir()
    make_video(media / "v1.mp4", seconds=4, fps=10)
    make_image(media / "i1.png", value=50)
    fid = "wise/random_features/64/selfcontained"
    script = textwrap.dedent(f"""
        import json, sys
        from wise_tpu_torch.cli import create_index, extract_features, search
        proj = {str(tmp_path / "proj")!r}
        assert extract_features.main([{str(media)!r}, "--project-dir", proj,
            "--video-feature-id", {fid!r}, "--image-feature-id", {fid!r},
            "--batch-size", "8"]) == 0
        assert create_index.main(["--project-dir", proj]) == 0
        assert search.main(["--project-dir", proj, "--query", "red",
                            "--in", "video"]) == 0
        loaded = sorted(k for k in sys.modules if k.split(".")[0]
                        in ("wise_tpu", "jax", "jaxlib", "flax"))
        print(json.dumps(loaded))
    """)
    run = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             "WISE_TORCH_DEVICE": "cpu"},
    )
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == []


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(monkeypatch):
    from wise_tpu_torch.utils.device import default_device

    _no_card(monkeypatch)
    monkeypatch.delenv("WISE_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="WISE_TORCH_DEVICE=cpu"):
        default_device()
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    assert default_device() == torch.device("cpu")
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cuda:0")
    with pytest.raises(RuntimeError, match="is_available"):
        default_device()
    monkeypatch.setenv("WISE_TORCH_DEVICE", "tpu")
    with pytest.raises((RuntimeError, ValueError)):
        default_device()


def test_default_device_prefers_the_card(monkeypatch):
    from wise_tpu_torch.utils.device import default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("WISE_TORCH_DEVICE", raising=False)
    assert default_device() == torch.device("cuda")
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cuda:1")
    assert default_device() == torch.device("cuda", 1)
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    assert default_device() == torch.device("cpu")


@pytest.mark.parametrize("entry", ["clip", "clap", "index", "cli"])
def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch, tmp_path,
                                                  entry):
    """Without a card and without the variable, the extractors, the index
    and the extract CLI raise instead of running on the CPU; an explicit
    ``device=`` still works."""
    _no_card(monkeypatch)
    monkeypatch.delenv("WISE_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("WISE_CHECKPOINT_DIR", str(tmp_path / "none"))
    tiny = "mlfoundations/open_clip/ViT-Test-Tiny/x"
    if entry == "clip":
        from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

        with pytest.raises(RuntimeError, match="WISE_TORCH_DEVICE"):
            OpenClipExtractor(tiny)
        assert OpenClipExtractor(tiny, device="cpu").device.type == "cpu"
    elif entry == "clap":
        from wise_tpu_torch.models.clap.extractor import ClapExtractor

        with pytest.raises(RuntimeError, match="WISE_TORCH_DEVICE"):
            ClapExtractor("microsoft/clap/2023/x")
    elif entry == "index":
        from wise_tpu_torch.index.feature_index import FeatureSearchIndex

        asset = {"index_dir": str(tmp_path), "features_dir": str(tmp_path)}
        with pytest.raises(RuntimeError, match="WISE_TORCH_DEVICE"):
            FeatureSearchIndex("video", tiny, asset)
        index = FeatureSearchIndex("video", tiny, asset, device="cpu")
        assert index.device.type == "cpu"
    else:
        from tests.media_fixtures import make_image
        from wise_tpu_torch.cli import extract_features

        media = tmp_path / "media"
        media.mkdir()
        make_image(media / "i1.png", value=50)
        with pytest.raises(RuntimeError, match="WISE_TORCH_DEVICE"):
            extract_features.main([
                str(media), "--project-dir", str(tmp_path / "proj"),
                "--image-feature-id", tiny, "--video-feature-id", tiny])


@pytest.mark.parametrize("module", COPIED)
def test_copy_keeps_its_origins_names(module):
    """A copied host module names its origin in its docstring and defines
    every public function and class its origin defines."""
    ref_path = ROOT / "wise_tpu" / Path(*module.split("."))
    ref_file = (ref_path / "__init__.py" if ref_path.is_dir()
                else ref_path.with_suffix(".py"))
    port = importlib.import_module(f"wise_tpu_torch.{module}")
    assert f"wise_tpu/{ref_file.relative_to(ROOT / 'wise_tpu')}" in (
        port.__doc__ or ""), f"{module}: docstring does not name its origin"
    tree = ast.parse(ref_file.read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and not n.name.startswith("_")]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{module}: lacks {missing} of {ref_file.name}"


def test_native_decoder_builds_apart_from_the_reference():
    """The port's decoder library lands under build/native, never beside
    either package's sources."""
    from wise_tpu_torch.io import native_decoder

    lib = native_decoder.library_path()
    assert lib.parent == ROOT / "build" / "native"
    assert lib.name.startswith("libwisedecoder_") and lib.suffix == ".so"
    assert (PORT / "native" / "decoder.cpp").read_bytes() != b""
    assert not list((PORT / "native").glob("*.so"))

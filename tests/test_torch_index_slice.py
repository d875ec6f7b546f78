"""The port's index and query leg as a whole, on the CPU, against the JAX
package's on the same feature store.

One project is extracted once (the numpy fake extractor
``wise/random_features/32``, identical in both packages) and copied, so both
packages index the same store. Each then runs its own ``create-index`` CLI
for IndexFlatIP, IndexIVFFlat and IndexIVFPQ, its ``search`` CLI (CSV) for
the three index types and for the storage types and the approximate scan the
port serves, and its engine through the REST server.

Tolerance: the result rows (file, times, vector ids' order) must be equal;
scores are printed to 3 decimals and may differ by one unit in the last
digit (f32 sums in another order). The approximate scan is exact in the JAX
package on the CPU and bucketed in the port, so there the port is held to
recall >= 0.9 of the JAX rows, not to equality.
"""

import csv
import importlib
import shutil

import pytest

from tests.media_fixtures import make_video
from tests.test_torch_slice import _rest

FID = "wise/random_features/32/indexslice"
QUERIES = ["skiing", "a dog in the snow"]
VARIANTS = {
    "flat": ["--index-type", "IndexFlatIP"],
    "flat-bf16": ["--index-type", "IndexFlatIP", "--storage-dtype",
                  "bfloat16"],
    "flat-int8": ["--index-type", "IndexFlatIP", "--storage-dtype", "int8"],
    "ivf": ["--index-type", "IndexIVFFlat"],
    "ivfpq": ["--index-type", "IndexIVFPQ"],
}


def _cli(pkg, name):
    return importlib.import_module(f"{pkg}.cli.{name}").main


def _search(pkg, proj, root, query, tag, extra, k=10):
    csv_path = root / f"{pkg}-{tag}-{abs(hash(query))}.csv"
    assert _cli(pkg, "search")([
        "--project-dir", str(proj), "--query", query, "--in", "video",
        "--topk", str(k), "--no-merge", "--result-format", "csv",
        "--save-to-file", str(csv_path), *extra]) == 0
    with open(csv_path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """{package: project dir} over one extracted store, the three index
    types built by each package's own create-index CLI."""
    root = tmp_path_factory.mktemp("indexslice")
    media = root / "media"
    media.mkdir()
    for i in range(4):
        make_video(media / f"v{i}.mp4", seconds=8, fps=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WISE_TORCH_DEVICE", "cpu")
        seed = root / "seed"
        assert _cli("wise_tpu_torch", "extract_features")([
            str(media), "--project-dir", str(seed),
            "--video-feature-id", FID, "--image-feature-id", FID,
            "--audio-feature-id", FID]) == 0
        out = {"root": root}
        for pkg in ("wise_tpu", "wise_tpu_torch"):
            proj = root / pkg / "proj"
            shutil.copytree(seed, proj)
            for index_type in ("IndexFlatIP", "IndexIVFFlat", "IndexIVFPQ"):
                assert _cli(pkg, "create_index")([
                    "--project-dir", str(proj), "--index-type", index_type,
                    "--media-type", "video"]) == 0
            out[pkg] = proj
        yield out


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_search_cli_matches_jax(projects, variant, query):
    root = projects["root"]
    want, got = (_search(pkg, projects[pkg], root, query, variant,
                         VARIANTS[variant])
                 for pkg in ("wise_tpu", "wise_tpu_torch"))
    assert len(got) == len(want) == 11
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g[-1]) - float(w[-1])) <= 1.001e-3


def test_ivf_full_probe_equals_flat(projects):
    """nprobe (1024) exceeds nlist here, so IVF-Flat is the exact search."""
    root, proj = projects["root"], projects["wise_tpu_torch"]
    flat = _search("wise_tpu_torch", proj, root, "skiing", "f",
                   VARIANTS["flat"])
    ivf = _search("wise_tpu_torch", proj, root, "skiing", "i",
                  VARIANTS["ivf"])
    assert sorted(flat) == sorted(ivf)


def test_approx_search_cli_recall(projects):
    root = projects["root"]
    extra = ["--index-type", "IndexFlatIP", "--flat-approx-recall", "0.9"]
    hits = total = 0
    for query in QUERIES + ["red", "a city at night"]:
        want, got = (_search(pkg, projects[pkg], root, query, "approx",
                             extra, k=5)
                     for pkg in ("wise_tpu", "wise_tpu_torch"))
        assert len(got) == len(want) == 6
        hits += len({tuple(r[:-1]) for r in got[1:]}
                    & {tuple(r[:-1]) for r in want[1:]})
        total += 5
    assert hits / total >= 0.9


@pytest.mark.parametrize("index_type", ["IndexFlatIP", "IndexIVFFlat",
                                        "IndexIVFPQ"])
def test_rest_matches_jax(projects, index_type):
    out = {}
    for pkg in ("wise_tpu", "wise_tpu_torch"):
        create = importlib.import_module(f"{pkg}.api.server").create_server

        def server(project_dir, host, port, create=create):
            return create(project_dir, host, port, index_type=index_type)

        out[pkg] = _rest(server, projects[pkg], "skiing", k=8)
    assert len(out["wise_tpu_torch"][0]) == 8
    assert out["wise_tpu_torch"][0] == out["wise_tpu"][0]
    for g, w in zip(out["wise_tpu_torch"][1], out["wise_tpu"][1]):
        assert abs(g - w) <= 1.001e-3

"""The operation counts and bounds against hand counts at the published
shapes, and the copies against their originals."""

from __future__ import annotations

import json
import sys

import pytest

from conftest import ROOT

from h100bench import flops


def shapes(config):
    return json.loads((ROOT / "h100bench" / "configs"
                       / f"{config}.json").read_text())["shapes"]


def test_vit_h_forward_by_hand():
    v = shapes("xlmr-vith14")["vision"]
    sp, d, f = 257, 1280, 5120
    layer = 2 * sp * (3 * d * d + d * d + 2 * d * f) + 4 * sp * sp * d
    pooled = 2 * sp * d * 2 * d + 2 * d * d * 2 + 4 * sp * d + 4 * d * f
    patch = 2 * 256 * (14 * 14 * 3) * d
    want = 31 * layer + pooled + patch + 2 * d * 1024
    assert flops.vision_forward_ops(v) == want
    # ~334 GFLOP a frame with the last layer whole, as PERF.md counted it
    assert 325e9 < want < 327e9
    assert 333e9 < 32 * layer < 336e9


def test_siglip_384_forward_by_hand():
    v = shapes("siglip-l16-384")["vision"]
    sp, d, f = 576, 1024, 4096
    layer = 2 * sp * (4 * d * d + 2 * d * f) + 4 * sp * sp * d
    head = 2 * d * d + 2 * sp * d * 2 * d + 4 * sp * d + 2 * d * d + 4 * d * f
    patch = 2 * sp * (16 * 16 * 3) * d
    assert flops.vision_forward_ops(v) == 24 * layer + head + patch


def test_xlmr_forward_by_hand():
    t = shapes("xlmr-vith14")["text"]
    n, d, f = 64, 1024, 4096
    layer = 2 * n * (4 * d * d + 2 * d * f) + 4 * n * n * d
    assert flops.text_forward_ops(t, 64) == 24 * layer + 2 * 2 * d * d
    assert flops.text_forward_ops(t, 64) == 39_061_553_152


def test_block_gemm_bound_by_hand():
    """ViT-H at batch 256: 31 whole layers and the pooled one's k and v,
    bound by their operations at 989 TFLOP/s; the pooled row's q and
    out-proj (256 rows) by their bytes at 3.35 TB/s."""
    v = shapes("xlmr-vith14")["vision"]
    m, b, d, f = 256 * 257, 256, 1280, 5120
    ops = 31 * 2 * m * (4 * d * d + 2 * d * f) + 2 * m * d * 2 * d
    rows = (2 * b * d + 2 * d * d + 2 * b * d) + (2 * b * d + 2 * d * d
                                                   + 4 * b * d)
    got = flops.product_ms(flops.vision_products(v, 256))
    assert got == pytest.approx(1e3 * (ops / 989e12 + rows / 3.35e12),
                                rel=1e-9)


def test_attention_bound_by_hand():
    """ViT-H at batch 256: each whole layer bound by its bytes (q, k, v and
    out in bf16), the pooled row by its bytes too."""
    v = shapes("xlmr-vith14")["vision"]
    b, sp, d = 256, 257, 1280
    whole = max(4 * b * sp * sp * d / 989e12, 8 * b * sp * d / 3.35e12)
    pooled = max(4 * b * sp * d / 989e12,
                 (4 * b * sp * d + 4 * b * d) / 3.35e12)
    got = flops.work_ms(flops.vision_attention(v, 256))
    assert got == pytest.approx(1e3 * (31 * whole + pooled), rel=1e-9)
    assert 8 * b * sp * d / 3.35e12 > 4 * b * sp * sp * d / 989e12


@pytest.mark.parametrize("args", [
    (256, 257, 1280, 4, 257), (8, 77, 512, 2, 39.0), (256, 50, 768, 4, 50)])
def test_copies_match_chip_smoke(args):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    b, sp, d, xb, keys = args
    assert flops.attn_work(*args) == chip_smoke._attn_work(*args)
    assert (flops.attn_work(*args, pooled=True)
            == chip_smoke._attn_work(*args, pooled=True))
    for half in (None, "fc", "proj"):
        assert (flops.mlp_work(b * sp, d, 4 * d, xb, half)
                == chip_smoke._mlp_work(b * sp, d, 4 * d, xb, half))
    assert flops.bound(1e12, 1e9) == chip_smoke._bound(1e12, 1e9)
    assert flops.bound(1e9, 1e12) == chip_smoke._bound(1e9, 1e12)


def test_train_work_matches_train_bounds():
    sys.path.insert(0, str(ROOT / "scripts"))
    import train_bounds

    for row in train_bounds.ROWS.values():
        assert flops.train_work(*row) == train_bounds.work(*row)

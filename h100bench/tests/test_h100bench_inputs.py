"""The inputs and weights repeat by seed and differ across seeds."""

from __future__ import annotations

import numpy as np
import torch

from h100bench import frames, weights

SEED = 2_900_000_017


def test_frames_repeat_by_seed():
    a, b = frames.frames(SEED, 6, 40), frames.frames(SEED, 6, 40)
    assert a.dtype == np.uint8 and a.shape == (6, 40, 40, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, frames.frames(SEED + 1, 6, 40))


def test_captions_repeat_by_seed_and_every_row_differs():
    a = frames.captions(SEED, 64, 64, 250002, (8, 48), 1)
    np.testing.assert_array_equal(a, frames.captions(SEED, 64, 64, 250002,
                                                     (8, 48), 1))
    assert len({tuple(r) for r in a}) == 64
    lengths = (a != 1).sum(axis=1)
    assert lengths.min() >= 8 and lengths.max() <= 48
    assert (a[:, 0] == 250000).all()
    assert (a[np.arange(64), lengths - 1] == 250001).all()


def test_weights_repeat_by_seed():
    v = dict(image_size=32, patch_size=16, width=64, layers=2, heads=4,
             mlp_width=256, act="gelu", pool="cls", ln_eps=1e-5,
             embed_dim=32)
    spec = weights.vision_spec(v)
    a = weights.make(spec, SEED, "cpu", weights.served_dtype)
    b = weights.make(spec, SEED, "cpu", weights.served_dtype)
    c = weights.make(spec, SEED + 1, "cpu", weights.served_dtype)
    assert set(a) == {n for n, _, _ in spec}
    for n in a:
        assert torch.equal(a[n], b[n])
    assert not torch.equal(a["visual.proj"], c["visual.proj"])
    assert a["visual.ln_pre.scale"].dtype == torch.float32
    assert a["visual.proj"].dtype == torch.bfloat16

"""The benchmark's inputs, from the seed.

``frames`` is a copy of ``chip_smoke.py``'s ``_frames`` (seeded synthetic
frames: a coarse random 7x7 colour layout upsampled to the frame size, plus
pixel noise), unchanged but for its name. ``captions`` is this file's own.
"""

from __future__ import annotations

import numpy as np


def frames(seed: int, n: int, size: int) -> np.ndarray:
    """Seeded synthetic frames: a coarse random 7x7 colour layout upsampled
    to the frame size, plus pixel noise. (n, size, size, 3) uint8."""
    rng = np.random.default_rng(seed)
    cell = -(-size // 7)
    base = rng.integers(0, 256, (n, 7, 7, 3), dtype=np.int16)
    img = np.repeat(np.repeat(base, cell, 1), cell, 2)[:, :size, :size]
    img = img + rng.integers(-20, 21, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def captions(seed: int, n: int, context: int, vocab: int, lengths,
             pad_id: int) -> np.ndarray:
    """n seeded token rows of ``context`` ids, as the train CLI's captions
    reach the XLM-R tower: a start id (vocab - 2), words drawn from
    [1000, vocab - 2000), an end id (vocab - 1), then ``pad_id``. Each
    row's length, start and end included, is drawn from ``lengths``
    (lo, hi) inclusive. Every row differs (its words are drawn
    independently; the first word is also the row's own index offset)."""
    rng = np.random.default_rng(seed)
    lo, hi = lengths
    if not 3 <= lo <= hi <= context:
        raise ValueError(f"caption lengths {lengths} outside [3, {context}]")
    out = np.full((n, context), pad_id, dtype=np.int64)
    sizes = rng.integers(lo, hi + 1, n)
    words = rng.integers(1000, vocab - 2000, (n, context))
    for i, size in enumerate(sizes):
        out[i, 0] = vocab - 2
        out[i, 1:size - 1] = words[i, :size - 2]
        out[i, 1] = 1000 + (words[i, 0] - 1000 + i) % (vocab - 3000)
        out[i, size - 1] = vocab - 1
    return out

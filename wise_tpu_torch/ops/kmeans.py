"""K-means (Lloyd) in PyTorch: the IVF coarse quantizer's training
(wise_tpu/ops/kmeans.py).

Assignment is a blocked matmul; the centroid update is an ``index_add_``;
empty clusters are re-seeded from the largest cluster's points. The initial
centroids and the re-seeds are drawn with ``np.random.default_rng(seed)`` as
in the reference, so the same seed starts from the same centroids. Plain
torch ops: the reference leaves this to XLA.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import default_device


def _assign(x, centroids, block: int = 8192):
    """x (N, D), centroids (K, D) tensors on one device -> assignments (N,)
    int64. Nearest by L2 == argmax(2 x.c - |c|^2) for fixed x; ``argmax``
    returns the first maximal index."""
    c = centroids.float()
    c_sq = (c ** 2).sum(dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], block):
        scores = 2.0 * (x[lo:lo + block].float() @ c.T) - c_sq[None, :]
        out[lo:lo + block] = torch.argmax(scores, dim=1)
    return out


def _update(x, assign, k: int):
    x = x.float()
    sums = torch.zeros((k, x.shape[1]), device=x.device).index_add_(
        0, assign, x)
    counts = torch.bincount(assign, minlength=k).float()
    return sums / counts.clamp(min=1.0)[:, None], counts


def assign_cells(x: np.ndarray, centroids: np.ndarray,
                 device=None) -> np.ndarray:
    """Host convenience: nearest centroid of each row, (N,) int32."""
    device = torch.device(device) if device else default_device()
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    ct = torch.from_numpy(np.ascontiguousarray(centroids, dtype=np.float32))
    return _assign(xt.to(device), ct.to(device)).cpu().numpy().astype(
        np.int32)


def kmeans(x: np.ndarray, k: int, iters: int = 20, seed: int = 0,
           device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (centroids (k, D) float32, assignments (N,) int32)."""
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    if k >= n:
        # degenerate: every point its own centroid (pad by repeating)
        reps = -(-k // n)
        centroids = np.tile(x, (reps, 1))[:k]
        return centroids.astype(np.float32), _np_assign_final(x, centroids)
    device = torch.device(device) if device else default_device()
    rng = np.random.default_rng(seed)
    init_idx = rng.choice(n, size=k, replace=False)
    xt = torch.from_numpy(x).to(device)
    centroids = torch.from_numpy(x[init_idx]).to(device)
    for _ in range(iters):
        assign = _assign(xt, centroids)
        centroids, counts = _update(xt, assign, k)
        counts_np = counts.cpu().numpy()
        empty = np.where(counts_np == 0)[0]
        if len(empty):
            # re-seed empty clusters near points of the biggest cluster
            cent = centroids.cpu().numpy()
            big = int(np.argmax(counts_np))
            donors = np.where(assign.cpu().numpy() == big)[0]
            pick = rng.choice(donors, size=len(empty),
                              replace=len(donors) < len(empty))
            cent[empty] = x[pick] + rng.normal(scale=1e-4,
                                               size=(len(empty), d))
            centroids = torch.from_numpy(cent).to(device)
    assign = _assign(xt, centroids).cpu().numpy().astype(np.int32)
    return centroids.cpu().numpy().astype(np.float32), assign


def _np_assign_final(x, centroids):
    c_sq = np.sum(centroids**2, axis=1)
    scores = 2.0 * x @ centroids.T - c_sq[None, :]
    return np.argmax(scores, axis=1).astype(np.int32)

"""Product quantization (PQ) training and encoding, numpy over the port's
k-means.

Backs IndexIVFPQ. Vectors are split into M subspaces; each subspace gets a
256-entry k-means codebook trained on coarse-cell residuals; codes are uint8
(N, M), a 4*dim/M x compression. Search uses asymmetric distance computation
(ADC): per query an (M, 256) lookup table of subspace inner products, then
candidates score the sum of their table entries.

Copy of ``wise_tpu/ops/pq.py``, with its imports bound to wise_tpu_torch: the
codebooks' k-means is ``ops/kmeans.py`` (on ``device``, the card unless the
caller names another), the rest is the reference's numpy.
"""

from __future__ import annotations

import numpy as np

from .kmeans import kmeans


def train_pq(
    residuals: np.ndarray, m: int, ksub: int = 256, iters: int = 15,
    seed: int = 0, device=None,
) -> np.ndarray:
    """residuals (N, D) -> codebooks (M, ksub, D/M) float32."""
    n, d = residuals.shape
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by M={m}")
    dsub = d // m
    codebooks = np.zeros((m, ksub, dsub), dtype=np.float32)
    for i in range(m):
        sub = residuals[:, i * dsub : (i + 1) * dsub]
        cb, _ = kmeans(sub, min(ksub, n), iters=iters, seed=seed + i,
                       device=device)
        codebooks[i, : cb.shape[0]] = cb[:ksub]  # zero-pad degenerate books
    return codebooks


def encode_pq(residuals: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """-> codes (N, M) uint8 (nearest codebook entry per subspace, L2)."""
    n, d = residuals.shape
    m, ksub, dsub = codebooks.shape
    if ksub > 256:
        # uint8 codes would wrap indices >= 256 and silently corrupt the
        # index; 8-bit books are the only storage format (.widx) supports
        raise ValueError(f"ksub={ksub} > 256 cannot encode as uint8 codes")
    codes = np.empty((n, m), dtype=np.uint8)
    for i in range(m):
        sub = residuals[:, i * dsub : (i + 1) * dsub]
        c = codebooks[i]
        # argmin ||x - c||^2 = argmax (2 x.c - |c|^2)
        scores = 2.0 * sub @ c.T - np.sum(c * c, axis=1)[None, :]
        codes[:, i] = np.argmax(scores, axis=1).astype(np.uint8)
    return codes


def decode_pq(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """codes (N, M) uint8 -> reconstructed residuals (N, D) float32."""
    m, ksub, dsub = codebooks.shape
    out = np.empty((codes.shape[0], m * dsub), np.float32)
    for i in range(m):
        out[:, i * dsub:(i + 1) * dsub] = codebooks[i][codes[:, i]]
    return out


def train_opq(
    residuals: np.ndarray, m: int, ksub: int = 256, iters: int = 15,
    opq_iters: int = 8, seed: int = 0, sample: int = 20000, device=None,
) -> tuple:
    """OPQ-NP (Ge et al., CVPR'13): learn an orthogonal rotation R that
    minimises PQ reconstruction error, alternating (a) PQ training on the
    rotated residuals with (b) the orthogonal-Procrustes solve
    R = U V^T of X^T Y = U S V^T against the reconstructions Y.

    A random spectrum rotation mixes every effective dimension into every
    subvector; the learned rotation re-concentrates variance per subspace.
    Because R is orthogonal, inner products are preserved: the caller
    stores centroids @ R and rotates queries once (q @ R), and every
    downstream op is unchanged.

    Returns (R (D, D) float32, codebooks (M, ksub, D/M) float32) with
    codebooks trained on residuals @ R."""
    n, d = residuals.shape
    rng = np.random.default_rng(seed)
    X = (residuals[rng.permutation(n)[:sample]]
         if n > sample else residuals).astype(np.float32)
    R = np.eye(d, dtype=np.float32)
    for _ in range(opq_iters):
        Xr = X @ R
        books = train_pq(Xr, m, ksub, iters=4, seed=seed, device=device)
        recon = decode_pq(encode_pq(Xr, books), books)
        u, _, vt = np.linalg.svd(
            X.T.astype(np.float64) @ recon.astype(np.float64)
        )
        R = (u @ vt).astype(np.float32)
    books = train_pq(residuals @ R, m, ksub, iters=iters, seed=seed,
                     device=device)
    return R, books


def adc_tables(query: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """query (D,) -> (M, ksub) inner-product lookup tables."""
    m, ksub, dsub = codebooks.shape
    q = query.reshape(m, dsub)
    return np.einsum("md,mkd->mk", q, codebooks).astype(np.float32)


def adc_scores(codes: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """codes (N, M) uint8, tables (M, ksub) -> (N,) summed IP scores."""
    n, m = codes.shape
    out = np.zeros(n, dtype=np.float32)
    for i in range(m):
        out += tables[i][codes[:, i]]
    return out

"""Sinkhorn-Knopp normalization to doubly-stochastic form (numpy).

BvN decomposition needs a doubly stochastic matrix, and MoE traffic is
sparse and skewed, so it is normalized first (paper §3.1): rows and
columns that are entirely zero get uniform mass, a small epsilon is added
everywhere (total support), then rows and columns are normalized in turn
until the largest row/column-sum error is below ``tol``.  The
normalization distorts per-pair demand, one of the two failure modes the
paper attributes to BvN.  Counterpart of ``repro/core/sinkhorn.py``: the
same operations in the same order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sinkhorn", "is_doubly_stochastic"]


def sinkhorn(
    matrix: np.ndarray,
    *,
    tol: float = 1e-9,
    max_iters: int = 200_000,
    eps: float = 1e-8,
) -> np.ndarray:
    """Normalize a nonnegative square matrix to doubly-stochastic form."""
    a = np.asarray(matrix, dtype=np.float64)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected square matrix, got shape {a.shape}")
    if (a < 0).any():
        raise ValueError("traffic matrix must be nonnegative")
    n = a.shape[0]
    a = a.copy()
    row_zero = a.sum(axis=1) == 0
    col_zero = a.sum(axis=0) == 0
    if row_zero.any():
        a[row_zero, :] = 1.0 / n
    if col_zero.any():
        a[:, col_zero] = 1.0 / n
    a = a + eps * a.sum() / (n * n)

    for _ in range(max_iters):
        a /= a.sum(axis=1, keepdims=True)
        a /= a.sum(axis=0, keepdims=True)
        err = max(
            np.abs(a.sum(axis=1) - 1.0).max(),
            np.abs(a.sum(axis=0) - 1.0).max(),
        )
        if err < tol:
            break
    return a


def is_doubly_stochastic(matrix: np.ndarray, *, tol: float = 1e-6) -> bool:
    a = np.asarray(matrix, dtype=np.float64)
    if a.ndim != 2 or a.shape[0] != a.shape[1] or (a < -tol).any():
        return False
    return bool(
        np.abs(a.sum(axis=1) - 1.0).max() < tol
        and np.abs(a.sum(axis=0) - 1.0).max() < tol
    )

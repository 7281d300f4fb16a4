"""Unified decomposition API (``maxweight`` and ``shift`` strategies).

``decompose(matrix, strategy)`` removes the diagonal (rank-local tokens
never ride a circuit), decomposes the rest and returns the diagonal in
``meta["local_tokens"]``.  Counterpart of ``repro/core/decompose.py``;
the BvN strategies and link masks come with later slices.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.maxweight import maxweight_decompose
from repro_torch.core.types import Decomposition, StackedPhases

__all__ = ["decompose", "STRATEGIES"]

STRATEGIES = ("maxweight", "shift")


def _shift_decompose(matrix: np.ndarray) -> Decomposition:
    """Static shifted ring: phase k sends i -> (i+k) mod n, n-1 phases."""
    a = np.asarray(matrix, dtype=np.float64)
    n = a.shape[0]
    idx = np.arange(n)
    perms = (idx[None, :] + np.arange(1, n)[:, None]) % n  # [n-1, n]
    sent = a[idx[None, :], perms].copy() if n > 1 else np.zeros((0, n))
    stacked = StackedPhases(perms=perms, alloc=sent.copy(), sent=sent)
    d = Decomposition(matrix=a, phases=stacked.to_phases(), strategy="shift", meta={})
    d._stacked_cache = stacked
    return d


def decompose(matrix: np.ndarray, strategy: str, **kwargs) -> Decomposition:
    """Decompose a traffic matrix with ``strategy`` (see module doc);
    ``kwargs`` go to the strategy (``min_fill`` for max-weight)."""
    a = np.asarray(matrix, dtype=np.float64).copy()
    local = np.diag(a).copy()
    np.fill_diagonal(a, 0.0)
    if strategy == "maxweight":
        d = maxweight_decompose(a, **kwargs)
    elif strategy == "shift":
        d = _shift_decompose(a)
    else:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    d.meta["local_tokens"] = local
    return d

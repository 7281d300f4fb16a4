"""Greedy max-weight decomposition (the paper's advocated strategy, §3.2).

Repeatedly take the maximum-weight perfect matching of the residual
traffic matrix (Jonker-Volgenant via ``scipy.optimize.linear_sum_assignment``)
and transfer the matched entries in full.  Same LAP sequence as the cold
path of ``repro/core/maxweight.py``; the warm start, link masks and the
batched auction backend belong to the host-controller slice.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from repro_torch.core.types import Decomposition, Phase, StackedPhases

__all__ = ["maxweight_decompose"]


def _greedy_phases(residual: np.ndarray, *, min_fill: float):
    """The greedy loop on ``residual`` (modified in place): returns the
    lists of (perm, sent) arrays and the count of pre-sweep phases."""
    n = residual.shape[0]
    idx = np.arange(n)
    perms: list[np.ndarray] = []
    sents: list[np.ndarray] = []
    hard_cap = int((residual > 0).sum()) + 1  # each phase clears >= 1 entry
    while residual.max() > 0 and len(perms) < hard_cap:
        rows, cols = linear_sum_assignment(residual, maximize=True)
        perm = np.empty(n, dtype=np.int64)
        perm[rows] = cols
        sent = residual[idx, perm].copy()
        if min_fill > 0.0:
            # defer near-empty pairs to a later, relatively heavier phase
            keep = sent >= min_fill * sent.max()
            sent = np.where(keep, sent, 0.0)
        if sent.sum() <= 0:
            break
        residual[idx, perm] -= sent
        perms.append(perm)
        sents.append(sent)
    n_greedy = len(perms)
    # past the cap: sweep what is left with full-clear support matchings
    while residual.max() > 0:
        rows, cols = linear_sum_assignment(residual, maximize=True)
        perm = np.empty(n, dtype=np.int64)
        perm[rows] = cols
        sent = residual[idx, perm].copy()
        if sent.sum() <= 0:
            break
        residual[idx, perm] = 0.0
        perms.append(perm)
        sents.append(sent)
    return perms, sents, n_greedy


def maxweight_decompose(matrix: np.ndarray, *, min_fill: float = 0.0) -> Decomposition:
    """Greedy max-weight decomposition of a nonnegative ``[n, n]`` matrix.

    ``min_fill`` defers entries below ``min_fill * max_entry`` of a
    matching to later phases (0 transfers everything matched)."""
    a = np.asarray(matrix, dtype=np.float64)
    if (a < 0).any():
        raise ValueError("traffic matrix must be nonnegative")
    n = a.shape[0]
    perms_l, sents_l, n_greedy = _greedy_phases(a.copy(), min_fill=min_fill)
    perms = np.stack(perms_l) if perms_l else np.zeros((0, n), dtype=np.int64)
    sent = np.stack(sents_l) if sents_l else np.zeros((0, n))
    alloc = sent.copy()  # max-weight transfers everything matched
    phases = [
        Phase.unchecked(perm=perms[k], alloc=alloc[k], sent=sent[k])
        for k in range(perms.shape[0])
    ]
    d = Decomposition(
        matrix=a,
        phases=phases,
        strategy="maxweight",
        meta={"min_fill": min_fill, "n_greedy": n_greedy},
    )
    d._stacked_cache = StackedPhases(perms=perms, alloc=alloc, sent=sent)
    return d

"""Birkhoff-von Neumann decomposition of Sinkhorn-normalized traffic
(the paper's baseline, numpy/scipy on the host).

A doubly stochastic ``S`` is a convex combination of permutations,
``S = sum_k lam_k P_k``: each ``P_k`` is a perfect matching on the
residual's support and ``lam_k`` its smallest selected entry, which zeroes
at least one entry per round (Marcus-Ree bound ``(n-1)^2 + 1``).  A raw
MoE matrix ``A`` is scheduled as the paper does (§3.1):

1. ``S = sinkhorn(A)``;
2. decompose ``S`` into ``(lam_k, P_k)``;
3. frame length ``T = max_{A[i,j]>0} A[i,j] / S[i,j]`` tokens, so the
   frame's capacity covers every pair's demand;
4. phase ``k`` gives each selected pair a slot of ``lam_k * T`` and
   delivers ``min(remaining demand, slot)``.

Steps 3-4 are where normalization inflates the frame and leaves most
slots idle.  Counterpart of ``repro/core/bvn.py``: the same LAP calls on
the same matrices, so the same phases.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from repro_torch.core.sinkhorn import sinkhorn
from repro_torch.core.types import Decomposition, Phase

__all__ = [
    "bvn_coefficients",
    "bvn_decompose",
    "bvn_decompose_batch",
    "bottleneck_matching",
]

_SUPPORT_TOL = 1e-9


def _perfect_matching_on_support(residual: np.ndarray, tol: float = _SUPPORT_TOL) -> np.ndarray | None:
    """A perfect matching that uses only entries above ``tol``, or None
    when the support admits none."""
    support = (residual > tol).astype(np.float64)
    rows, cols = linear_sum_assignment(support, maximize=True)
    if support[rows, cols].min() == 0:
        return None
    perm = np.empty(residual.shape[0], dtype=np.int64)
    perm[rows] = cols
    return perm


def bottleneck_matching(residual: np.ndarray) -> np.ndarray | None:
    """Max-min (bottleneck) perfect matching on the support: the matching
    whose smallest selected entry is largest, so each round extracts the
    largest coefficient it can.  Binary search over entry thresholds."""
    vals = np.unique(residual[residual > _SUPPORT_TOL])
    if vals.size == 0:
        return None
    lo, hi = 0, vals.size - 1
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        support = (residual >= vals[mid]).astype(np.float64)
        rows, cols = linear_sum_assignment(support, maximize=True)
        if support[rows, cols].min() > 0:
            best = (rows, cols)
            lo = mid + 1
        else:
            hi = mid - 1
    if best is None:
        return None
    perm = np.empty(residual.shape[0], dtype=np.int64)
    perm[best[0]] = best[1]
    return perm


def bvn_coefficients(
    stochastic: np.ndarray,
    *,
    tol: float = 1e-6,
    bottleneck: bool = False,
    max_matchings: int | None = None,
) -> list[tuple[float, np.ndarray]]:
    """Decompose a doubly stochastic matrix into ``[(lam_k, perm_k)]``,
    until the residual's largest entry is at most ``tol`` or after
    ``max_matchings``."""
    residual = np.asarray(stochastic, dtype=np.float64).copy()
    n = residual.shape[0]
    out: list[tuple[float, np.ndarray]] = []
    hard_cap = (n - 1) ** 2 + 1 + n  # Marcus-Ree bound plus slack for numerical residue
    while residual.max() > tol and len(out) < hard_cap:
        if max_matchings is not None and len(out) >= max_matchings:
            break
        if bottleneck:
            perm = bottleneck_matching(residual)
        else:
            perm = _perfect_matching_on_support(residual, tol)
        if perm is None:  # support lost to numerical truncation
            break
        lam = float(residual[np.arange(n), perm].min())
        if lam <= 0:
            break
        residual[np.arange(n), perm] -= lam
        np.clip(residual, 0.0, None, out=residual)
        out.append((lam, perm))
    return out


def bvn_decompose(
    matrix: np.ndarray,
    *,
    tol: float = 1e-6,
    bottleneck: bool = False,
    max_matchings: int | None = None,
) -> Decomposition:
    """The paper's pipeline: Sinkhorn -> BvN -> framed greedy delivery."""
    a = np.asarray(matrix, dtype=np.float64)
    n = a.shape[0]
    s = sinkhorn(a)
    coeffs = bvn_coefficients(s, tol=tol, bottleneck=bottleneck, max_matchings=max_matchings)
    # frame length (tokens): the smallest T with T*S >= A on A's support
    mask = a > 0
    frame = float((a[mask] / s[mask]).max()) if mask.any() else 0.0
    # the tail below tol is not decomposed: inflate the frame by the
    # undecomposed mass to keep full coverage
    lam_sum = sum(lam for lam, _ in coeffs)
    if coeffs and lam_sum < 1.0:
        frame /= lam_sum
    remaining = a.copy()
    phases: list[Phase] = []
    idx = np.arange(n)
    if coeffs:
        # framed delivery in one pass: phase k delivers
        # min(demand, cum_slots_k) - min(demand, cum_slots_{k-1}) per pair,
        # a grouped cumsum over (src, dst) pair ids
        k_total = len(coeffs)
        perms = np.stack([p for _, p in coeffs])  # [K, n]
        slots = np.array([lam * frame for lam, _ in coeffs])  # [K]
        flat = (idx[None, :] * n + perms).ravel()  # k-major pair ids
        slot_flat = np.broadcast_to(slots[:, None], (k_total, n)).ravel()
        order = np.argsort(flat, kind="stable")  # pair groups, k ascending
        sf, ss = flat[order], slot_flat[order]
        csum = np.cumsum(ss)
        new_group = np.concatenate([[True], sf[1:] != sf[:-1]])
        starts = np.flatnonzero(new_group)
        # cumulative slots within each pair group, this phase included
        group_base = np.zeros(sf.size)
        group_base[starts] = csum[starts] - ss[starts]
        np.maximum.accumulate(group_base, out=group_base)
        cum_incl = csum - group_base
        cum_before = cum_incl - ss
        demand = a.ravel()[sf]
        sent_sorted = np.minimum(demand, cum_incl) - np.minimum(demand, cum_before)
        sent_flat = np.empty(sf.size)
        sent_flat[order] = sent_sorted
        sent = sent_flat.reshape(k_total, n)
        alloc = np.broadcast_to(slots[:, None], (k_total, n)).copy()
        delivered = np.zeros(n * n)
        np.add.at(delivered, sf, sent_sorted)
        remaining = (a.ravel() - delivered).reshape(n, n).copy()
        np.clip(remaining, 0.0, None, out=remaining)
        phases = [Phase.unchecked(perm=perms[k], alloc=alloc[k], sent=sent[k]) for k in range(k_total)]
    # deliver crumbs left by coefficient truncation in extra minimal
    # phases (rare; keeps Decomposition.verify exact)
    guard = 0
    while remaining.max() > 1e-6 and guard < n * n:
        perm = _perfect_matching_on_support(remaining)
        if perm is None:
            # partial phase: any complete assignment, zero entries included
            rows, cols = linear_sum_assignment(remaining, maximize=True)
            perm = np.empty(n, dtype=np.int64)
            perm[rows] = cols
        sent = remaining[idx, perm].copy()
        remaining[idx, perm] = 0.0
        phases.append(Phase(perm=perm, alloc=sent.copy(), sent=sent))
        guard += 1
    return Decomposition(
        matrix=a,
        phases=phases,
        strategy="bvn-bottleneck" if bottleneck else "bvn",
        meta={
            "sinkhorn": s,
            "frame_tokens": frame,
            "coefficients": [lam for lam, _ in coeffs],
            "num_bvn_matchings": len(coeffs),
        },
    )


def bvn_decompose_batch(
    matrices: np.ndarray,
    *,
    tol: float = 1e-6,
    bottleneck: bool = False,
    max_matchings: int | None = None,
) -> list[Decomposition]:
    """``bvn_decompose`` over a stack ``[L, n, n]`` (one matrix per MoE
    layer or regime); the matching extraction is sequential per matrix."""
    stack = np.asarray(matrices, dtype=np.float64)
    if stack.ndim != 3 or stack.shape[1] != stack.shape[2]:
        raise ValueError(f"expected [L, n, n] stack, got {stack.shape}")
    return [
        bvn_decompose(stack[i], tol=tol, bottleneck=bottleneck, max_matchings=max_matchings)
        for i in range(stack.shape[0])
    ]

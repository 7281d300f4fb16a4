"""Non-decomposed all-to-all baselines (paper §4.1).

* ``ideal_a2a_tokens`` — idealized congestion-free completion: every NIC
  is limited by its own ingress/egress volume only, so completion (in
  token-time units) is ``max(max row sum, max col sum)``.

* ``ring_a2a_tokens`` — optimal completion over a *static bidirectional
  ring*: each demand (i, j) may split across the clockwise and
  counter-clockwise paths; minimize the maximum link load.  The paper
  solves this with Gurobi; we solve the identical LP with
  ``scipy.optimize.linprog`` (HiGHS).

All results are in token-time units: divide by link bandwidth
(tokens/second) for seconds.  Counterpart of ``repro/core/baselines.py``
(the same LP, the same solver).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linprog

__all__ = ["ideal_a2a_tokens", "ring_a2a_tokens"]


def ideal_a2a_tokens(matrix: np.ndarray) -> float:
    a = np.asarray(matrix, dtype=np.float64)
    if a.size == 0:
        return 0.0
    off = a.copy()
    np.fill_diagonal(off, 0.0)  # local traffic never crosses the fabric
    return float(max(off.sum(axis=1).max(), off.sum(axis=0).max()))


def _ring_links(n: int, i: int, j: int, direction: int) -> list[int]:
    """Links used going from i to j around the ring.

    Links are indexed 0..2n-1: link ``k`` (k < n) is clockwise k->k+1;
    link ``n + k`` is counter-clockwise k+1->k.
    """
    links = []
    cur = i
    if direction == 0:  # clockwise
        while cur != j:
            links.append(cur)
            cur = (cur + 1) % n
    else:  # counter-clockwise
        while cur != j:
            links.append(n + (cur - 1) % n)
            cur = (cur - 1) % n
    return links


def ring_a2a_tokens(matrix: np.ndarray, *, normalize_nic: bool = True) -> float:
    """LP-optimal all-to-all completion time on a static bidirectional ring.

    Variables: x_d in [0,1] per demand = clockwise fraction, plus the
    makespan T.  Minimize T subject to (load on each link) <= T.

    With ``normalize_nic`` (default) the result is expressed in single-NIC
    token-time units: the two directed ring links per node share the same
    NIC bandwidth the circuit switch would get, i.e. each direction runs at
    B/2, doubling the LP link-load makespan.  This keeps the ring baseline
    hardware-comparable to the ideal/circuit models (and guarantees
    ring >= ideal).  Pass ``normalize_nic=False`` for the raw LP link load.
    """
    a = np.asarray(matrix, dtype=np.float64)
    n = a.shape[0]
    demands = [
        (i, j, a[i, j]) for i in range(n) for j in range(n) if i != j and a[i, j] > 0
    ]
    if not demands:
        return 0.0
    nd = len(demands)
    n_links = 2 * n
    # Column layout: [x_0..x_{nd-1}, T]
    # Link load: sum_d vol_d * (x_d * cw_d_uses_link + (1-x_d) * ccw_uses) <= T
    a_ub = np.zeros((n_links, nd + 1))
    b_ub = np.zeros(n_links)
    for d, (i, j, vol) in enumerate(demands):
        for link in _ring_links(n, i, j, 0):
            a_ub[link, d] += vol
        for link in _ring_links(n, i, j, 1):
            a_ub[link, d] -= vol
            b_ub[link] -= vol  # constant part of (1-x)*vol moved to rhs
    a_ub[:, nd] = -1.0  # sum vol*x*(cw-ccw) - T <= -sum vol*ccw
    c = np.zeros(nd + 1)
    c[nd] = 1.0
    bounds = [(0.0, 1.0)] * nd + [(0.0, None)]
    res = linprog(c, A_ub=a_ub, b_ub=b_ub, bounds=bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"ring LP failed: {res.message}")
    return float(res.x[nd]) * (2.0 if normalize_nic else 1.0)

"""Greedy max-weight decomposition (the paper's advocated strategy, §3.2).

Repeatedly take the maximum-weight perfect matching of the residual
traffic matrix (Jonker-Volgenant via ``scipy.optimize.linear_sum_assignment``)
and transfer the matched entries in full, so ``alloc == sent``: no
normalization-induced idle capacity, at the price of imbalance inside a
matching (§3.3).

* ``maxweight_decompose_batch``: the controller's one call per drift
  event, a stack of matrices (one per MoE layer or regime) with per-layer
  warm starts.
* Warm start: at a drift event the new matrix usually has the same
  support (set of positive pairs); ``warm_start`` then replays the
  previous matchings with no LAP solve and runs the cold loop only on
  what the replay leaves.  On an unchanged matrix the replay equals the
  cold path.

``maxweight_decompose_reference`` keeps the plain loop as the parity
oracle.  Counterpart of ``repro/core/maxweight.py``: the same LAP
sequence on the same matrices.  ``maxweight_decompose_batch``'s
``backend="jax"`` keeps the reference's name for its batched solver: it
solves each cold phase with the auction of ``core/lap.py`` (the
counterpart of ``repro/core/lap_jax.py``) in place of scipy, and tags each
result ``meta["lap_backend"] = "jax"`` as the reference does.  The auction
solves each matrix of a stack independently, so one layer at a time gives
the reference's batched result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.optimize import linear_sum_assignment

from repro_torch.core.faults import apply_link_mask
from repro_torch.core.lap import auction_lap
from repro_torch.core.types import Decomposition, Phase, StackedPhases

__all__ = [
    "maxweight_decompose",
    "maxweight_decompose_batch",
    "maxweight_decompose_reference",
    "WarmState",
    "warm_state_of",
]


@dataclasses.dataclass(frozen=True)
class WarmState:
    """What a replay of a previous decomposition needs.  The replay is
    taken only when the new matrix has the same ``support`` and the same
    planning options (``min_fill``/``max_matchings``), which guarantees the
    replayed perms cover every positive entry under the same contract."""

    support: np.ndarray  # [n, n] bool
    perms: np.ndarray  # [K, n] int64 (greedy + residual-sweep phases)
    min_fill: float = 0.0
    max_matchings: int | None = None
    # phases [0, n_greedy) used min_fill deferral; the rest are
    # residual-sweep full clears (distinct only when min_fill > 0)
    n_greedy: int = 0


def warm_state_of(decomp: Decomposition) -> WarmState:
    """A ``WarmState`` from a previous max-weight decomposition."""
    perms = decomp.stacked().perms
    return WarmState(
        support=np.asarray(decomp.matrix) > 0,
        perms=perms,
        min_fill=float(decomp.meta.get("min_fill") or 0.0),
        max_matchings=decomp.meta.get("max_matchings"),
        n_greedy=int(decomp.meta.get("n_greedy", perms.shape[0])),
    )


def _scipy_perm(residual: np.ndarray) -> np.ndarray:
    """The maximum-weight matching as ``perm[row] = col`` (Jonker-Volgenant)."""
    rows, cols = linear_sum_assignment(residual, maximize=True)
    perm = np.empty(residual.shape[0], dtype=np.int64)
    perm[rows] = cols
    return perm


def _auction_perm(residual: np.ndarray) -> np.ndarray:
    """The same matching from the auction (``backend="jax"``)."""
    return auction_lap(residual).numpy().astype(np.int64)


def _greedy_phases(
    residual: np.ndarray,
    *,
    max_matchings: int | None,
    min_fill: float,
    phases_done: int = 0,
    solve=_scipy_perm,
) -> tuple[list[np.ndarray], list[np.ndarray], int]:
    """The greedy loop on ``residual`` (modified in place): the lists of
    (perm, sent) arrays and the count of greedy (pre-sweep) phases.  The
    same LAP sequence as ``maxweight_decompose_reference`` when ``solve``
    is scipy's."""
    n = residual.shape[0]
    idx = np.arange(n)
    perms: list[np.ndarray] = []
    sents: list[np.ndarray] = []
    hard_cap = int((residual > 0).sum()) + 1  # each phase clears >= 1 entry
    while residual.max() > 0 and len(perms) < hard_cap:
        if max_matchings is not None and len(perms) + phases_done >= max_matchings:
            break
        perm = solve(residual)
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
        perm = solve(residual)
        sent = residual[idx, perm].copy()
        if sent.sum() <= 0:
            break
        residual[idx, perm] = 0.0
        perms.append(perm)
        sents.append(sent)
    return perms, sents, n_greedy


def _warm_replay(residual: np.ndarray, warm_perms: np.ndarray, min_fill: float) -> tuple[np.ndarray, np.ndarray]:
    """Replay previous matchings against a new residual, with no LAP solve.

    Each replayed phase clears what sits on its pairs; phases whose pairs
    are already drained drop out.  With the support unchanged the replay
    covers every positive entry, so the residual afterwards is zero unless
    ``min_fill`` deferred entries (the caller finishes those cold)."""
    n = residual.shape[0]
    k_warm = warm_perms.shape[0]
    if k_warm == 0:
        return np.zeros((0, n), dtype=np.int64), np.zeros((0, n))
    if min_fill == 0.0:
        # every pair is cleared in full at its FIRST appearance in the
        # replayed perms: one first-occurrence scatter (np.unique returns
        # the first raveled index, and ravel order is phase-major)
        flat_pairs = (np.arange(n)[None, :] * n + warm_perms).ravel()
        uniq, first = np.unique(flat_pairs, return_index=True)
        sent = np.zeros(k_warm * n)
        sent[first] = residual.ravel()[uniq]
        sent = sent.reshape(k_warm, n)
        residual.ravel()[uniq] = 0.0
        live = sent.max(axis=1) > 0
        return warm_perms[live], sent[live]
    idx = np.arange(n)
    perms: list[np.ndarray] = []
    sents: list[np.ndarray] = []
    for perm in warm_perms:
        sent = residual[idx, perm].copy()
        mx = sent.max()
        if mx <= 0:
            continue
        keep = sent >= min_fill * mx
        sent = np.where(keep, sent, 0.0)
        if sent.sum() <= 0:
            continue
        residual[idx, perm] -= sent
        perms.append(perm)
        sents.append(sent)
    if not perms:
        return np.zeros((0, n), dtype=np.int64), np.zeros((0, n))
    return np.stack(perms), np.stack(sents)


def _build(
    a: np.ndarray,
    perms: np.ndarray,
    sent: np.ndarray,
    *,
    max_matchings: int | None,
    min_fill: float,
    warm_hit: bool,
    n_greedy: int,
) -> Decomposition:
    alloc = sent.copy()  # max-weight transfers everything matched
    phases = [Phase.unchecked(perm=perms[k], alloc=alloc[k], sent=sent[k]) for k in range(perms.shape[0])]
    d = Decomposition(
        matrix=a,
        phases=phases,
        strategy="maxweight",
        meta={"max_matchings": max_matchings, "min_fill": min_fill, "warm_hit": warm_hit, "n_greedy": n_greedy},
    )
    d._stacked_cache = StackedPhases(perms=perms, alloc=alloc, sent=sent)
    return d


def maxweight_decompose(
    matrix: np.ndarray,
    *,
    max_matchings: int | None = None,
    min_fill: float = 0.0,
    warm_start: WarmState | None = None,
    link_mask: np.ndarray | None = None,
) -> Decomposition:
    """Greedy max-weight decomposition of a nonnegative ``[n, n]`` matrix.

    Args:
      max_matchings: optional cap on greedy phases; what is left after it
        is swept by full-clear matchings.
      min_fill: defer entries below ``min_fill * max_entry`` of a matching
        to later phases (0 transfers everything matched).
      warm_start: the previous step's ``WarmState``, replayed when the new
        (masked) matrix has the same positive support.
      link_mask: ``[n, n]`` bool availability (True = usable); dead pairs'
        demand is rerouted over each source row's survivors first
        (``faults.apply_link_mask``), so no phase matches a dark link.
    """
    return _decompose(
        matrix, max_matchings=max_matchings, min_fill=min_fill, warm_start=warm_start, link_mask=link_mask,
        solve=_scipy_perm,
    )


def _decompose(matrix, *, max_matchings, min_fill, warm_start, link_mask, solve) -> Decomposition:
    """``maxweight_decompose`` with its cold phases' LAP solver given."""
    a = np.asarray(matrix, dtype=np.float64)
    if (a < 0).any():
        raise ValueError("traffic matrix must be nonnegative")
    mask_meta: dict | None = None
    if link_mask is not None:
        mask_meta = {}
        a = apply_link_mask(a, link_mask, meta=mask_meta)
    residual = a.copy()
    warm_hit = (
        warm_start is not None
        and warm_start.support.shape == a.shape
        and warm_start.min_fill == min_fill
        and warm_start.max_matchings == max_matchings
        and bool(np.array_equal(a > 0, warm_start.support))
    )
    n = a.shape[0]
    perms = np.zeros((0, n), dtype=np.int64)
    sent = np.zeros((0, n))
    if warm_hit:
        # with min_fill the sweep phases have full-clear semantics, so only
        # the greedy prefix replays and the sweep re-runs
        warm_perms = warm_start.perms if min_fill == 0.0 else warm_start.perms[: warm_start.n_greedy]
        perms, sent = _warm_replay(residual, warm_perms, min_fill)
    n_greedy = perms.shape[0]
    if residual.max() > 0:
        cold_perms, cold_sents, cold_greedy = _greedy_phases(
            residual, max_matchings=max_matchings, min_fill=min_fill, phases_done=perms.shape[0], solve=solve
        )
        n_greedy += cold_greedy
        if cold_perms:
            perms = np.concatenate([perms, np.stack(cold_perms)])
            sent = np.concatenate([sent, np.stack(cold_sents)])
    d = _build(a, perms, sent, max_matchings=max_matchings, min_fill=min_fill, warm_hit=warm_hit, n_greedy=n_greedy)
    if mask_meta is not None:
        d.meta["link_masked"] = True
        d.meta["unroutable_tokens"] = mask_meta.get("unroutable_tokens", 0.0)
    return d


def maxweight_decompose_batch(
    matrices: np.ndarray,
    *,
    max_matchings: int | None = None,
    min_fill: float = 0.0,
    warm_start: list[WarmState | None] | None = None,
    link_mask: np.ndarray | None = None,
    backend: str = "scipy",
) -> list[Decomposition]:
    """Decompose a stack ``[L, n, n]`` in one call, one ``Decomposition``
    per layer.  ``warm_start`` is a list aligned with the stack (None
    entries run cold); ``link_mask`` is one fabric-wide mask for every
    layer (outages are physical).  ``backend`` picks the cold phases' LAP
    solver: ``"scipy"`` (Jonker-Volgenant, one matrix at a time) or
    ``"jax"``, the reference's name for the batched auction (here
    ``core.lap``; equal weight to scipy on integer counts, ties may break
    differently).  Warm replays solve no LAP, whatever the backend."""
    stack = np.asarray(matrices, dtype=np.float64)
    if stack.ndim != 3 or stack.shape[1] != stack.shape[2]:
        raise ValueError(f"expected [L, n, n] stack, got {stack.shape}")
    if (stack < 0).any():
        raise ValueError("traffic matrices must be nonnegative")
    if warm_start is not None and len(warm_start) != stack.shape[0]:
        raise ValueError("warm_start must align with the matrix stack")
    if backend not in ("scipy", "jax"):
        raise ValueError(f"unknown LAP backend {backend!r}; one of ('scipy', 'jax')")
    solve = _scipy_perm if backend == "scipy" else _auction_perm
    out = [
        _decompose(
            stack[i],
            max_matchings=max_matchings,
            min_fill=min_fill,
            warm_start=warm_start[i] if warm_start is not None else None,
            link_mask=link_mask,
            solve=solve,
        )
        for i in range(stack.shape[0])
    ]
    if backend == "jax":
        for d in out:
            d.meta["lap_backend"] = "jax"
    return out


def maxweight_decompose_reference(
    matrix: np.ndarray,
    *,
    max_matchings: int | None = None,
    min_fill: float = 0.0,
) -> Decomposition:
    """The plain loop over ``Phase`` objects: the fast path's parity oracle."""
    a = np.asarray(matrix, dtype=np.float64)
    if (a < 0).any():
        raise ValueError("traffic matrix must be nonnegative")
    n = a.shape[0]
    residual = a.copy()
    idx = np.arange(n)
    phases: list[Phase] = []
    hard_cap = int((residual > 0).sum()) + 1  # each phase clears >= 1 entry
    while residual.max() > 0 and len(phases) < hard_cap:
        if max_matchings is not None and len(phases) >= max_matchings:
            break
        rows, cols = linear_sum_assignment(residual, maximize=True)
        perm = np.empty(n, dtype=np.int64)
        perm[rows] = cols
        sent = residual[idx, perm].copy()
        if min_fill > 0.0:
            keep = sent >= min_fill * sent.max()
            sent = np.where(keep, sent, 0.0)
        if sent.sum() <= 0:
            break
        residual[idx, perm] -= sent
        phases.append(Phase(perm=perm, alloc=sent.copy(), sent=sent))
    while residual.max() > 0:
        rows, cols = linear_sum_assignment(residual, maximize=True)
        perm = np.empty(n, dtype=np.int64)
        perm[rows] = cols
        sent = residual[idx, perm].copy()
        if sent.sum() <= 0:
            break
        residual[idx, perm] = 0.0
        phases.append(Phase(perm=perm, alloc=sent.copy(), sent=sent))
    return Decomposition(
        matrix=a, phases=phases, strategy="maxweight", meta={"max_matchings": max_matchings, "min_fill": min_fill}
    )

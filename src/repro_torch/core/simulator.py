"""Event-driven simulator of MoE dispatch-compute-combine execution (§4).

Models one MoE layer forward pass over a circuit-switched fabric:

* **Dispatch phases** — one per matching; the circuit is held for the
  phase's largest allocated slot (plus reconfiguration delay).
* **Compute** — each rank owns a compute queue; tokens received in phase
  ``k`` become available when that phase's dispatch finishes.  With
  ``overlap=True`` each phase's tokens are computed as their own batch
  (exposing the knee overhead per phase); with ``overlap=False`` the rank
  computes all received tokens as one batch after the last dispatch phase
  (the paper's non-overlapped variant).
* **Combine phases** — the reverse permutation returns processed tokens;
  combine phase ``k`` is gated on phase ``k``'s compute at every rank.

Fabric models:

* ``fabric="dual"`` — dispatch and combine ride separate circuit planes
  (full-duplex transceivers), yielding exactly the 3-machine flow shop the
  paper describes (§3.3).
* ``fabric="single"`` — one plane; network jobs serialize in the order
  D1..DK, C1..CK with the same gating.

Baselines (§4.1): sequential all-to-all over a static ring (LP-optimal
link loads, no overlap) and the idealized congestion-free all-to-all.

Counterpart of ``repro/core/simulator.py``, on the port's
``Decomposition``/``StackedPhases``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.baselines import ideal_a2a_tokens, ring_a2a_tokens
from repro_torch.core.cost_models import CommModel, ComputeModel
from repro_torch.core.types import Decomposition

__all__ = ["SimResult", "simulate_decomposition", "simulate_sequential", "simulate_ideal"]


@dataclasses.dataclass(frozen=True)
class SimResult:
    makespan_us: float
    dispatch_us: float  # total network time spent on dispatch phases
    compute_us: float  # max per-rank total compute time
    combine_us: float  # total network time spent on combine phases
    num_phases: int
    exposed_comm_us: float  # comm time not hidden behind compute
    strategy: str

    def __repr__(self) -> str:  # compact, CSV-friendly
        return (
            f"SimResult({self.strategy}: makespan={self.makespan_us:.1f}us, "
            f"phases={self.num_phases}, exposed={self.exposed_comm_us:.1f}us)"
        )


def _chain_max(starts: np.ndarray, durs: np.ndarray, base: float | np.ndarray):
    """Closed form of the flow-shop recurrence ``f_k = max(s_k, f_{k-1}) + c_k``.

    ``starts`` [K] (or [K, n]) are the earliest-start gates, ``durs`` the
    per-step costs, ``base`` the value of ``f_{-1}``.  Telescoping with
    ``C = cumsum(durs)`` gives ``f_k = C_k + max(base, cummax(s_j - C_{j-1}))``
    — one cumsum + one accumulated max instead of a Python loop over K.
    """
    c = np.cumsum(durs, axis=0)
    c_prev = np.concatenate([np.zeros_like(c[:1]), c[:-1]], axis=0)
    gate = np.maximum.accumulate(starts - c_prev, axis=0)
    return c + np.maximum(base, gate)


def simulate_decomposition(
    decomp: Decomposition,
    compute: ComputeModel,
    comm: CommModel,
    *,
    overlap: bool = True,
    fabric: str = "dual",
    local_tokens: np.ndarray | None = None,
) -> SimResult:
    n = decomp.n
    st = decomp.stacked()
    k_total = st.num_phases
    local = (
        np.zeros(n) if local_tokens is None else np.asarray(local_tokens, np.float64)
    )
    if k_total == 0:
        t = float(np.max(compute(local))) if local.any() else 0.0
        return SimResult(t, 0.0, t, 0.0, 0, 0.0, decomp.strategy)
    if fabric not in ("dual", "single"):
        raise ValueError(f"unknown fabric {fabric!r}")

    disp_dur = comm.reconf_us + comm.comm_us(st.durations())  # [K]
    comb_dur = disp_dur.copy()  # return path carries the same volumes
    recv = st.recv_tokens()  # [K, n]
    phase_comp = compute(recv)  # [K, n]
    local_comp = compute(local)  # [n]

    # --- dispatch plane ---------------------------------------------------
    # dual: dispatch phases chain back to back; single: same chain, but the
    # combine phases later serialize behind it on the one plane.
    disp_done = np.cumsum(disp_dur)

    # --- compute ----------------------------------------------------------
    # compute_done[k] = time when every rank finished phase k's batch.
    # Per-rank chain: free_k = max(disp_done[k], free_{k-1}) + comp_k.
    if overlap:
        free = _chain_max(
            disp_done[:, None], phase_comp, local_comp[None, :]
        )  # [K, n]
        compute_done = free.max(axis=1)
    else:
        total_comp = compute(recv.sum(axis=0) + local)
        compute_done = np.full(k_total, disp_done[-1] + total_comp.max())

    # --- combine plane ----------------------------------------------------
    # Combine phase k gates on phase k's compute everywhere; on the single
    # plane it additionally queues behind the last dispatch phase.
    comb_base = 0.0 if fabric == "dual" else float(disp_done[-1])
    comb_free = _chain_max(compute_done, comb_dur, comb_base)
    makespan = comb_free[-1]

    if overlap:
        compute_us = float((local_comp + phase_comp.sum(axis=0)).max())
    else:
        compute_us = float(compute(recv.sum(axis=0) + local).max())

    exposed = float(makespan - compute_us)
    return SimResult(
        makespan_us=float(makespan),
        dispatch_us=float(disp_dur.sum()),
        compute_us=compute_us,
        combine_us=float(comb_dur.sum()),
        num_phases=k_total,
        exposed_comm_us=max(exposed, 0.0),
        strategy=decomp.strategy + ("+ovl" if overlap else ""),
    )


def _compute_all(matrix: np.ndarray, compute: ComputeModel) -> float:
    """Max per-rank compute for the whole batch delivered at once."""
    recv = np.asarray(matrix, dtype=np.float64).sum(axis=0)
    return float(np.max(compute(recv)))


def simulate_sequential(
    matrix: np.ndarray, compute: ComputeModel, comm: CommModel
) -> SimResult:
    """Static-ring all-to-all -> full compute -> static-ring combine."""
    t_ring = comm.comm_us(ring_a2a_tokens(matrix))
    t_back = comm.comm_us(ring_a2a_tokens(np.asarray(matrix).T))
    t_comp = _compute_all(matrix, compute)
    makespan = t_ring + t_comp + t_back
    return SimResult(
        makespan_us=makespan,
        dispatch_us=t_ring,
        compute_us=t_comp,
        combine_us=t_back,
        num_phases=1,
        exposed_comm_us=t_ring + t_back,
        strategy="ring-sequential",
    )


def simulate_ideal(
    matrix: np.ndarray, compute: ComputeModel, comm: CommModel
) -> SimResult:
    """Idealized congestion-free all-to-all (monolithic, no overlap)."""
    t_go = comm.comm_us(ideal_a2a_tokens(matrix))
    t_back = comm.comm_us(ideal_a2a_tokens(np.asarray(matrix).T))
    t_comp = _compute_all(matrix, compute)
    makespan = t_go + t_comp + t_back
    return SimResult(
        makespan_us=makespan,
        dispatch_us=t_go,
        compute_us=t_comp,
        combine_us=t_back,
        num_phases=1,
        exposed_comm_us=t_go + t_back,
        strategy="ideal-a2a",
    )

"""Serving-side planning: demand estimate -> one ``ScheduleTable``.

``plan_serving_table`` builds exactly the first table the JAX serving
controller builds (``repro.core.runtime.make_serving_controller`` ->
``observe`` -> ``table()``): one shared plan for every MoE layer
(``group_by="model"``), greedy max-weight with ``min_fill=0.1``, the
selector's plan options, ``k_max = n_ranks`` phase slots and an envelope
with 1.5x slack.  The controller's EMA, library, hysteresis, faults and
drift belong to a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.decompose import decompose
from repro_torch.core.schedule import ScheduleTable, phase_envelope, plan_schedule

__all__ = ["DEFAULT_PLAN_KWARGS", "routing_to_traffic", "plan_serving_table"]

# repro.core.selector.DEFAULT_PLAN_KWARGS
DEFAULT_PLAN_KWARGS = {"slack": 1.1, "quantum": 8, "min_cap": 8}


def routing_to_traffic(stats: np.ndarray, *, n_ranks: int, n_experts: int) -> np.ndarray:
    """Fold routing counts ``[L, n_src, E]`` to traffic ``[L, n, n]``.

    Experts map to ranks by contiguous blocks; with fewer source shards
    than ranks (one device observing a virtual fabric) each source row is
    split evenly across its ``n // n_src`` virtual sources."""
    s = np.asarray(stats, dtype=np.float64)
    if s.ndim != 3 or s.shape[2] != n_experts:
        raise ValueError(f"expected [L, n_src, {n_experts}] stats, got {s.shape}")
    n_src = s.shape[1]
    per_rank = s.reshape(s.shape[0], n_src, n_ranks, n_experts // n_ranks).sum(axis=-1)
    if n_src == n_ranks:
        return per_rank
    if n_ranks % n_src == 0:
        k = n_ranks // n_src
        return np.repeat(per_rank, k, axis=1) / k
    if n_src % n_ranks == 0:
        k = n_src // n_ranks
        return per_rank.reshape(s.shape[0], n_ranks, k, n_ranks).sum(axis=2)
    raise ValueError(f"cannot map {n_src} source shards onto {n_ranks} ranks")


# repro.core.runtime.ControllerConfig defaults
MIN_FILL = 0.1
ENVELOPE_SLACK = 1.5


def plan_serving_table(
    stats: np.ndarray,
    *,
    n_ranks: int,
    n_experts: int,
    strategy: str = "maxweight",
    device: torch.device | str = "cpu",
) -> ScheduleTable:
    """One table for ``L = stats.shape[0]`` MoE layers from routing
    counts ``stats [L, n_src, E]`` (see module doc); ``k_max = n_ranks``
    phase slots."""
    if n_experts % n_ranks:
        raise ValueError(f"{n_experts} experts not divisible by {n_ranks} ranks")
    mats = routing_to_traffic(stats, n_ranks=n_ranks, n_experts=n_experts)
    n_layers = mats.shape[0]
    # one plan for all layers, sized for one layer's traffic (the mean)
    traffic = mats[list(range(n_layers))].mean(axis=0)
    kwargs = {"min_fill": MIN_FILL} if strategy == "maxweight" else {}
    sched = plan_schedule(decompose(traffic, strategy, **kwargs), **DEFAULT_PLAN_KWARGS)
    scheds = [sched] * n_layers
    raw = phase_envelope(scheds, n_ranks, slack=1.0)
    envelope = np.where(
        raw > 0, -(-np.ceil(raw * ENVELOPE_SLACK).astype(np.int64) // 8) * 8, 0
    )
    return ScheduleTable.from_schedules(
        scheds, k_max=n_ranks, clip=True,
        envelope=tuple(int(v) for v in envelope), device=device,
    )

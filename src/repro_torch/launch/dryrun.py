"""The training launcher's day-one MoE plan: one skewed draw of expected
traffic, decomposed and planned into a static schedule.

Counterpart of ``expected_traffic`` and ``build_schedule(plan="lossless")``
in ``repro/launch/dryrun.py``; the other plan recipes and the compile
dry-run itself are not ported.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.decompose import decompose
from repro_torch.core.schedule import A2ASchedule, plan_schedule
from repro_torch.core.traffic import RouterConfig, traffic_matrix

__all__ = ["expected_traffic", "build_schedule"]


def expected_traffic(cfg, n: int, tokens_per_rank: int) -> np.ndarray:
    """One skewed draw (seed 0, Dirichlet 0.3) from the arch's router
    profile: the ``[n, n]`` token counts the planner starts from."""
    router = RouterConfig(cfg.name, cfg.moe.n_experts, cfg.moe.top_k)
    rng = np.random.default_rng(0)
    return traffic_matrix(rng, router, np.full(n, max(tokens_per_rank, 1)), n_ranks=n, skew_alpha=0.3)


def build_schedule(cfg, n: int, tokens_per_rank: int, strategy: str = "maxweight",
                   plan: str = "lossless") -> A2ASchedule:
    """Plan the scheduled dispatch from ``expected_traffic``.
    ``plan="lossless"``: min-fill deferral in the decomposition, no slack
    (zero planned drops at minimum padding)."""
    if plan != "lossless":
        raise NotImplementedError(f"plan={plan!r}: only the 'lossless' recipe is ported")
    mat = expected_traffic(cfg, n, tokens_per_rank)
    return plan_schedule(decompose(mat, strategy, min_fill=0.1), slack=1.0, quantum=8)

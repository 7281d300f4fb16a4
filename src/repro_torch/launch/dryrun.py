"""The training launcher's day-one MoE plan: one skewed draw of expected
traffic, decomposed and planned into a static schedule, or, for the
``hierarchical`` fabric, into a two-level table.

Counterpart of ``expected_traffic``, ``build_schedule(plan="lossless")``
and ``build_hierarchical_table`` in ``repro/launch/dryrun.py``; the other
flat plan recipes and the compile dry-run itself are not ported.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.decompose import decompose
from repro_torch.core.hierarchical import HierarchicalTable, hierarchical_plan
from repro_torch.core.schedule import A2ASchedule, plan_schedule
from repro_torch.core.traffic import RouterConfig, traffic_matrix

__all__ = ["expected_traffic", "build_schedule", "build_hierarchical_table"]

# the plan presets of the two-level table (JAX's ``build_hierarchical_table``)
HIERARCHICAL_PRESETS = {
    "literal": dict(slack=1.3, quantum=8),
    "lossless": dict(decompose_kwargs={"min_fill": 0.1}, slack=1.0, quantum=8),
    "v2": dict(decompose_kwargs={"min_fill": 0.1}, slack=1.1, quantum=8, cap_quantile=0.9),
}


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


def build_hierarchical_table(cfg, n: int, tokens_per_rank: int, n_moe_layers: int, strategy: str = "maxweight",
                             plan: str = "literal", device="cpu") -> HierarchicalTable:
    """The two-level counterpart of ``build_schedule`` for the
    ``hierarchical`` fabric: the same ``expected_traffic`` draw, split at
    ``cfg.moe.pod_size`` and planned per level with the preset's knobs;
    one row per MoE layer, on ``device``."""
    if plan not in HIERARCHICAL_PRESETS:
        raise ValueError(f"hierarchical dispatch has no {plan!r} plan preset; pick one of "
                         f"{sorted(HIERARCHICAL_PRESETS)}")
    mat = expected_traffic(cfg, n, tokens_per_rank)
    return hierarchical_plan(mat, cfg.moe.pod_size, n_layers=n_moe_layers, strategy=strategy, device=device,
                             **HIERARCHICAL_PRESETS[plan])

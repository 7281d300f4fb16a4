"""Synthetic MoE routing traffic (numpy only): the training launcher's
day-one traffic estimate.

Per-rank expert popularity is a Dirichlet draw (low ``skew_alpha`` =
skewed); every token picks its top-k experts without replacement by the
Gumbel trick; experts live on ranks in contiguous blocks.  The
``[src, dst]`` token counts include the diagonal (local traffic).
Counterpart of ``RouterConfig``, ``_topk_route`` and ``traffic_matrix``
in ``repro/core/traffic.py``: the same draws from the same generator
give the same matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RouterConfig", "traffic_matrix"]


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    name: str
    n_experts: int
    top_k: int
    n_shared: int = 0  # shared experts execute locally (DeepSeek style)
    d_model: int = 4096  # activation width -> bytes per routed token
    d_ff: int = 14336  # per-expert FFN width -> compute per routed token

    def experts_per_rank(self, n_ranks: int) -> int:
        if self.n_experts % n_ranks:
            raise ValueError(f"{self.n_experts} experts not divisible by {n_ranks}")
        return self.n_experts // n_ranks


def _topk_route(rng: np.random.Generator, tokens: int, probs: np.ndarray, top_k: int) -> np.ndarray:
    """Per-token top-k expert choice without replacement (Gumbel trick).
    Returns counts per expert (each token contributes ``top_k``)."""
    e = probs.shape[0]
    gumbel = rng.gumbel(size=(tokens, e))
    scores = np.log(probs + 1e-12)[None, :] + gumbel
    idx = np.argpartition(-scores, kth=top_k - 1, axis=1)[:, :top_k]
    return np.bincount(idx.ravel(), minlength=e).astype(np.float64)


def traffic_matrix(
    rng: np.random.Generator,
    router: RouterConfig,
    tokens_per_rank: np.ndarray,
    *,
    n_ranks: int,
    skew_alpha: float = 0.3,
    per_rank_probs: bool = True,
) -> np.ndarray:
    """One iteration's [src, dst] token counts (diagonal = local traffic)."""
    e = router.n_experts
    epr = router.experts_per_rank(n_ranks)
    mat = np.zeros((n_ranks, n_ranks))
    shared_probs = rng.dirichlet(np.full(e, skew_alpha))
    for src in range(n_ranks):
        probs = (
            rng.dirichlet(np.full(e, skew_alpha)) * 0.5 + shared_probs * 0.5
            if per_rank_probs
            else shared_probs
        )
        counts = _topk_route(rng, int(tokens_per_rank[src]), probs, router.top_k)
        mat[src, :] += counts.reshape(n_ranks, epr).sum(axis=1)  # expert i on rank i // epr
    return mat

"""Synthetic MoE routing traces (numpy only): the training launcher's
day-one traffic estimate and the paper's per-iteration traces.

The paper replays router decisions of Mixtral 8x7B, Mixtral 8x22B and
DeepSeek-MoE-16B under two workload regimes (MMLU: small prompts;
SPEED-bench: ~2k-token prompts); here the traces are synthesized from
the same router configurations (``ROUTERS``, ``WORKLOADS``, ``gen_trace``).
Per-rank expert popularity is a Dirichlet draw (low ``skew_alpha`` =
skewed); every token picks its top-k experts without replacement by the
Gumbel trick; experts live on ranks in contiguous blocks.  The
``[src, dst]`` token counts include the diagonal (local traffic).
Counterpart of ``repro/core/traffic.py``: the same draws from the same
generator give the same matrices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RouterConfig", "ROUTERS", "Workload", "WORKLOADS", "gen_trace", "traffic_matrix"]


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

    def expert_us_per_token(self, *, eff_tflops: float = 300.0) -> float:
        """Per routed-token expert time on the linear tail: a SwiGLU expert
        is 3 GEMMs = 6*d_model*d_ff FLOPs per token."""
        return 6.0 * self.d_model * self.d_ff / (eff_tflops * 1e6)

    def token_bytes(self, dtype_bytes: int = 2) -> int:
        return self.d_model * dtype_bytes


ROUTERS = {
    "mixtral-8x7b": RouterConfig("mixtral-8x7b", n_experts=8, top_k=2, d_model=4096, d_ff=14336),
    "mixtral-8x22b": RouterConfig("mixtral-8x22b", n_experts=8, top_k=2, d_model=6144, d_ff=16384),
    "deepseek-moe-16b": RouterConfig("deepseek-moe-16b", n_experts=64, top_k=6, n_shared=2, d_model=2048, d_ff=1408),
    # the architectures the framework integrates
    "qwen3-moe": RouterConfig("qwen3-moe", n_experts=128, top_k=8, d_model=4096, d_ff=1536),
    "dbrx": RouterConfig("dbrx", n_experts=16, top_k=4, d_model=6144, d_ff=10752),
    "jamba": RouterConfig("jamba", n_experts=16, top_k=2, d_model=8192, d_ff=24576),
}


@dataclasses.dataclass(frozen=True)
class Workload:
    """Distribution of tokens-per-rank per iteration."""

    name: str
    mean_prompt: float  # tokens per prompt (lognormal median)
    sigma: float  # lognormal sigma of prompt length
    prompts_per_rank: int

    def tokens_per_rank(self, rng: np.random.Generator, n_ranks: int) -> np.ndarray:
        lengths = rng.lognormal(mean=np.log(self.mean_prompt), sigma=self.sigma, size=(n_ranks, self.prompts_per_rank))
        return np.maximum(lengths.sum(axis=1).astype(np.int64), 1)


WORKLOADS = {
    # MMLU: short multiple-choice prompts -> small effective batches
    "mmlu": Workload("mmlu", mean_prompt=80.0, sigma=0.45, prompts_per_rank=1),
    # SPEED-bench throughput: ~2k-token prompts -> large batches
    "speed": Workload("speed", mean_prompt=2048.0, sigma=0.25, prompts_per_rank=4),
}


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


def gen_trace(
    model: str = "mixtral-8x7b",
    workload: str = "mmlu",
    *,
    n_ranks: int = 8,
    iterations: int = 32,
    seed: int = 0,
    skew_alpha: float = 0.3,
) -> list[np.ndarray]:
    """A list of per-iteration traffic matrices for (model, workload)."""
    router = ROUTERS[model]
    wl = WORKLOADS[workload]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(iterations):
        tpr = wl.tokens_per_rank(rng, n_ranks)
        out.append(traffic_matrix(rng, router, tpr, n_ranks=n_ranks, skew_alpha=skew_alpha))
    return out

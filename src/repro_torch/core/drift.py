"""Time-varying routing-drift scenarios (numpy only).

``expert_probs(step)`` is the per-step expert-popularity vector p(t):
a Dirichlet(``alpha``) base popularity, with a hard **shift**, a
**hotspot** window or a gradual **skew** engaging at ``shift_step``.
``traffic`` turns it into an expected ``[n, n]`` rank traffic matrix and
``stats_hook`` reweights realized routing counts toward it.  The serving
launcher plans round ``r`` from ``tokens * expert_probs(r)``.
Counterpart of ``repro/core/drift.py``, copied so the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DriftScenario", "DRIFT_KINDS"]

DRIFT_KINDS = ("none", "shift", "hotspot", "skew")


@dataclasses.dataclass
class DriftScenario:
    """Deterministic per-step expert-popularity drift.

    Args:
      kind: one of ``DRIFT_KINDS``.
      n_experts: router width E.
      shift_step: step at which the shift/hotspot/skew engages.
      window: hotspot duration in steps (hotspot only).
      alpha: Dirichlet concentration of the base popularity (low = skewed).
      hot_frac: fraction of total mass the hotspot expert absorbs.
      skew_power: final sharpening exponent for the gradual-skew ramp.
      seed: RNG seed for the base popularity draws.
    """

    kind: str
    n_experts: int
    shift_step: int = 50
    window: int = 50
    alpha: float = 0.3
    hot_frac: float = 0.6
    skew_power: float = 3.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in DRIFT_KINDS:
            raise ValueError(f"unknown drift kind {self.kind!r}; one of {DRIFT_KINDS}")
        rng = np.random.default_rng(self.seed)
        self._base = rng.dirichlet(np.full(self.n_experts, self.alpha))
        # shift regime: rotate the popularity ranking so the heavy experts
        # move to different ranks (support changes, not just weights)
        self._shifted = np.roll(self._base, self.n_experts // 2)
        self._hot_expert = int(np.argmin(self._base))  # coldest goes viral

    # ------------------------------------------------------------ popularity
    def expert_probs(self, step: int) -> np.ndarray:
        """Expert popularity p(t) at ``step`` (sums to 1)."""
        e = self.n_experts
        if self.kind == "none" or step < self.shift_step:
            p = self._base
        elif self.kind == "shift":
            p = self._shifted
        elif self.kind == "hotspot":
            if step < self.shift_step + self.window:
                p = self._base * (1.0 - self.hot_frac)
                p = p.copy()
                p[self._hot_expert] += self.hot_frac
            else:
                p = self._base  # hotspot cools off
        else:  # skew: sharpen gradually over `window` steps after the onset
            frac = min((step - self.shift_step) / max(self.window, 1), 1.0)
            power = 1.0 + frac * (self.skew_power - 1.0)
            p = self._base**power
            p = p / p.sum()
        return np.asarray(p, dtype=np.float64)

    # ---------------------------------------------------------------- traffic
    def traffic(
        self,
        step: int,
        tokens_per_rank: np.ndarray,
        *,
        n_ranks: int,
        rng: np.random.Generator | None = None,
        jitter: float = 0.02,
    ) -> np.ndarray:
        """Expected ``[n, n]`` rank traffic at ``step``.

        Expert -> rank placement is contiguous blocks (as in
        ``core/traffic.py``); optional multiplicative jitter models
        per-batch sampling noise without moving the regime.
        """
        e, n = self.n_experts, n_ranks
        if e % n:
            raise ValueError(f"{e} experts not divisible by {n} ranks")
        p_rank = self.expert_probs(step).reshape(n, e // n).sum(axis=1)
        mat = np.asarray(tokens_per_rank, dtype=np.float64)[:, None] * p_rank[None, :]
        if rng is not None and jitter > 0:
            mat = mat * (1.0 + jitter * rng.standard_normal(mat.shape))
        return np.maximum(mat, 0.0)

    # ------------------------------------------------------------- stats hook
    def stats_hook(self, step: int, stats: np.ndarray) -> np.ndarray:
        """Reweight realized routing counts ``[L, n_src, E]`` toward p(t).

        Per-source token totals are preserved (drift moves tokens between
        experts, it does not create them), so capacity math downstream
        stays honest.  Passing this as ``train_loop(..., stats_hook=...)``
        injects workload drift without touching the model.
        """
        if self.kind == "none":
            return stats
        s = np.asarray(stats, dtype=np.float64)
        w = self.expert_probs(step)[None, None, :]
        reweighted = (s + 1e-9) * w
        totals = s.sum(axis=-1, keepdims=True)
        norm = reweighted.sum(axis=-1, keepdims=True)
        return reweighted * totals / np.maximum(norm, 1e-12)

"""Shared types for traffic-matrix decompositions (numpy, host side).

A *phase* is one circuit configuration: a permutation ``perm`` over ``n``
ranks, the per-pair slot ``alloc`` (tokens) and the tokens actually
``sent``.  The circuit is held for ``max(alloc)`` token-times, so idle
capacity (``alloc - sent`` and the spread between pairs) shows up as the
scheduling bubbles the paper describes.  A *decomposition* is an ordered
list of phases that together deliver the whole traffic matrix.
Counterpart of ``repro/core/types.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["Phase", "StackedPhases", "Decomposition"]


def _is_permutation(perm: np.ndarray) -> bool:
    n = perm.shape[0]
    if perm.size == 0:
        return True
    if perm.min() < 0 or perm.max() >= n:
        return False
    return bool(np.bincount(perm, minlength=n).max() == 1)


@dataclasses.dataclass(frozen=True)
class Phase:
    """perm[i] = destination of source i; alloc[i] / sent[i] = slot
    capacity and tokens transferred for pair (i, perm[i])."""

    perm: np.ndarray
    alloc: np.ndarray
    sent: np.ndarray

    def __post_init__(self) -> None:
        n = self.perm.shape[0]
        if not _is_permutation(self.perm):
            raise ValueError(f"perm is not a permutation: {self.perm}")
        if self.alloc.shape != (n,) or self.sent.shape != (n,):
            raise ValueError("alloc/sent must have shape [n]")
        if (self.sent - self.alloc > 1e-6).any():
            raise ValueError("sent exceeds alloc")

    @classmethod
    def unchecked(cls, perm: np.ndarray, alloc: np.ndarray, sent: np.ndarray) -> "Phase":
        """Construct without the invariant checks (decomposition fast paths,
        whose invariants hold by construction)."""
        p = object.__new__(cls)
        object.__setattr__(p, "perm", perm)
        object.__setattr__(p, "alloc", alloc)
        object.__setattr__(p, "sent", sent)
        return p

    @property
    def n(self) -> int:
        return int(self.perm.shape[0])

    @property
    def duration_tokens(self) -> float:
        """Circuit hold time in token units: the largest allocated slot."""
        return float(self.alloc.max()) if self.alloc.size else 0.0

    @property
    def tokens_sent(self) -> float:
        return float(self.sent.sum())

    def recv_tokens(self) -> np.ndarray:
        """Tokens received per destination rank in this phase."""
        out = np.zeros(self.n)
        np.add.at(out, self.perm, self.sent)
        return out

    def sent_matrix(self) -> np.ndarray:
        m = np.zeros((self.n, self.n))
        m[np.arange(self.n), self.perm] = self.sent
        return m


@dataclasses.dataclass(frozen=True)
class StackedPhases:
    """All phases as stacked ``[K, n]`` arrays (perms int64, alloc/sent f64)."""

    perms: np.ndarray
    alloc: np.ndarray
    sent: np.ndarray

    @property
    def num_phases(self) -> int:
        return int(self.perms.shape[0])

    @property
    def n(self) -> int:
        return int(self.perms.shape[1])

    def durations(self) -> np.ndarray:
        """Circuit hold time per phase: the largest allocated slot. [K]"""
        if self.num_phases == 0:
            return np.zeros(0)
        return self.alloc.max(axis=1)

    def recv_tokens(self) -> np.ndarray:
        """Tokens received per destination rank per phase. [K, n]"""
        k, n = self.perms.shape
        out = np.zeros((k, n))
        if k:
            rows = np.repeat(np.arange(k), n)
            np.add.at(out, (rows, self.perms.ravel()), self.sent.ravel())
        return out

    def sent_matrix_total(self) -> np.ndarray:
        """Sum of per-phase sent matrices. [n, n]"""
        n = self.n
        total = np.zeros((n, n))
        if self.num_phases:
            src = np.tile(np.arange(n), self.num_phases)
            np.add.at(total, (src, self.perms.ravel()), self.sent.ravel())
        return total

    def to_phases(self) -> list[Phase]:
        return [
            Phase(perm=self.perms[k], alloc=self.alloc[k], sent=self.sent[k])
            for k in range(self.num_phases)
        ]

    @staticmethod
    def from_phases(phases: list[Phase], n: int) -> "StackedPhases":
        if not phases:
            empty = np.zeros((0, n))
            return StackedPhases(np.zeros((0, n), dtype=np.int64), empty, empty)
        return StackedPhases(
            perms=np.stack([p.perm for p in phases]).astype(np.int64),
            alloc=np.stack([p.alloc for p in phases]).astype(np.float64),
            sent=np.stack([p.sent for p in phases]).astype(np.float64),
        )


@dataclasses.dataclass
class Decomposition:
    """An ordered sequence of phases delivering ``matrix``."""

    matrix: np.ndarray
    phases: list[Phase]
    strategy: str
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(self.matrix.shape[0])

    @property
    def num_phases(self) -> int:
        return len(self.phases)

    @property
    def total_duration_tokens(self) -> float:
        return float(sum(p.duration_tokens for p in self.phases))

    def stacked(self) -> StackedPhases:
        """Stacked ``[K, n]`` view of the phases (built once, then cached)."""
        cached = getattr(self, "_stacked_cache", None)
        if cached is None or cached.num_phases != len(self.phases):
            cached = StackedPhases.from_phases(self.phases, self.n)
            self._stacked_cache = cached
        return cached

    def sent_total(self) -> np.ndarray:
        return self.stacked().sent_matrix_total()

    def verify(self, *, atol: float = 1e-6) -> None:
        """All demand delivered, nothing invented."""
        delivered = self.sent_total()
        if not np.allclose(delivered, self.matrix, atol=atol):
            diff = np.abs(delivered - self.matrix).max()
            raise AssertionError(f"{self.strategy}: delivered != demand (max err {diff:.3g})")

    def reordered(self, order: list[int] | np.ndarray) -> "Decomposition":
        """Same phases in another execution order.  Valid only where a
        phase's ``sent`` does not depend on the order (max-weight clears
        entries in full; BvN's framed delivery is order-dependent, so
        reorder it before delivery)."""
        phases = [self.phases[i] for i in order]
        return Decomposition(self.matrix, phases, self.strategy, dict(self.meta))

"""Shared types for traffic-matrix decompositions (numpy, host side).

A *phase* is one circuit configuration: a permutation ``perm`` over ``n``
ranks, the per-pair slot ``alloc`` (tokens) and the tokens actually
``sent``.  A *decomposition* is an ordered list of phases that together
deliver the whole traffic matrix.  Counterpart of ``repro/core/types.py``.
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

    def stacked(self) -> StackedPhases:
        """Stacked ``[K, n]`` view of the phases (built once, then cached)."""
        cached = getattr(self, "_stacked_cache", None)
        if cached is None or cached.num_phases != len(self.phases):
            cached = StackedPhases.from_phases(self.phases, self.n)
            self._stacked_cache = cached
        return cached

    def verify(self, *, atol: float = 1e-6) -> None:
        """All demand delivered, nothing invented."""
        delivered = self.stacked().sent_matrix_total()
        if not np.allclose(delivered, self.matrix, atol=atol):
            diff = np.abs(delivered - self.matrix).max()
            raise AssertionError(f"{self.strategy}: delivered != demand (max err {diff:.3g})")

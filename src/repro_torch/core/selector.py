"""Online schedule selection under routing drift: the OCS-controller loop.

A selector keeps a small library of schedules planned for the traffic
regimes it has seen, scores each observation against it, and switches
schedules when another entry serves the live traffic better.  A switch
refills the device table from the stored plan; a miss costs one
(warm-started) re-plan.  Scoring is vectorized: each entry keeps its
``[n, n]`` capacity matrix, planned drops against traffic ``off`` are
``max(off - caps, 0)`` (the per-phase clamping telescopes exactly), and
the whole library is scored in one stacked pass.  The library is LRU
bounded.  Counterpart of ``repro/core/selector.py``: the same policy, so
the same decisions on the same observations.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.decompose import decompose
from repro_torch.core.maxweight import WarmState, warm_state_of
from repro_torch.core.schedule import A2ASchedule, plan_schedule

__all__ = [
    "DEFAULT_PLAN_KWARGS",
    "Proposal",
    "ScheduleEntry",
    "ScheduleSelector",
]

# plan_schedule defaults shared by the selector's inline re-plan and the
# runtime's batched re-plan, so both plan identically
DEFAULT_PLAN_KWARGS = {"slack": 1.1, "quantum": 8, "min_cap": 8}


@dataclasses.dataclass
class ScheduleEntry:
    name: str
    reference: np.ndarray  # traffic matrix the schedule was planned for
    schedule: A2ASchedule
    caps: np.ndarray | None = None  # [n, n] per-pair capacity (lazy)

    def __post_init__(self):
        if self.caps is None:
            self.caps = self.schedule.cap_matrix()

    def mismatch(self, observed: np.ndarray) -> float:
        """Relative L1 distance between normalized traffic shapes."""
        a = self.reference / max(self.reference.sum(), 1e-9)
        b = observed / max(observed.sum(), 1e-9)
        return float(np.abs(a - b).sum() / 2.0)

    def drop_fraction(self, observed: np.ndarray) -> float:
        """Planned token-drop rate if this schedule served ``observed``."""
        off = observed.copy()
        np.fill_diagonal(off, 0.0)
        return self._drop_from_off(off, off.sum())

    def _drop_from_off(self, off: np.ndarray, total: float) -> float:
        """``drop_fraction`` of a diagonal-zeroed matrix with its total."""
        if total <= 0:
            return 0.0
        return float(np.maximum(off - self.caps, 0.0).sum() / total)

    def drop_fraction_reference(self, observed: np.ndarray) -> float:
        """The per-phase loop: the fast path's parity oracle."""
        off = observed.copy()
        np.fill_diagonal(off, 0.0)
        rem = off.copy()
        s = self.schedule
        idx = np.arange(s.n)
        for k in range(s.num_phases):
            sel = s.valid[k]
            vols = rem[idx[sel], s.perms[k][sel]]
            rem[idx[sel], s.perms[k][sel]] = np.maximum(vols - int(s.caps[k]), 0)
        total = off.sum()
        return float(rem.sum() / total) if total > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class Proposal:
    """Outcome of scoring one observation without re-planning.

    ``action``: ``"keep"`` (the current entry still serves, or nothing
    better is admissible under hysteresis/cooldown), ``"switch"`` (adopt a
    better library entry) or ``"miss"`` (no entry serves: plan anew and
    ``register`` it).  ``entry`` is the entry for keep/switch (None on a
    miss with an empty library); ``drop`` its planned drop fraction.
    """

    action: str
    entry: ScheduleEntry | None
    drop: float


class ScheduleSelector:
    """Maintain a schedule library; pick or re-plan per observed traffic.

    Args:
      n: EP ranks.
      strategy: decomposition strategy for (re)planning.
      drop_tolerance: acceptable planned drop rate before switching.
      ema: smoothing of the observed traffic (drift filter).
      hysteresis: relative drop improvement an entry must offer before the
        selector switches away from the current one (0: any strictly
        better entry wins).
      cooldown: observations after a re-plan during which ``propose``
        never returns a miss.
      replan_penalty: drop-fraction-equivalent cost of a swap's
        reconfiguration dark window: a switch must save at least this
        much, and a miss is declined when even a perfect plan could not
        repay it.
      max_library: LRU bound on the library (floored at 2: the current
        entry is never evicted).
      on_evict: optional ``fn(entry)`` called when the bound evicts one.
    """

    def __init__(
        self,
        n: int,
        *,
        strategy: str = "maxweight",
        drop_tolerance: float = 0.02,
        ema: float = 0.3,
        hysteresis: float = 0.0,
        cooldown: int = 0,
        replan_penalty: float = 0.0,
        plan_kwargs: dict | None = None,
        max_library: int = 16,
        on_evict=None,
    ):
        self.n = n
        self.strategy = strategy
        self.drop_tolerance = drop_tolerance
        self.ema = ema
        self.hysteresis = hysteresis
        self.cooldown = cooldown
        if replan_penalty < 0.0:
            raise ValueError("replan_penalty must be >= 0")
        self.replan_penalty = replan_penalty
        self._cooldown_left = 0
        self.plan_kwargs = dict(DEFAULT_PLAN_KWARGS)
        if plan_kwargs:
            self.plan_kwargs.update(plan_kwargs)
        self.on_evict = on_evict
        self.library: list[ScheduleEntry] = []
        self.current: ScheduleEntry | None = None
        self.smoothed: np.ndarray | None = None
        self.replans = 0
        self.switches = 0
        self.evictions = 0
        self.max_library = max(2, max_library)
        self._caps_stack: np.ndarray | None = None  # [L, n, n] cache
        self._last_used: dict[int, int] = {}  # id(entry) -> step
        self._step = 0
        self._warm: WarmState | None = None

    def _touch(self, entry: ScheduleEntry) -> None:
        self._last_used[id(entry)] = self._step

    def _plan(self, traffic: np.ndarray, name: str) -> ScheduleEntry:
        kwargs = {"min_fill": 0.1}
        if self.strategy == "maxweight" and self._warm is not None:
            kwargs["warm_start"] = self._warm
        d = decompose(traffic, self.strategy, **kwargs)
        if self.strategy == "maxweight":
            self._warm = warm_state_of(d)
        entry = ScheduleEntry(name=name, reference=traffic.copy(), schedule=plan_schedule(d, **self.plan_kwargs))
        self.register(entry, make_current=False)
        return entry

    def register(self, entry: ScheduleEntry, *, make_current: bool = True) -> None:
        """Insert an externally planned entry (the runtime's batched re-plan)
        and optionally adopt it; starts the re-plan cooldown window."""
        if len(self.library) >= self.max_library:
            self._evict()
        self.library.append(entry)
        self._caps_stack = None
        self._touch(entry)
        self.replans += 1
        self._cooldown_left = self.cooldown
        if make_current:
            self.adopt(entry)

    def adopt(self, entry: ScheduleEntry) -> bool:
        """Make ``entry`` current.  Returns True if it changed."""
        changed = entry is not self.current
        if changed and self.current is not None:
            self.switches += 1
        self.current = entry
        self._touch(entry)
        return changed

    def purge(self) -> None:
        """Forget every entry, the current schedule and the smoothed
        traffic (a link-availability change: plans routed for another
        mask must never be re-adopted).  The caller re-plans next."""
        self.library = []
        self.current = None
        self.smoothed = None
        self._caps_stack = None
        self._last_used = {}

    def _evict(self) -> None:
        """Drop the least-recently-used entry (never the current one)."""
        candidates = [e for e in self.library if e is not self.current]
        if not candidates:
            return
        victim = min(candidates, key=lambda e: self._last_used.get(id(e), -1))
        self.library.remove(victim)
        self._last_used.pop(id(victim), None)
        self._caps_stack = None
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(victim)

    def _score_library(self, off: np.ndarray) -> np.ndarray:
        """Planned drop rate of every library entry in one stacked pass."""
        if self._caps_stack is None or self._caps_stack.shape[0] != len(self.library):
            self._caps_stack = np.stack([e.caps for e in self.library])
        total = off.sum()
        if total <= 0:
            return np.zeros(len(self.library))
        dropped = np.maximum(off[None, :, :] - self._caps_stack, 0.0).sum(axis=(1, 2))
        return dropped / total

    def propose(self, traffic: np.ndarray) -> Proposal:
        """Score one observation WITHOUT re-planning: the EMA filter, then
        the hysteresis/cooldown policy.  The caller handles a ``"miss"`` by
        planning and calling ``register``; ``observe`` does it inline."""
        t = np.asarray(traffic, dtype=np.float64)
        self._step += 1
        if self.smoothed is None:
            self.smoothed = t.copy()
        else:
            self.smoothed = (1 - self.ema) * self.smoothed + self.ema * t
        in_cooldown = self._cooldown_left > 0
        self._cooldown_left = max(0, self._cooldown_left - 1)

        off = self.smoothed.copy()
        np.fill_diagonal(off, 0.0)
        total = off.sum()
        cur_drop = float("inf")
        if self.current is not None:
            cur_drop = self.current._drop_from_off(off, total)
            if cur_drop <= self.drop_tolerance:
                self._touch(self.current)
                return Proposal("keep", self.current, cur_drop)
        best, best_drop = None, float("inf")
        if self.library:
            drops = self._score_library(off)
            k = int(np.argmin(drops))
            best, best_drop = self.library[k], float(drops[k])
        # a switch needs a relative improvement of at least `hysteresis` and
        # a drop saving that repays the swap's dark window; a fresh plan
        # also needs the cooldown window to have elapsed
        improves = best is not None and best is not self.current and (
            cur_drop == float("inf")
            or (best_drop <= cur_drop * (1.0 - self.hysteresis) and cur_drop - best_drop >= self.replan_penalty)
        )
        if improves and best_drop <= self.drop_tolerance:
            return Proposal("switch", best, best_drop)
        if best_drop <= self.drop_tolerance and self.current is not None:
            # an entry serves, but not enough better than the current one
            self._touch(self.current)
            return Proposal("keep", self.current, cur_drop)
        if in_cooldown:
            if improves:
                return Proposal("switch", best, best_drop)
            if self.current is not None:
                self._touch(self.current)
                return Proposal("keep", self.current, cur_drop)
        if self.replan_penalty > 0.0 and self.current is not None and cur_drop < self.replan_penalty:
            # even a perfect fresh plan saves less than its dark window costs
            self._touch(self.current)
            return Proposal("keep", self.current, cur_drop)
        return Proposal("miss", best, best_drop)

    def observe(self, traffic: np.ndarray) -> tuple[ScheduleEntry, bool]:
        """Feed one observation: (entry to use next, changed?)."""
        p = self.propose(traffic)
        entry = self._plan(self.smoothed, f"plan{self.replans}") if p.action == "miss" else p.entry
        changed = self.adopt(entry)
        return entry, changed

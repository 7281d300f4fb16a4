"""Deterministic fabric-fault scenarios and link-mask utilities (numpy).

* ``FaultScenario``: seeded fault timelines beside ``core.drift``'s
  ``DriftScenario``.  Per step it says which (src, dst) pairs are usable
  (``link_mask``) and how much slower degraded pairs are
  (``slow_matrix``, for a simulator).
* ``apply_link_mask``: reroutes a demand matrix around dead pairs.
  Masked entries get zero demand (so cap 0 after decomposition) and the
  displaced traffic goes proportionally to the source row's surviving
  off-diagonal destinations.
* ``check_schedule_mask``: host-side guard that a planned schedule never
  routes a dark pair; a violation raises ``FabricFaultError`` naming the
  backend, the pair, the phase and the next fabric in the degradation
  chain.
* ``fault_hook``: a per-step failure hook that turns a scenario into the
  error a fabric manager would surface (the first step whose plan
  crosses a dark link raises), and lifts the mask when the fault clears.

Counterpart of ``repro/core/faults.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "FabricFaultError",
    "FaultScenario",
    "NonFiniteLossError",
    "apply_link_mask",
    "check_schedule_mask",
    "fault_hook",
]

FAULT_KINDS = ("none", "dead_link", "link_flap", "slow_link", "dark_window")


class NonFiniteLossError(RuntimeError):
    """A training step produced a NaN/Inf loss: a training loop raises it so
    a poisoned step takes the same failure and rollback path as a crash."""


class FabricFaultError(RuntimeError):
    """A fabric transfer (or schedule validation) hit a dark link.

    Carries the rejecting ``backend``, the offending ``pair``/``phase``,
    the availability ``link_mask`` to re-plan under and the
    ``next_fabric`` in the degradation chain.
    """

    def __init__(
        self,
        message: str,
        *,
        backend: str | None = None,
        pair: tuple[int, int] | None = None,
        phase: int | None = None,
        step: int | None = None,
        link_mask: np.ndarray | None = None,
        next_fabric: str | None = None,
    ):
        super().__init__(message)
        self.backend = backend
        self.pair = pair
        self.phase = phase
        self.step = step
        self.link_mask = None if link_mask is None else np.asarray(link_mask, bool)
        self.next_fabric = next_fabric


@dataclasses.dataclass
class FaultScenario:
    """Deterministic, seeded fault timeline for an ``n_ranks`` fabric.

    kind:
      none        healthy fabric
      dead_link   sampled off-diagonal pairs go dark at ``onset`` forever
      link_flap   pairs go dark at ``onset`` and recover at ``onset + window``
      slow_link   pairs stay up but run ``slow_factor`` x slower during the
                  episode (simulator only; the mask stays all-True)
      dark_window every reconfiguration costs ``dark_window_steps`` stalled
                  steps / ``dark_window_us`` of fabric time (no outage)

    ``n_links`` directed off-diagonal pairs are picked; ``outage_frac > 0``
    overrides it as a fraction of the ``n * (n - 1)`` pairs.  The choice is
    a pure function of ``seed``.
    """

    kind: str
    n_ranks: int
    onset: int = 20
    window: int = 20
    n_links: int = 1
    outage_frac: float = 0.0
    slow_factor: float = 4.0
    dark_window_steps: int = 0
    dark_window_us: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.n_ranks < 2:
            raise ValueError("FaultScenario needs n_ranks >= 2")
        if not 0.0 <= self.outage_frac < 1.0:
            raise ValueError("outage_frac must be in [0, 1)")
        if self.slow_factor < 1.0:
            raise ValueError("slow_factor must be >= 1 (a multiplier on transfer time)")
        if self.kind == "dark_window" and self.dark_window_steps <= 0:
            self.dark_window_steps = 2
        n = self.n_ranks
        off_pairs = n * (n - 1)
        k = self.n_links
        if self.outage_frac > 0.0:
            k = max(1, int(round(self.outage_frac * off_pairs)))
        k = min(k, off_pairs - 1)  # never kill every off-diagonal pair
        rng = np.random.default_rng(self.seed)
        flat = rng.permutation(off_pairs)[:k]
        pairs = []
        for f in np.sort(flat):
            i, r = divmod(int(f), n - 1)
            j = r if r < i else r + 1  # skip the diagonal slot
            pairs.append((i, j))
        self._pairs = tuple(pairs)

    @property
    def dead_pairs(self) -> tuple[tuple[int, int], ...]:
        """The directed (src, dst) pairs this scenario degrades."""
        return self._pairs

    def active(self, step: int) -> bool:
        """Is the fault episode engaged at ``step``?"""
        if self.kind in ("none", "dark_window"):
            return False
        if self.kind == "dead_link":
            return step >= self.onset
        return self.onset <= step < self.onset + self.window

    def link_mask(self, step: int) -> np.ndarray:
        """``[n, n]`` bool availability (True = usable) at ``step``; the
        diagonal is always usable and ``slow_link`` darkens nothing."""
        mask = np.ones((self.n_ranks, self.n_ranks), dtype=bool)
        if self.kind == "slow_link" or not self.active(step):
            return mask
        for i, j in self._pairs:
            mask[i, j] = False
        np.fill_diagonal(mask, True)
        return mask

    def slow_matrix(self, step: int) -> np.ndarray:
        """``[n, n]`` per-pair transfer-time multiplier (>= 1) at ``step``."""
        slow = np.ones((self.n_ranks, self.n_ranks), dtype=np.float64)
        if self.kind == "slow_link" and self.active(step):
            for i, j in self._pairs:
                slow[i, j] = self.slow_factor
        return slow


def apply_link_mask(matrix, link_mask, *, meta: dict | None = None) -> np.ndarray:
    """Route a demand matrix around dead pairs.

    Masked entries are zeroed and each source row's displaced demand is
    spread proportionally over the row's surviving off-diagonal
    destinations (uniformly when they carried none).  Demand of a row with
    no surviving destination is unroutable and dropped; its total goes to
    ``meta['unroutable_tokens']`` when ``meta`` is given.  Idempotent.
    """
    a = np.array(matrix, dtype=np.float64, copy=True)
    m = np.asarray(link_mask, dtype=bool)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected a square demand matrix, got shape {a.shape}")
    if m.shape != a.shape:
        raise ValueError(f"link_mask shape {m.shape} does not match demand shape {a.shape}")
    n = a.shape[0]
    off_diag = ~np.eye(n, dtype=bool)
    dead = (~m) & off_diag  # the diagonal never routes over the fabric
    displaced = np.where(dead, a, 0.0).sum(axis=1)
    a[dead] = 0.0
    unroutable = 0.0
    for i in np.nonzero(displaced > 0)[0]:
        avail = m[i] & off_diag[i]
        if not avail.any():
            unroutable += displaced[i]
            continue
        weights = np.where(avail, a[i], 0.0)
        total = weights.sum()
        if total > 0:
            weights = weights / total
        else:
            weights = avail / avail.sum()
        a[i] += displaced[i] * weights
    if meta is not None:
        meta["unroutable_tokens"] = float(unroutable)
    return a


def _iter_phase_schedules(schedules):
    """Yield the objects with ``perms``/``valid`` in a schedule container."""
    if schedules is None:
        return
    if hasattr(schedules, "perms"):
        yield schedules
        return
    for s in schedules:
        if s is not None and hasattr(s, "perms"):
            yield s


def check_schedule_mask(
    schedules,
    link_mask,
    *,
    backend: str | None = None,
    next_fabric: str | None = None,
    step: int | None = None,
) -> None:
    """Raise ``FabricFaultError`` if any planned phase crosses a dark pair.

    Takes one ``A2ASchedule``-like object (``perms``/``valid`` host arrays)
    or an iterable of them."""
    mask = np.asarray(link_mask, dtype=bool)
    if mask.all():
        return
    for sched in _iter_phase_schedules(schedules):
        perms = np.asarray(sched.perms, dtype=np.int64)
        valid = np.asarray(sched.valid, dtype=bool)
        if perms.ndim != 2:
            continue
        n = perms.shape[1]
        src = np.arange(n)
        crossing = valid & ~mask[src[None, :], perms]
        if not crossing.any():
            continue
        k, i = map(int, np.argwhere(crossing)[0])
        j = int(perms[k, i])
        who = backend or getattr(sched, "name", None) or "fabric"
        at = f" at step {step}" if step is not None else ""
        hint = (
            f"; falling back to {next_fabric!r} (next in the degradation chain)"
            if next_fabric
            else "; no fallback fabric declared"
        )
        raise FabricFaultError(
            f"{who}: link ({i} -> {j}) is dark{at} but phase {k} of the "
            f"active schedule routes it — re-plan with the availability "
            f"mask so the pair gets cap 0{hint}",
            backend=who,
            pair=(i, j),
            phase=k,
            step=step,
            link_mask=mask,
            next_fabric=next_fabric,
        )


def fault_hook(scenario: FaultScenario, runtime, *, backend: str | None = None):
    """A per-step failure hook that injects ``scenario`` into ``runtime``.

    Per step it compares the scenario's mask with the runtime's plans:

    * the fault clears: lift the runtime's link mask (re-plan back to the
      preferred routing);
    * the outage is already routed around (same mask): nothing;
    * the active plan crosses a dark pair: raise ``FabricFaultError`` with
      the mask attached (the caller rolls back, the runtime quarantines
      and re-plans under the mask, and the retried step passes);
    * the outage is engaged but no plan touches it: adopt the mask.

    The scenario clock is monotonic across rollbacks: the hook keys the
    scenario on the highest step it has seen, since replaying old data
    does not heal a fabric.
    """
    high_water = [-1]

    def hook(step: int) -> None:
        high_water[0] = max(high_water[0], int(step))
        mask = scenario.link_mask(high_water[0])
        if mask.all():
            if runtime.link_mask is not None:
                runtime.set_link_mask(None)
            return
        if runtime.link_mask is not None and np.array_equal(runtime.link_mask, mask):
            return
        next_fab = runtime.next_fabric() if hasattr(runtime, "next_fabric") else None
        check_schedule_mask(
            runtime.schedules,
            mask,
            backend=backend or runtime.active_fabric(),
            next_fabric=next_fab,
            step=step,
        )
        # plans already avoid the dark pairs: adopt the mask so the next
        # re-plan keeps avoiding them
        runtime.set_link_mask(mask)

    return hook

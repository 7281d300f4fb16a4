"""Scheduler runtime: the closed controller loop (observe -> score ->
re-plan -> swap) that tracks MoE routing drift between rounds or steps.

* **observe**: routing counts ``[L, n_src, E]`` are folded to per-layer
  ``[n, n]`` rank traffic by the contiguous expert placement, then
  EMA-smoothed per layer.
* **score**: each layer *group* has a ``ScheduleSelector`` that scores
  its traffic against the group's library under the hysteresis/cooldown
  policy; a group whose library misses declares a drift event.
* **re-plan**: one ``decompose_batch`` call re-plans every MoE layer with
  per-layer ``WarmState`` replay, so a steady-state re-plan solves no
  assignment problem.
* **swap**: ``table()`` folds the per-layer plans into the fixed-shape
  device ``ScheduleTable``.  While the phase envelope is unchanged the
  new plans are copied into the SAME device tensors (``fill_``), so a
  consumer holding them (a captured decode step) sees the swap with no
  new buffers; only an envelope growth or shrink builds new tensors
  (``table_rebuilds`` = 1 + ``envelope_growths`` + ``envelope_shrinks``),
  where the JAX package recompiles.

``group_by="layer"`` plans one schedule per MoE layer; ``"model"`` shares
one across all MoE layers while tracking per-layer traffic and warm
states.  Planning is numpy/scipy on the host, with the same operations in
the same order as ``repro/core/runtime.py``, so the same observations
give the same decisions and tables.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.decompose import decompose_batch
from repro_torch.core.drift import DriftScenario
from repro_torch.core.faults import apply_link_mask
from repro_torch.core.maxweight import WarmState, warm_state_of
from repro_torch.core.schedule import ScheduleTable, phase_envelope, plan_schedule
from repro_torch.core.selector import DEFAULT_PLAN_KWARGS, Proposal, ScheduleEntry, ScheduleSelector

__all__ = [
    "ControllerConfig",
    "Decision",
    "ScheduleRuntime",
    "make_serving_controller",
    "routing_to_traffic",
]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs for the drift controller.

    Args:
      n_ranks: EP fabric size the schedules are planned for (on one device
        a *virtual* rank count; experts map to ranks by contiguous blocks).
      n_experts: router width E (divisible by ``n_ranks``).
      strategy: decomposition strategy for re-planning.
      drop_tolerance: planned drop rate above which a group's schedule no
        longer serves and the library is consulted.
      ema: per-layer traffic smoothing applied by the runtime.
      hysteresis: relative drop improvement required to switch entries.
      cooldown: observations after a re-plan during which further misses
        are suppressed.
      replan_penalty: drop-fraction-equivalent cost of a swap's dark
        window, forwarded to every group selector.
      group_by: "layer" (one schedule per MoE layer) or "model" (shared).
      min_fill: decomposition min_fill (defer near-empty pairs).
      plan_kwargs: forwarded to ``plan_schedule`` (slack/quantum/min_cap).
      max_library: LRU bound per group library.
      k_max: phase-slot budget of the table (its static K dim); longer
        plans are clipped to their heaviest ``k_max`` phases
        (``phase_clips``).  Default ``n_ranks``.
      envelope_slack: headroom on the phase envelope the runtime derives
        from its plans (the static per-phase buffer bound).  Each growth
        builds new table tensors; 0 disables the envelope.
      envelope_decay: shrink threshold (0: the envelope only grows).  A
        slot whose slacked need stays below ``envelope_decay *
        envelope[k]`` for ``shrink_patience`` consecutive table rebuilds
        shrinks to the peak slacked need since the envelope last changed.
      shrink_patience: consecutive underused rebuilds before a shrink.
      fallback_chain: degradation chain of fabric dispatch names, preferred
        first.  Empty disables the health FSM's fabric switching.
      quarantine_after: consecutive anomalous observations before a soft
        quarantine demotes the active fabric one position.
      drop_spike_frac: dropped/routed fraction above which an observation
        counts as a dropped-token spike.
      probe_backoff: observations after a quarantine before the preferred
        fabric is probed again; doubles per failed probe up to
        ``probe_backoff_max``.
      recover_after: consecutive clean observations required to start a
        probe and to declare it successful.
    """

    n_ranks: int
    n_experts: int
    strategy: str = "maxweight"
    drop_tolerance: float = 0.05
    ema: float = 0.3
    hysteresis: float = 0.1
    cooldown: int = 5
    replan_penalty: float = 0.0
    group_by: str = "layer"
    min_fill: float = 0.1
    plan_kwargs: dict | None = None
    max_library: int = 16
    k_max: int | None = None
    envelope_slack: float = 1.5
    envelope_decay: float = 0.0
    shrink_patience: int = 3
    fallback_chain: tuple[str, ...] = ()
    quarantine_after: int = 2
    drop_spike_frac: float = 0.25
    probe_backoff: int = 8
    probe_backoff_max: int = 512
    recover_after: int = 3

    def __post_init__(self):
        if self.n_experts % self.n_ranks:
            raise ValueError(f"{self.n_experts} experts not divisible by {self.n_ranks} ranks")
        if self.group_by not in ("layer", "model"):
            raise ValueError(f"unknown group_by {self.group_by!r}")
        if self.replan_penalty < 0.0:
            raise ValueError("replan_penalty must be >= 0")
        if not 0.0 <= self.envelope_decay < 1.0:
            raise ValueError(
                f"envelope_decay must be in [0, 1) (got {self.envelope_decay}): it is the fraction of the "
                "current envelope below which a slot counts as underused"
            )
        if self.shrink_patience < 1:
            raise ValueError(
                f"shrink_patience must be >= 1 (got {self.shrink_patience}): 0 would shrink every slot on "
                "any non-growth rebuild"
            )
        if not isinstance(self.fallback_chain, tuple):
            object.__setattr__(self, "fallback_chain", tuple(self.fallback_chain))
        if any(not (isinstance(f, str) and f) for f in self.fallback_chain):
            raise ValueError("fallback_chain must be a tuple of fabric dispatch names")
        if len(set(self.fallback_chain)) != len(self.fallback_chain):
            raise ValueError(f"fallback_chain repeats a fabric: {self.fallback_chain}")
        if self.quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")
        if not 0.0 < self.drop_spike_frac <= 1.0:
            raise ValueError("drop_spike_frac must be in (0, 1]")
        if self.probe_backoff < 1 or self.probe_backoff_max < self.probe_backoff:
            raise ValueError(
                f"need 1 <= probe_backoff <= probe_backoff_max (got {self.probe_backoff}, {self.probe_backoff_max})"
            )
        if self.recover_after < 1:
            raise ValueError("recover_after must be >= 1")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One ``observe`` outcome.  ``changed``: the per-group assignment moved
    (fetch ``table()``); ``key``: per-group current entry names;
    ``replanned``: this observation ran the batched re-plan; ``actions``:
    per-group "keep"/"switch"/"miss"."""

    changed: bool
    replanned: bool
    key: tuple
    actions: tuple[str, ...]


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


def make_serving_controller(
    model_cfg,
    *,
    n_ranks: int,
    drift: str = "shift",
    rounds: int = 1,
    ema: float = 0.6,
    cooldown: int = 1,
    group_by: str = "model",
    replan_penalty: float = 0.0,
    plan_kwargs: dict | None = None,
    drift_seed: int = 0,
    device: torch.device | str = "cpu",
):
    """``(runtime, scenario)`` for serving: a round-granularity
    ``ControllerConfig`` (fast EMA, short cooldown, one shared plan, since
    round estimates are global) on ``device`` (a ``HierarchicalRuntime``
    for ``dispatch="hierarchical"``), and the ``DriftScenario``
    that synthesizes the request mix.  ``(None, None)`` when the arch has
    no MoE or its expert count does not tile ``n_ranks``."""
    cfg = model_cfg
    if cfg.moe is None or cfg.moe.n_experts % n_ranks:
        return None, None
    ctrl_cfg = ControllerConfig(
        n_ranks=n_ranks,
        n_experts=cfg.moe.n_experts,
        ema=ema,
        cooldown=cooldown,
        replan_penalty=replan_penalty,
        plan_kwargs=plan_kwargs,
        group_by=group_by,
    )
    if cfg.moe.dispatch == "hierarchical":
        # two-level controller: each level re-plans on its own half of the traffic
        from repro_torch.core.hierarchical import HierarchicalRuntime

        runtime = HierarchicalRuntime(ctrl_cfg, cfg.n_moe_layers, pod_size=cfg.moe.pod_size, device=device)
    else:
        runtime = ScheduleRuntime(ctrl_cfg, cfg.n_moe_layers, device=device)
    scenario = DriftScenario(
        drift, cfg.moe.n_experts, shift_step=max(rounds // 2, 1), window=max(rounds // 2, 1), seed=drift_seed
    )
    return runtime, scenario


class ScheduleRuntime:
    """Owns the controller loop for ``n_moe_layers`` MoE layers; its table
    lives on ``device``."""

    def __init__(self, cfg: ControllerConfig, n_moe_layers: int, *, device: torch.device | str = "cpu"):
        if n_moe_layers < 1:
            raise ValueError("runtime needs at least one MoE layer")
        self.cfg = cfg
        self.n_layers = n_moe_layers
        self.device = torch.device(device)
        if cfg.group_by == "layer":
            self.groups: list[list[int]] = [[l] for l in range(n_moe_layers)]
        else:
            self.groups = [list(range(n_moe_layers))]
        self.selectors = [
            ScheduleSelector(
                cfg.n_ranks,
                strategy=cfg.strategy,
                drop_tolerance=cfg.drop_tolerance,
                ema=1.0,  # the runtime smooths per layer; don't smooth twice
                hysteresis=cfg.hysteresis,
                cooldown=cfg.cooldown,
                replan_penalty=cfg.replan_penalty,
                plan_kwargs=cfg.plan_kwargs,
                max_library=cfg.max_library,
                on_evict=self._on_evict,
            )
            for _ in self.groups
        ]
        self._plan_kwargs = dict(DEFAULT_PLAN_KWARGS)
        if cfg.plan_kwargs:
            self._plan_kwargs.update(cfg.plan_kwargs)
        self._smoothed: np.ndarray | None = None  # [L, n, n]
        self._warm: list[WarmState | None] = [None] * n_moe_layers
        self._group_warm: list[WarmState | None] = [None] * len(self.groups)
        self._key: tuple = ()
        self._k_max = cfg.k_max or cfg.n_ranks
        self._table: ScheduleTable | None = None
        self._table_key: tuple | None = None
        self._clipped_entries: set[str] = set()
        # phase envelope, growth-biased: it grows whenever a plan exceeds
        # it and (with envelope_decay) shrinks a slot after shrink_patience
        # consecutive underused rebuilds; either change builds new table
        # tensors.  None until the first table.
        self._envelope: np.ndarray | None = None
        self._env_underused: np.ndarray | None = None  # per-slot streak
        self._env_need_peak: np.ndarray | None = None  # shrink target
        self.steps = 0
        self.replan_events = 0
        self.decompose_calls = 0
        self.warm_hits = 0
        self.cold_plans = 0
        self.phase_clips = 0  # plans that exceeded the k_max slot budget
        self.envelope_growths = 0
        self.envelope_shrinks = 0
        self.table_rebuilds = 0  # tables built as new tensors (the rest refill in place)
        self.admitted_dropped = 0.0  # plan-admitted tokens cut at packing
        self.observe_s = 0.0  # host time inside observe()
        self.fetch_s = 0.0  # observe() time materializing its inputs on the host
        self.score_s = 0.0  # observe() time scoring/selecting/re-planning
        self.replan_s = 0.0  # host time inside re-plan events
        self.last_event: dict | None = None
        # health FSM: HEALTHY (chain_pos 0) -> DEGRADED (chain_pos > 0)
        # -> PROBING (back at pos 0 on trial) -> HEALTHY | DEGRADED
        self._link_mask: np.ndarray | None = None  # [n, n] bool, True = up
        self._chain_pos = 0
        self._anomaly_streak = 0
        self._clean_streak = 0
        self._drop_ema: float | None = None  # baseline dropped/routed fraction
        self._clip_streak = 0
        self._last_phase_clips = 0
        self._probe_at: int | None = None
        self._probe_return_pos = 0
        self._probing = False
        self._backoff = cfg.probe_backoff
        self.faults = None  # attached faults.FaultScenario (or None)
        self.quarantines = 0
        self.probe_failures = 0
        self.fabric_faults = 0
        self.masked_replans = 0
        self.dark_window_steps = 0
        self.last_fault: dict | None = None

    def _on_evict(self, entry) -> None:
        """Selector LRU eviction: forget the entry's clipped-plan mark, so a
        plan later registered under a reused name is counted again."""
        self._clipped_entries.discard(entry.name)

    # ---------------------------------------------------------------- state
    @property
    def schedules(self) -> tuple | None:
        """Per-MoE-layer ``A2ASchedule`` tuple, or None before the first
        plan (``group_by="model"`` repeats the shared schedule)."""
        if any(sel.current is None for sel in self.selectors):
            return None
        out = [None] * self.n_layers
        for group, sel in zip(self.groups, self.selectors):
            for l in group:
                out[l] = sel.current.schedule
        return tuple(out)

    @property
    def schedule_key(self) -> tuple:
        """Each group's current entry name (``plan{event}.g{group}``)."""
        return tuple(sel.current.name if sel.current is not None else "" for sel in self.selectors)

    def envelope(self) -> np.ndarray | None:
        """The current phase envelope (token units, [k_max]), or None."""
        return None if self._envelope is None else self._envelope.copy()

    # ------------------------------------------------- faults / health FSM
    @property
    def link_mask(self) -> np.ndarray | None:
        """The active ``[n, n]`` availability mask, or None when healthy."""
        return None if self._link_mask is None else self._link_mask.copy()

    def attach_faults(self, scenario) -> None:
        """Attach a ``faults.FaultScenario``: its reconfiguration dark
        window is charged to ``dark_window_steps`` on every re-plan."""
        self.faults = scenario

    def set_link_mask(self, mask: np.ndarray | None) -> None:
        """Adopt (or clear) a link availability mask and re-plan under it.

        With a mask set every re-plan routes around the dead pairs, and the
        phase envelope is FROZEN (no new table tensors mid-incident: plans
        that outgrow it clamp at admission).  Clearing the mask re-plans
        back to the preferred routing."""
        if mask is None:
            if self._link_mask is None:
                return
            self._link_mask = None
        else:
            m = np.asarray(mask, dtype=bool).copy()
            n = self.cfg.n_ranks
            if m.shape != (n, n):
                raise ValueError(f"link_mask shape {m.shape} does not match the [{n}, {n}] fabric")
            np.fill_diagonal(m, True)  # local traffic never uses the fabric
            if self._link_mask is not None and np.array_equal(m, self._link_mask):
                return
            self._link_mask = m
            self.masked_replans += 1
        # plans routed for another mask must never be re-adopted, and the
        # selectors' EMAs reseed from the routable demand
        for sel in self.selectors:
            sel.purge()
        if self._smoothed is None:
            return  # nothing planned yet; the first plan honours the mask
        proposals = [Proposal("miss", None, float("inf")) for _ in self.selectors]
        self._replan(proposals)
        # the caller refreshes table() on the fault path; sync the key so
        # the next observe does not count this swap again
        self._key = self.schedule_key

    def record_fault(self, err: Exception) -> None:
        """React to a hard fabric fault: quarantine at once and, when the
        error carries a mask (``FabricFaultError``), re-plan around it."""
        self.fabric_faults += 1
        mask = getattr(err, "link_mask", None)
        if mask is not None:
            self.set_link_mask(mask)
        self._quarantine(f"{type(err).__name__}: {err}")

    def active_fabric(self) -> str | None:
        """The dispatch name the FSM wants live, or None without a chain."""
        if not self.cfg.fallback_chain:
            return None
        return self.cfg.fallback_chain[self._chain_pos]

    def next_fabric(self) -> str | None:
        """The fabric a further quarantine would fall back to."""
        chain = self.cfg.fallback_chain
        if not chain or self._chain_pos + 1 >= len(chain):
            return None
        return chain[self._chain_pos + 1]

    @property
    def fallback_active(self) -> bool:
        return bool(self.cfg.fallback_chain) and self._chain_pos > 0

    @property
    def health_state(self) -> str:
        if self._probing:
            return "PROBING"
        return "DEGRADED" if self.fallback_active else "HEALTHY"

    def _quarantine(self, reason: str) -> None:
        """Demote the active fabric one position and arm the probe timer."""
        self.quarantines += 1
        self._anomaly_streak = 0
        self._clean_streak = 0
        chain = self.cfg.fallback_chain
        if self._probing:
            # the anomaly hit mid-probe: back to where the probe came from,
            # double the wait
            self.probe_failures += 1
            self._backoff = min(self._backoff * 2, self.cfg.probe_backoff_max)
            self._chain_pos = self._probe_return_pos
            self._probing = False
        elif chain and self._chain_pos + 1 < len(chain):
            self._chain_pos += 1
        self._probe_at = self.steps + self._backoff
        self.last_fault = {
            "step": self.steps,
            "reason": reason,
            "fabric": self.active_fabric(),
            "state": self.health_state,
        }

    def _health(self, *, loss: float | None, dropped_total: float | None, routed_total: float) -> None:
        """One FSM tick per observation: classify it as clean or anomalous,
        then advance HEALTHY/DEGRADED/PROBING."""
        reasons = []
        if loss is not None and not np.isfinite(loss):
            reasons.append("non-finite loss")
        if dropped_total is not None and routed_total > 0:
            # a drop SPIKE, not a level: past both the configured floor and
            # 3x its own running baseline (the first observation seeds it)
            frac = dropped_total / routed_total
            if self._drop_ema is not None and (
                frac > self.cfg.drop_spike_frac and frac > 3.0 * self._drop_ema + 0.01
            ):
                reasons.append(
                    f"dropped-token spike ({dropped_total:.0f}/{routed_total:.0f}, baseline {self._drop_ema:.3f})"
                )
            self._drop_ema = frac if self._drop_ema is None else 0.8 * self._drop_ema + 0.2 * frac
        clips_delta = self.phase_clips - self._last_phase_clips
        self._last_phase_clips = self.phase_clips
        self._clip_streak = self._clip_streak + 1 if clips_delta > 0 else 0
        if self._clip_streak >= 2:
            reasons.append(f"repeated phase clips (x{self._clip_streak})")
        if reasons:
            self._anomaly_streak += 1
            self._clean_streak = 0
            if self._probing:
                self._quarantine("; ".join(reasons))  # failed probe
            elif self._anomaly_streak >= self.cfg.quarantine_after:
                self._quarantine("; ".join(reasons))
            return
        self._anomaly_streak = 0
        self._clean_streak += 1
        if self._probing:
            if self._clean_streak >= self.cfg.recover_after:
                self._probing = False
                self._probe_at = None
                self._backoff = self.cfg.probe_backoff
        elif (
            self._chain_pos > 0
            and self._probe_at is not None
            and self.steps >= self._probe_at
            and self._clean_streak >= self.cfg.recover_after
        ):
            # backoff elapsed on a clean degraded fabric: trial the preferred one
            self._probe_return_pos = self._chain_pos
            self._chain_pos = 0
            self._probing = True
            self._clean_streak = 0

    def _fit_envelope(self, scheds) -> tuple[int, ...] | None:
        """Growth-biased envelope policy.  The first build sizes it with
        ``envelope_slack`` headroom; a plan that exceeds it grows it
        (``envelope_growths``).  With ``envelope_decay`` a slot whose
        slacked need stays below ``envelope_decay * envelope[k]`` for
        ``shrink_patience`` consecutive rebuilds shrinks to the peak
        slacked need since the envelope last changed
        (``envelope_shrinks``), so every plan seen since still fits.
        Growth resets every underuse streak.  Frozen under a link mask."""
        if not self.cfg.envelope_slack:
            return None
        if self._link_mask is not None and self._envelope is not None:
            return tuple(int(v) for v in self._envelope)
        raw = phase_envelope(scheds, self._k_max, slack=1.0)
        need = np.where(raw > 0, -(-np.ceil(raw * self.cfg.envelope_slack).astype(np.int64) // 8) * 8, 0)
        if self._envelope is None:
            self._envelope = need
            self._env_underused = np.zeros(self._k_max, dtype=np.int64)
            self._env_need_peak = need.copy()
        elif (raw > self._envelope).any():
            self._envelope = np.maximum(self._envelope, need)
            self.envelope_growths += 1
            self._env_underused[:] = 0
            self._env_need_peak = need.copy()
        elif self.cfg.envelope_decay:
            live = self._envelope > 0
            self._env_need_peak = np.maximum(self._env_need_peak, need)
            under = live & (need < self.cfg.envelope_decay * self._envelope) & (need < self._envelope)
            self._env_underused = np.where(under, self._env_underused + 1, 0)
            shrink = (self._env_underused >= self.cfg.shrink_patience) & (self._env_need_peak < self._envelope)
            if shrink.any():
                self._envelope = np.where(shrink, self._env_need_peak, self._envelope)
                self._env_underused[shrink] = 0
                self._env_need_peak = need.copy()  # new window
                self.envelope_shrinks += 1
        return tuple(int(v) for v in self._envelope)

    def table(self) -> ScheduleTable:
        """The current per-layer plans as one fixed-shape ``ScheduleTable``
        ([L, k_max, n] leaves) on the runtime's device.

        Cached per assignment.  On a swap whose envelope is unchanged the
        new plans are copied into the same tensors, so the returned object
        (and every tensor of it) is the one returned before; an envelope
        growth or shrink builds new tensors (``table_rebuilds``).  A
        caller that must keep a round's table takes ``table().clone()``.
        Plans wider than the slot budget are clipped (``phase_clips``)."""
        scheds = self.schedules
        if scheds is None:
            raise ValueError("no schedules yet: prime the runtime or feed it a step's routing counts first")
        key = self.schedule_key
        if self._table is None or self._table_key != key:
            # count each clipped PLAN once (entries repeat across layers and
            # rebuilds; the mark goes when the selector evicts the entry)
            for name, sel in zip(key, self.selectors):
                if (
                    name not in self._clipped_entries
                    and sel.current is not None
                    and sel.current.schedule.num_phases > self._k_max
                ):
                    self._clipped_entries.add(name)
                    self.phase_clips += 1
            envelope = self._fit_envelope(scheds)
            if self._table is not None and envelope == self._table.envelope:
                self._table.fill_(scheds, clip=True)
            else:
                self._table = ScheduleTable.from_schedules(
                    scheds, k_max=self._k_max, clip=True, envelope=envelope, device=self.device
                )
                self.table_rebuilds += 1
            self._table_key = key
        return self._table

    def _group_traffic(self, gi: int) -> np.ndarray:
        # mean (not sum) over the group's layers: the schedule runs per
        # layer, so capacities are sized for one layer's traffic
        t = self._smoothed[self.groups[gi]].mean(axis=0)
        if self._link_mask is not None:
            # score and plan on the ROUTABLE demand (idempotent with
            # decompose's own masking)
            t = apply_link_mask(t, self._link_mask)
        return t

    # -------------------------------------------------------------- observe
    def observe(self, stats, dropped: np.ndarray | None = None, loss: float | None = None) -> Decision:
        """Feed one step's routing counts ``[L, n_src, E]`` (or a stats dict
        ``{"routing": ..., "dropped": ...}``).  ``dropped`` accumulates into
        ``admitted_dropped``; ``loss`` feeds the health FSM."""
        t0 = time.perf_counter()
        if isinstance(stats, dict):
            if dropped is None:
                dropped = stats.get("dropped")
            stats = stats["routing"]
        dropped_total = None
        if dropped is not None:
            dropped_total = float(np.asarray(dropped).sum())
            self.admitted_dropped += dropped_total
        stats = np.asarray(stats, dtype=np.float64)
        t1 = time.perf_counter()
        self.fetch_s += t1 - t0
        mats = routing_to_traffic(stats, n_ranks=self.cfg.n_ranks, n_experts=self.cfg.n_experts)
        decision = self.observe_traffic(mats, dropped_total=dropped_total, loss=loss)
        now = time.perf_counter()
        self.score_s += now - t1
        self.observe_s += now - t0
        return decision

    def observe_traffic(
        self, mats: np.ndarray, *, dropped_total: float | None = None, loss: float | None = None
    ) -> Decision:
        """Score one step's already-folded traffic ``[L, n, n]``: the EMA /
        propose / apply / health core of ``observe``."""
        if mats.shape[0] != self.n_layers:
            raise ValueError(f"stats cover {mats.shape[0]} layers, runtime has {self.n_layers}")
        if self._smoothed is None:
            self._smoothed = mats.copy()
        else:
            self._smoothed = (1 - self.cfg.ema) * self._smoothed + self.cfg.ema * mats
        self.steps += 1
        proposals = [sel.propose(self._group_traffic(gi)) for gi, sel in enumerate(self.selectors)]
        decision = self._apply(proposals)
        self._health(loss=loss, dropped_total=dropped_total, routed_total=float(mats.sum()))
        return decision

    def prime(self, traffic: np.ndarray) -> Decision:
        """Bootstrap from a demand estimate ``[n, n]`` (shared) or
        ``[L, n, n]`` before the first step: plans every group."""
        t = np.asarray(traffic, dtype=np.float64)
        if t.ndim == 2:
            t = np.broadcast_to(t, (self.n_layers, *t.shape))
        if t.shape != (self.n_layers, self.cfg.n_ranks, self.cfg.n_ranks):
            raise ValueError(f"bad prime traffic shape {t.shape}")
        self._smoothed = t.astype(np.float64).copy()
        proposals = []
        for gi, sel in enumerate(self.selectors):
            p = sel.propose(self._group_traffic(gi))  # seeds the selector's EMA state
            if sel.current is None:
                p = Proposal("miss", None, float("inf"))
            proposals.append(p)
        return self._apply(proposals)

    # --------------------------------------------------------------- re-plan
    def _apply(self, proposals: list[Proposal]) -> Decision:
        if any(p.action == "miss" for p in proposals):
            self._replan(proposals)
            replanned = True
        else:
            for sel, p in zip(self.selectors, proposals):
                if p.action == "switch":
                    sel.adopt(p.entry)
            replanned = False
        key = self.schedule_key
        changed = key != self._key
        self._key = key
        return Decision(changed=changed, replanned=replanned, key=key, actions=tuple(p.action for p in proposals))

    def _replan(self, proposals: list[Proposal]) -> None:
        """One ``decompose_batch`` call re-plans ALL MoE layers (per-layer
        warm states), plus one aggregate row per multi-layer group."""
        t0 = time.perf_counter()
        maxweight = self.cfg.strategy == "maxweight"
        rows = [self._smoothed]
        warm: list[WarmState | None] = list(self._warm)
        group_rows: dict[int, int] = {}
        cursor = self.n_layers
        for gi, group in enumerate(self.groups):
            if len(group) == 1:
                group_rows[gi] = group[0]
            else:
                rows.append(self._group_traffic(gi)[None])
                warm.append(self._group_warm[gi])
                group_rows[gi] = cursor
                cursor += 1
        stack = np.concatenate(rows, axis=0)
        decomps = decompose_batch(
            stack,
            self.cfg.strategy,
            min_fill=self.cfg.min_fill,
            warm_start=warm if maxweight else None,
            link_mask=self._link_mask,
        )
        self.decompose_calls += 1
        self.replan_events += 1
        if self.faults is not None and self.faults.dark_window_steps > 0:
            self.dark_window_steps += self.faults.dark_window_steps
        if maxweight:
            self._warm = [warm_state_of(d) for d in decomps[: self.n_layers]]
            for gi, row in group_rows.items():
                if row >= self.n_layers:
                    self._group_warm[gi] = warm_state_of(decomps[row])
        hits = sum(bool(d.meta.get("warm_hit")) for d in decomps)
        self.warm_hits += hits
        self.cold_plans += len(decomps) - hits
        registered = []
        for gi, (sel, p) in enumerate(zip(self.selectors, proposals)):
            if p.action == "miss":
                d = decomps[group_rows[gi]]
                entry = ScheduleEntry(
                    name=f"plan{self.replan_events}.g{gi}",
                    reference=self._group_traffic(gi).copy(),
                    schedule=plan_schedule(d, **self._plan_kwargs),
                )
                sel.register(entry)
                registered.append(gi)
            elif p.action == "switch":
                sel.adopt(p.entry)
        for sel in self.selectors:
            # the event re-planned every layer, so the whole runtime enters
            # cooldown (else each group would trigger its own event a step later)
            sel._cooldown_left = max(sel._cooldown_left, sel.cooldown)
        dt = time.perf_counter() - t0
        self.replan_s += dt
        self.last_event = {
            "step": self.steps,
            "decompose_calls": 1,
            "layers": len(decomps),
            "warm_hits": hits,
            "cold": len(decomps) - hits,
            "groups_replanned": registered,
            "replan_s": dt,
        }

    # --------------------------------------------------------------- summary
    def summary(self) -> dict:
        """Counters for logs and benchmark output."""
        return {
            "steps": self.steps,
            "replan_events": self.replan_events,
            "decompose_calls": self.decompose_calls,
            "warm_hits": self.warm_hits,
            "cold_plans": self.cold_plans,
            "switches": sum(s.switches for s in self.selectors),
            "phase_clips": self.phase_clips,
            "table_rebuilds": self.table_rebuilds,
            "library_sizes": [len(s.library) for s in self.selectors],
            "observe_us_per_step": round(self.observe_s / self.steps * 1e6, 2) if self.steps else 0.0,
            "fetch_us_per_step": round(self.fetch_s / self.steps * 1e6, 2) if self.steps else 0.0,
            "score_us_per_step": round(self.score_s / self.steps * 1e6, 2) if self.steps else 0.0,
            "replan_ms_per_event": (
                round(self.replan_s / self.replan_events * 1e3, 3) if self.replan_events else 0.0
            ),
        }

    def metrics(self) -> dict:
        """``summary()`` plus the dispatch-health telemetry: plan-admitted
        tokens cut at packing, the envelope and its growths/shrinks, and
        the health FSM's state and counters."""
        return {
            **self.summary(),
            "admitted_dropped": self.admitted_dropped,
            "envelope_growths": self.envelope_growths,
            "envelope_shrinks": self.envelope_shrinks,
            "envelope": None if self._envelope is None else [int(v) for v in self._envelope],
            "health_state": self.health_state,
            "active_fabric": self.active_fabric(),
            "fallback_active": self.fallback_active,
            "quarantines": self.quarantines,
            "probe_failures": self.probe_failures,
            "fabric_faults": self.fabric_faults,
            "masked_replans": self.masked_replans,
            "dark_window_steps": self.dark_window_steps,
            "link_masked": self._link_mask is not None,
        }

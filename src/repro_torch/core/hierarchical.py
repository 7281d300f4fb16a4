"""Hierarchical (pod-aware) decomposition and the two-level controller.

Multi-pod fabrics are two-level: fast intra-pod links and slower
inter-pod links.  A flat decomposition holds any matching with one
cross-pod pair at the slow link's duration; the hierarchical scheduler
splits the traffic instead:

* **intra**: the block-diagonal (same-pod) traffic, decomposed per pod;
  pods run their circuits in parallel, so phase k of the combined
  schedule is the union of each pod's phase k (identity where a pod has
  fewer phases);
* **inter**: the off-block traffic, decomposed globally; its phases run
  on the slow links only.

The two schedules run concurrently on disjoint hardware, so the makespan
is max(intra, inter) plus the compute pipeline
(``simulate_hierarchical``).  The executable two-level path:

* ``HierarchicalTable``: an intra and an inter ``ScheduleTable`` with
  the pod size; either level is swapped alone (``update``), and
  ``merged()`` folds the pair into one flat table whose phase axis is
  ``[intra slots | inter slots]``, the form the phase-pipelined geometry
  consumes (the ``hierarchical`` fabric, ``parallel/fabric``);
* ``hierarchical_plan`` (host, scipy) and ``hierarchical_plan_traced``
  (tensors, the batched auction ``core.lap.greedy_phases`` per level, the
  intra level batched over the pods' diagonal blocks);
* ``HierarchicalRuntime``: a ``ScheduleRuntime`` that is the inter
  (circuit) level and carries an intra runtime; each level observes only
  its half of the traffic, so intra drift never forces an inter re-plan;
* ``HierarchicalDeviceController``: two ``DeviceController``s stepped
  from one routing fold.  As the flat controller, its ``step_device``
  reads nothing on the host (it can sit inside the engine's decode
  graph) and its ``replan`` is the host half of a fired step.

JAX's pytree registration has no counterpart: the table and the state
are dataclasses of tensors.  Counterpart of ``repro/core/hierarchical.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.cost_models import CommModel, ComputeModel
from repro_torch.core.decompose import decompose, decompose_batch
from repro_torch.core.device_controller import (
    DeviceController,
    DeviceControllerState,
    DeviceStep,
    routing_to_traffic_traced,
)
from repro_torch.core.lap import MAX_ROUNDS, greedy_phases
from repro_torch.core.runtime import Decision, ScheduleRuntime
from repro_torch.core.schedule import ScheduleTable, plan_schedule
from repro_torch.core.simulator import simulate_decomposition
from repro_torch.core.types import Decomposition, StackedPhases

__all__ = [
    "HierarchicalControllerState",
    "HierarchicalDeviceController",
    "HierarchicalRuntime",
    "HierarchicalTable",
    "check_pod_size",
    "hierarchical_decompose",
    "hierarchical_plan",
    "hierarchical_plan_traced",
    "same_pod_mask",
    "simulate_hierarchical",
    "split_traffic",
    "split_traffic_traced",
]


def check_pod_size(n: int, pod_size: int) -> int:
    """``pod_size`` as an int if it tiles an ``n``-rank fabric into whole
    pods; else a ``ValueError`` listing the divisors of ``n``."""
    n, p = int(n), int(pod_size)
    if p < 1 or n % p:
        divisors = [d for d in range(1, n + 1) if n % d == 0]
        raise ValueError(
            f"pod_size={pod_size} does not tile the n={n} rank fabric into whole pods; valid divisors of {n}: "
            f"{divisors}"
        )
    return p


def same_pod_mask(n: int, pod_size: int) -> np.ndarray:
    """``[n, n]`` bool: True where src and dst share a pod (the diagonal too)."""
    check_pod_size(n, pod_size)
    pod = np.arange(n) // pod_size
    return pod[:, None] == pod[None, :]


def split_traffic(matrix: np.ndarray, pod_size: int):
    """(intra, inter): the same-pod block-diagonal part and the rest, over
    any leading dims ``[..., n, n]``; ``intra + inter == matrix``."""
    a = np.asarray(matrix, dtype=np.float64)
    mask = same_pod_mask(a.shape[-1], pod_size)
    return np.where(mask, a, 0.0), np.where(mask, 0.0, a)


def split_traffic_traced(matrix, pod_size: int):
    """``split_traffic`` on tensors (f32, on the input's device)."""
    a = torch.as_tensor(matrix).to(torch.float32)
    n = a.shape[-1]
    check_pod_size(n, pod_size)
    pod = torch.arange(n, device=a.device) // pod_size
    mask = pod[:, None] == pod[None, :]
    return torch.where(mask, a, 0.0), torch.where(mask, 0.0, a)


def _union_pod_phases(decomps, pod_size: int, n: int, intra_offdiag) -> Decomposition:
    """Per-pod decompositions as one: phase k is the union of each pod's
    phase k (identity in exhausted pods).  The matrix ``intra_offdiag`` has
    a zero diagonal: no phase carries local tokens, so a simulation that
    adds ``local_tokens`` does not count the diagonal twice."""
    k_max = max((d.num_phases for d in decomps), default=0)
    perms = np.broadcast_to(np.arange(n), (k_max, n)).copy()
    alloc = np.zeros((k_max, n))
    sent = np.zeros((k_max, n))
    for p, d in enumerate(decomps):
        st = d.stacked()
        k = st.num_phases
        base = p * pod_size
        sl = slice(base, base + pod_size)
        perms[:k, sl] = st.perms + base
        alloc[:k, sl] = st.alloc
        sent[:k, sl] = st.sent
    stacked = StackedPhases(perms=perms, alloc=alloc, sent=sent)
    out = Decomposition(matrix=intra_offdiag, phases=stacked.to_phases(), strategy="hier-intra")
    out._stacked_cache = stacked
    return out


def hierarchical_decompose(matrix: np.ndarray, pod_size: int, strategy: str = "maxweight", **kwargs):
    """(intra Decomposition over n ranks, inter Decomposition); ``kwargs``
    (``min_fill`` ...) go to both levels' decompositions."""
    a = np.asarray(matrix, dtype=np.float64)
    n = a.shape[0]
    intra, inter = split_traffic(a, pod_size)
    pods = n // pod_size
    blocks = intra.reshape(pods, pod_size, pods, pod_size).transpose(0, 2, 1, 3)[np.arange(pods), np.arange(pods)]
    per_pod = decompose_batch(blocks, strategy, keep_diagonal=False, **kwargs)
    intra_offdiag = intra.copy()
    np.fill_diagonal(intra_offdiag, 0.0)
    intra_d = _union_pod_phases(per_pod, pod_size, n, intra_offdiag)
    inter_d = decompose(inter, strategy, keep_diagonal=True, **kwargs)
    inter_d.strategy = "hier-inter"
    return intra_d, inter_d


# --------------------------------------------------------------------------
# The executable two-level path: tables and planners
# --------------------------------------------------------------------------
def _on(tab: ScheduleTable) -> torch.Tensor:
    """The served-phase prefix of a table or row: [K] or [L, K] bool."""
    k = torch.arange(tab.k_max, device=tab.perms.device)
    return k < tab.n_phases if tab.is_row else k[None, :] < tab.n_phases[:, None]


@dataclasses.dataclass(frozen=True)
class HierarchicalTable:
    """An intra and an inter ``ScheduleTable`` (full tables or rows) and
    the pod size.  ``row(l)`` slices both levels.  ``merged()`` folds the
    pair into one flat table with phase axis ``[intra slots | inter
    slots]``: each level's served prefix goes into ``valid``/``caps`` and
    the merged ``n_phases`` is the total slot count, so a pod's shorter
    intra plan cannot hide live inter slots."""

    intra: ScheduleTable
    inter: ScheduleTable
    pod_size: int = 2

    @property
    def is_row(self) -> bool:
        return self.intra.is_row

    @property
    def n(self) -> int:
        return self.intra.n

    @property
    def k_max(self) -> int:
        return self.intra.k_max + self.inter.k_max

    @property
    def num_layers(self) -> int:
        return self.intra.num_layers

    @property
    def envelope(self):
        """Both levels' envelopes, concatenated (None unless both have one)."""
        if self.intra.envelope is None or self.inter.envelope is None:
            return None
        return tuple(self.intra.envelope) + tuple(self.inter.envelope)

    def row(self, l: int) -> "HierarchicalTable":
        return HierarchicalTable(self.intra.row(l), self.inter.row(l), self.pod_size)

    def update(self, intra=None, inter=None) -> "HierarchicalTable":
        """Either level swapped alone; the other's tensors are kept."""
        return HierarchicalTable(intra if intra is not None else self.intra,
                                 inter if inter is not None else self.inter, self.pod_size)

    def clone(self, device=None) -> "HierarchicalTable":
        return HierarchicalTable(self.intra.clone(device), self.inter.clone(device), self.pod_size)

    def pair_caps(self, e_local: int = 1, *, quantum: int = 8) -> torch.Tensor:
        """Per-(src, dst) planned per-expert capacity: a pair lives in one
        level, so the sum is its level's cap."""
        return self.intra.pair_caps(e_local, quantum=quantum) + self.inter.pair_caps(e_local, quantum=quantum)

    def envelope_slots(self, e_local: int = 1, *, quantum: int = 8) -> tuple[int, ...]:
        return (tuple(self.intra.envelope_slots(e_local, quantum=quantum))
                + tuple(self.inter.envelope_slots(e_local, quantum=quantum)))

    def merged(self) -> ScheduleTable:
        ia, ie = self.intra, self.inter
        on_i, on_e = _on(ia), _on(ie)
        envelope = self.envelope
        zero = torch.zeros((), dtype=ia.caps.dtype, device=ia.caps.device)
        return ScheduleTable(
            perms=torch.cat([ia.perms, ie.perms], dim=-2),
            caps=torch.cat([torch.where(on_i, ia.caps, zero), torch.where(on_e, ie.caps, zero)], dim=-1),
            valid=torch.cat([ia.valid & on_i[..., None], ie.valid & on_e[..., None]], dim=-2),
            offsets=torch.cat([ia.offsets, ie.offsets], dim=-2),
            n_phases=torch.full_like(ie.n_phases, ia.k_max + ie.k_max),
            envelope=envelope,
            envelope_t=None if envelope is None else torch.cat([ia.envelope_t, ie.envelope_t]),
        )


def hierarchical_plan(
    traffic: np.ndarray, pod_size: int, *, n_layers: int | None = None, strategy: str = "maxweight",
    k_max_intra: int | None = None, k_max_inter: int | None = None, envelope="auto",
    decompose_kwargs: dict | None = None, device: torch.device | str = "cpu", **plan_kwargs,
) -> HierarchicalTable:
    """Host two-level planner: traffic ``[n, n]`` (broadcast over
    ``n_layers``) or ``[L, n, n]`` -> ``HierarchicalTable`` on ``device``.
    Per layer, ``hierarchical_decompose`` (``decompose_kwargs``) and
    ``plan_schedule(**plan_kwargs)`` per level; each level's table carries
    its own envelope (``"auto"``: from its plans)."""
    t = np.asarray(traffic, dtype=np.float64)
    if t.ndim == 2:
        t = np.broadcast_to(t, (n_layers or 1, *t.shape))
    check_pod_size(t.shape[-1], pod_size)
    intra_s, inter_s = [], []
    for layer in t:
        intra_d, inter_d = hierarchical_decompose(layer, pod_size, strategy, **(decompose_kwargs or {}))
        intra_s.append(plan_schedule(intra_d, **plan_kwargs))
        inter_s.append(plan_schedule(inter_d, **plan_kwargs))
    table = lambda scheds, k: ScheduleTable.from_schedules(  # noqa: E731
        scheds, k_max=k, clip=True, envelope=envelope, device=device)
    return HierarchicalTable(table(intra_s, k_max_intra), table(inter_s, k_max_inter), int(pod_size))


def hierarchical_plan_traced(
    traffic, pod_size: int, *, k_max_intra: int, k_max_inter: int, quantum: int = 8, min_cap: int = 8,
    slack: float = 1.0, mask=None, max_rounds: int = MAX_ROUNDS,
) -> dict:
    """Two-level planner on tensors: ``greedy_phases`` per level.  The
    intra level solves the ``[L * pods, p, p]`` diagonal blocks in one
    batched call (the host's ``decompose_batch(blocks)``), lifts each pod's
    perms by its rank base and unions them into ``[L, K, n]`` leaves
    (identity and ``valid=False`` where a pod ran out of phases; the union's
    cap is the largest pod cap); the inter level solves the off-block rest
    globally.  ``mask`` (``[n, n]`` bool, True = usable) zeroes dead-pair
    demand in both levels.  Returns ``{"intra": leaves, "inter": leaves}``,
    each ``perms``/``caps``/``valid``/``n_phases``."""
    a = torch.as_tensor(traffic).to(torch.float32)
    L, n, _ = a.shape
    check_pod_size(n, pod_size)
    if mask is not None:
        a = torch.where(torch.as_tensor(mask, dtype=torch.bool, device=a.device)[None], a, 0.0)
    intra, inter = split_traffic_traced(a, pod_size)
    pods = n // pod_size
    diag = torch.arange(pods, device=a.device)
    blocks = intra.reshape(L, pods, pod_size, pods, pod_size).permute(0, 1, 3, 2, 4)[:, diag, diag]
    bplan = greedy_phases(blocks.reshape(L * pods, pod_size, pod_size), k_max=k_max_intra, quantum=quantum,
                          min_cap=min_cap, slack=slack, max_rounds=max_rounds)
    bases = (torch.arange(pods, dtype=torch.int32, device=a.device) * pod_size)[None, :, None, None]
    per_pod = lambda leaf: leaf.reshape(L, pods, k_max_intra, pod_size).transpose(1, 2).reshape(L, k_max_intra, n)  # noqa: E731
    intra_leaves = {
        "perms": per_pod(bplan["perms"].reshape(L, pods, k_max_intra, pod_size) + bases),
        "caps": bplan["caps"].reshape(L, pods, k_max_intra).amax(dim=1),
        "valid": per_pod(bplan["valid"]),
        "n_phases": bplan["n_phases"].reshape(L, pods).amax(dim=1),
    }
    iplan = greedy_phases(inter, k_max=k_max_inter, quantum=quantum, min_cap=min_cap, slack=slack, mask=mask,
                          max_rounds=max_rounds)
    return {"intra": intra_leaves, "inter": {k: iplan[k] for k in ("perms", "caps", "valid", "n_phases")}}


# --------------------------------------------------------------------------
# Host controller: the inter level is a ScheduleRuntime carrying an intra one
# --------------------------------------------------------------------------
class HierarchicalRuntime(ScheduleRuntime):
    """Two-level drift controller.  This runtime is the inter (circuit)
    level, with the health FSM, fault handling and fallback chain of the
    slow reconfigurable fabric; ``intra`` is a ``ScheduleRuntime`` for the
    electrical level.  Every observation is split once and each level sees
    only its own traffic, so their re-plans are independent; ``table()``
    pairs what each level holds."""

    def __init__(self, cfg, n_moe_layers: int, *, pod_size: int, intra_cfg=None,
                 device: torch.device | str = "cpu"):
        self.pod_size = check_pod_size(cfg.n_ranks, pod_size)
        super().__init__(cfg, n_moe_layers, device=device)
        if intra_cfg is None:
            # the electrical level has no circuit to degrade: no fallback chain there
            intra_cfg = dataclasses.replace(cfg, fallback_chain=())
        if intra_cfg.n_ranks != cfg.n_ranks:
            raise ValueError(
                f"intra level plans over the same {cfg.n_ranks}-rank fabric (block-diagonal traffic); got "
                f"intra_cfg.n_ranks={intra_cfg.n_ranks}"
            )
        self.intra = ScheduleRuntime(intra_cfg, n_moe_layers, device=device)

    def observe_traffic(self, mats: np.ndarray, *, dropped_total: float | None = None,
                        loss: float | None = None) -> Decision:
        intra_m, inter_m = split_traffic(mats, self.pod_size)
        d_intra = self.intra.observe_traffic(intra_m)
        d_inter = super().observe_traffic(inter_m, dropped_total=dropped_total, loss=loss)
        return Decision(changed=d_intra.changed or d_inter.changed, replanned=d_intra.replanned or d_inter.replanned,
                        key=(d_intra.key, d_inter.key), actions=d_inter.actions)

    def prime(self, traffic: np.ndarray) -> Decision:
        intra_m, inter_m = split_traffic(np.asarray(traffic, dtype=np.float64), self.pod_size)
        self.intra.prime(intra_m)
        return super().prime(inter_m)

    def inter_table(self) -> ScheduleTable:
        """The circuit level's own flat table."""
        return ScheduleRuntime.table(self)

    def table(self) -> HierarchicalTable:
        """Both levels' current plans; each level refills its own tensors
        in place, so an intra-only swap leaves the inter tensors as they are."""
        return HierarchicalTable(self.intra.table(), self.inter_table(), self.pod_size)

    def set_link_mask(self, mask: np.ndarray | None) -> None:
        """Per level: a dead same-pod link degrades only the intra plan, a
        dead cross-pod link only the inter plan (pairs outside a level's
        region are marked up there: that level never routes them)."""
        if mask is None:
            self.intra.set_link_mask(None)
            super().set_link_mask(None)
            return
        m = np.asarray(mask, dtype=bool)
        same = same_pod_mask(self.cfg.n_ranks, self.pod_size)
        m_intra, m_inter = m | ~same, m | same
        self.intra.set_link_mask(None if m_intra.all() else m_intra)
        super().set_link_mask(None if m_inter.all() else m_inter)

    def metrics(self) -> dict:
        out = super().metrics()
        out["pod_size"] = self.pod_size
        out["intra"] = self.intra.metrics()
        return out


# --------------------------------------------------------------------------
# Device-resident twin: two controller states, one routing fold
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HierarchicalControllerState:
    """Both levels' ``DeviceControllerState``."""

    intra: DeviceControllerState
    inter: DeviceControllerState

    def leaves(self) -> dict[str, torch.Tensor]:
        """Every leaf of both levels, as ``"intra.<name>"`` then ``"inter.<name>"``."""
        return {f"{level}.{k}": v for level in ("intra", "inter") for k, v in getattr(self, level).leaves().items()}

    def clone(self, device=None) -> "HierarchicalControllerState":
        return HierarchicalControllerState(self.intra.clone(device), self.inter.clone(device))


class LevelSteps(NamedTuple):
    """Each level's ``DeviceStep``: what a fired two-level step hands its
    host half (``HierarchicalDeviceController.replan``)."""

    intra: DeviceStep
    inter: DeviceStep


class _InterLevelView:
    """The inter level of a ``HierarchicalRuntime`` as the runtime
    ``DeviceController.from_runtime`` reads (whose ``table()`` is the pair)."""

    def __init__(self, runtime: HierarchicalRuntime):
        self._rt = runtime
        self.cfg, self.device = runtime.cfg, runtime.device
        self._plan_kwargs, self._smoothed, self._link_mask = runtime._plan_kwargs, runtime._smoothed, runtime._link_mask

    def table(self) -> ScheduleTable:
        return self._rt.inter_table()


class HierarchicalDeviceController:
    """Two ``DeviceController``s stepped from one routing fold, each with
    its own EMA, streak and re-plan: intra drift fires only the intra
    solve and leaves the inter plan's tensors untouched.  ``step_device``
    / ``replan`` / ``table_of`` / ``metrics`` and the state's ``clone``
    are the flat controller's interface, so the serving engine captures
    the two-level step in its decode graph as it does the flat one."""

    def __init__(self, intra: DeviceController, inter: DeviceController, pod_size: int):
        if intra.cfg.n_ranks != inter.cfg.n_ranks:
            raise ValueError(
                f"levels disagree on fabric size: intra n={intra.cfg.n_ranks} vs inter n={inter.cfg.n_ranks}"
            )
        self.pod_size = check_pod_size(inter.cfg.n_ranks, pod_size)
        self.intra, self.inter = intra, inter

    @property
    def cfg(self):
        """The circuit level's config (no regime library: a flat-controller feature)."""
        return self.inter.cfg

    @property
    def device(self) -> torch.device:
        return self.inter.device

    @classmethod
    def from_runtime(cls, runtime: HierarchicalRuntime, *, device=None, **overrides):
        """Lift a host ``HierarchicalRuntime`` into (controller, state)."""
        ictrl, istate = DeviceController.from_runtime(runtime.intra, device=device, **overrides)
        ectrl, estate = DeviceController.from_runtime(_InterLevelView(runtime), device=device, **overrides)
        return cls(ictrl, ectrl, runtime.pod_size), HierarchicalControllerState(intra=istate, inter=estate)

    def _level_masks(self, link_mask):
        same = same_pod_mask(self.inter.cfg.n_ranks, self.pod_size)
        m = np.asarray(link_mask.cpu() if isinstance(link_mask, torch.Tensor) else link_mask, dtype=bool)
        return m | ~same, m | same

    def init_state(self, table: HierarchicalTable, traffic=None, link_mask=None) -> HierarchicalControllerState:
        t_intra = t_inter = m_intra = m_inter = None
        if traffic is not None:
            t_intra, t_inter = split_traffic(traffic, self.pod_size)
        if link_mask is not None:
            m_intra, m_inter = self._level_masks(link_mask)
        return HierarchicalControllerState(
            intra=self.intra.init_state(table.intra, traffic=t_intra, link_mask=m_intra),
            inter=self.inter.init_state(table.inter, traffic=t_inter, link_mask=m_inter),
        )

    def table_of(self, state: HierarchicalControllerState) -> HierarchicalTable:
        return HierarchicalTable(self.intra.table_of(state.intra), self.inter.table_of(state.inter), self.pod_size)

    def step_device(self, state: HierarchicalControllerState, routing, dropped=None) -> DeviceStep:
        """Both levels' device transitions from one routing fold, no host
        read; admitted-but-dropped tokens are charged once, on the circuit
        level.  ``fire`` is either level's; ``routable`` carries each level's
        step (``LevelSteps``) for ``replan``."""
        cfg = self.inter.cfg
        routing = torch.as_tensor(routing).to(self.device)
        traffic = routing_to_traffic_traced(routing, n_ranks=cfg.n_ranks, n_experts=cfg.n_experts)
        t_intra, t_inter = split_traffic_traced(traffic, self.pod_size)
        steps = LevelSteps(self.intra.step_device_traffic(state.intra, t_intra),
                           self.inter.step_device_traffic(state.inter, t_inter, dropped))
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        return DeviceStep(fire=steps.intra.fire | steps.inter.fire, warm=torch.zeros_like(steps.inter.warm),
                          best=zero, routable=steps)

    def replan(self, state: HierarchicalControllerState, routable: LevelSteps, *, warm: bool = False,
               best: int = 0) -> None:
        """The host half of a fired step: each level that fired re-plans
        (``warm``/``best`` are each level's own, read from ``routable``)."""
        del warm, best
        for ctrl, level, out in ((self.intra, state.intra, routable.intra), (self.inter, state.inter, routable.inter)):
            if bool(out.fire):
                ctrl.replan(level, out.routable, warm=bool(out.warm), best=int(out.best))

    def step(self, state: HierarchicalControllerState, routing, dropped=None) -> HierarchicalControllerState:
        """One observe -> score -> (re-plan) transition of both levels, in place."""
        out = self.step_device(state, routing, dropped)
        if bool(out.fire):
            self.replan(state, out.routable)
        return state

    def set_link_mask(self, state: HierarchicalControllerState, link_mask) -> HierarchicalControllerState:
        """Per-level masking, as ``HierarchicalRuntime.set_link_mask``."""
        m_intra, m_inter = self._level_masks(link_mask)
        self.intra.set_link_mask(state.intra, m_intra)
        self.inter.set_link_mask(state.inter, m_inter)
        return state

    def metrics(self, state: HierarchicalControllerState) -> dict:
        m_intra, m_inter = self.intra.metrics(state.intra), self.inter.metrics(state.inter)
        return {
            "steps": m_inter["steps"],
            "device_replans": m_intra["device_replans"] + m_inter["device_replans"],
            # dropped tokens are charged once, on the circuit level
            "drop_fraction": m_inter["drop_fraction"],
            "drop_spikes": m_inter["drop_spikes"],
            "admitted_dropped": m_inter["admitted_dropped"],
            "regime_warm_swaps": m_intra["regime_warm_swaps"] + m_inter["regime_warm_swaps"],
            "intra": m_intra,
            "inter": m_inter,
        }


def simulate_hierarchical(matrix: np.ndarray, pod_size: int, compute: ComputeModel, comm_intra: CommModel,
                          comm_inter: CommModel, *, strategy: str = "maxweight") -> dict:
    """Hierarchical vs flat makespan on a two-level fabric.  Flat: one
    decomposition, each phase timed at its slowest active pair's rate (the
    inter rate if it crosses pods)."""
    a = np.asarray(matrix, dtype=np.float64)
    n = a.shape[0]
    intra_d, inter_d = hierarchical_decompose(a, pod_size, strategy)
    local = np.diag(a).copy()
    r_intra = simulate_decomposition(intra_d, compute, comm_intra, local_tokens=local)
    r_inter = simulate_decomposition(inter_d, compute, comm_inter)
    hier = max(r_intra.makespan_us, r_inter.makespan_us)
    flat_d = decompose(a, strategy)
    pod_of = np.arange(n) // pod_size
    st = flat_d.stacked()
    if st.num_phases:
        crosses = ((pod_of[None, :] != pod_of[st.perms]) & (st.sent > 0)).any(axis=1)
        durs = st.durations()
        makespan = float(np.where(crosses, comm_inter.reconf_us + comm_inter.comm_us(durs),
                                  comm_intra.reconf_us + comm_intra.comm_us(durs)).sum())
        recv_total = st.recv_tokens().sum(axis=0) + local
    else:
        makespan = 0.0
        recv_total = local
    flat = makespan + float(np.max(compute(recv_total)))
    return {
        "hier_us": float(hier),
        "flat_us": float(flat),
        "speedup": float(flat / hier) if hier > 0 else float("inf"),
        "intra_phases": intra_d.num_phases,
        "inter_phases": inter_d.num_phases,
        "flat_phases": flat_d.num_phases,
    }

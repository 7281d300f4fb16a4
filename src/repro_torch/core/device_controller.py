"""Device-resident controller: observe -> score -> re-plan on device tensors.

Counterpart of ``repro/core/device_controller.py``.  The host runtime
(``core.runtime.ScheduleRuntime``) fetches routing counts and re-plans
through scipy; this controller keeps the EMA'd traffic, the current plan
and the hysteresis/cooldown/drift counters as tensors on its device, so a
decode step can observe and score with no host read.

**The transition is split in two.**  JAX runs the whole step as one traced
function with the re-plan behind ``lax.cond``.  Here:

* ``step_device`` does everything but the plan: the routing fold, EMA,
  link mask, planned-drop score, streak, cooldown, regime nearest-match,
  ``fire`` and the counters, each JAX ``jnp.where(fire, ...)`` a
  ``torch.where``.  It writes the state in place and reads nothing on the
  host, so it can sit inside a CUDA graph.
* ``replan`` runs only when the host has read ``fire``: the warm gather
  from the regime library, or the cold ``core.lap.greedy_phases`` solve.
  It writes ``perms``/``caps``/``valid``/``n_phases``/``capmat`` in place
  (``copy_``), so a captured graph keeps reading the same storage.

``step`` is the two in a row and equals JAX's step: the same decisions
and plans, integer and bool leaves exactly and f32 leaves to rounding.
Its EMA keeps the product ``(1 - ema) * smoothed`` exact and rounds it
once with the sum, as XLA's fused multiply-add does on the CPU, so the
EMA'd traffic, and the plans cut from it, equal the reference's.

Policy (as the reference's): drop tolerance on ``max(traffic - caps,
0).sum() / total``; hysteresis as persistence (``hysteresis_steps``
consecutive over-tolerance steps); cooldown after a re-plan; a degraded
link mask disables warm matching; ``replan_penalty`` declines a cold
re-plan whose best-case saving (the current drop) is below it, and never
blocks a warm swap.  The regime library (``regime_slots > 0``) holds
pre-planned tables keyed by a normalized ``[n, n]`` traffic shape; a fire
whose shape lies within ``regime_threshold`` (relative L1) of an entry
swaps that plan in without a solve.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.lap import MAX_ROUNDS, greedy_phases
from repro_torch.core.schedule import ScheduleTable

__all__ = [
    "DeviceController",
    "DeviceControllerConfig",
    "DeviceControllerState",
    "DeviceStep",
    "apply_link_mask_traced",
    "routing_to_traffic_traced",
]

PLAN_LEAVES = ("perms", "caps", "valid", "n_phases")  # a re-plan also rewrites ``capmat``


@dataclasses.dataclass(frozen=True)
class DeviceControllerConfig:
    """Static knobs of the controller; the tunable state (EMA, counters, the
    plan) lives in ``DeviceControllerState``.  ``envelope`` is the static
    phase envelope of the emitted tables, pinned at build time.
    ``cooldown``/``drop_tolerance``/``ema`` match ``ControllerConfig``;
    ``regime_slots`` sizes the regime library (0 = none);
    ``regime_threshold`` is the relative-L1 shape distance of a warm match;
    ``replan_penalty`` the drop-fraction cost of a cold re-plan's dark
    window (0 = always worth it)."""

    n_ranks: int
    n_experts: int
    k_max: int
    ema: float = 0.3
    drop_tolerance: float = 0.05
    hysteresis_steps: int = 2
    cooldown: int = 5
    quantum: int = 8
    min_cap: int = 8
    slack: float = 1.1
    envelope: tuple[int, ...] | None = None
    drop_spike_frac: float = 0.25
    max_rounds: int = MAX_ROUNDS
    regime_slots: int = 0
    regime_threshold: float = 0.15
    replan_penalty: float = 0.0

    def __post_init__(self):
        if self.n_experts % self.n_ranks:
            raise ValueError(f"{self.n_experts} experts not divisible by {self.n_ranks} ranks")
        if self.k_max < 1:
            raise ValueError("k_max must be >= 1")
        if self.hysteresis_steps < 1:
            raise ValueError("hysteresis_steps must be >= 1")
        if self.regime_slots < 0:
            raise ValueError("regime_slots must be >= 0")
        if self.replan_penalty < 0.0:
            raise ValueError("replan_penalty must be >= 0")
        if self.envelope is not None and not isinstance(self.envelope, tuple):
            object.__setattr__(self, "envelope", tuple(int(v) for v in self.envelope))


@dataclasses.dataclass
class DeviceControllerState:
    """The controller's carry, every leaf a tensor on the controller's
    device (counters are 0-d).  The plan leaves have the ``ScheduleTable``
    layout; ``capmat`` caches their planned pair capacity.  The ``lib_*``
    leaves are the regime library (``R = regime_slots`` entries; zero-size
    when R is 0).  Updated in place by the controller."""

    smoothed: torch.Tensor  # [L, n, n] f32 EMA'd rank traffic
    perms: torch.Tensor  # [L, K, n] i32 current plan
    caps: torch.Tensor  # [L, K] i32 token-unit phase caps
    valid: torch.Tensor  # [L, K, n] bool
    n_phases: torch.Tensor  # [L] i32
    capmat: torch.Tensor  # [L, n, n] f32 planned pair capacity of the plan
    link_mask: torch.Tensor  # [n, n] bool, True = usable
    steps: torch.Tensor  # i32 observations folded in
    cooldown: torch.Tensor  # i32 steps until a re-plan may fire again
    drift_streak: torch.Tensor  # i32 consecutive over-tolerance steps
    replans: torch.Tensor  # i32 re-plan count
    drop: torch.Tensor  # f32 last planned-drop fraction
    drop_spikes: torch.Tensor  # i32 health-FSM input (spike steps)
    admitted_dropped: torch.Tensor  # f32 cumulative cut-token count
    lib_ref: torch.Tensor  # [R, n, n] f32 normalized reference traffic
    lib_perms: torch.Tensor  # [R, L, K, n] i32 stored plans
    lib_caps: torch.Tensor  # [R, L, K] i32
    lib_valid: torch.Tensor  # [R, L, K, n] bool
    lib_n_phases: torch.Tensor  # [R, L] i32
    lib_size: torch.Tensor  # i32 filled slots (<= R)
    warm_swaps: torch.Tensor  # i32 re-plans served from the library

    def leaves(self) -> dict[str, torch.Tensor]:
        """Every leaf by name, in field order (the reference's pytree order)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def clone(self, device: torch.device | str | None = None) -> "DeviceControllerState":
        """A copy with storage of its own (on ``device``, default this one's)."""
        return DeviceControllerState(**{k: v.to(device or v.device, copy=True) for k, v in self.leaves().items()})


class DeviceStep(NamedTuple):
    """What ``step_device`` leaves for the host: ``fire`` / ``warm`` (0-d
    bool), ``best`` (0-d int, the nearest library entry) and the routable
    traffic a cold re-plan solves on."""

    fire: torch.Tensor
    warm: torch.Tensor
    best: torch.Tensor
    routable: torch.Tensor


def routing_to_traffic_traced(stats: torch.Tensor, *, n_ranks: int, n_experts: int) -> torch.Tensor:
    """``[L, n_src, E]`` counts -> ``[L, n, n]`` rank traffic by the
    contiguous expert -> rank placement (``core.runtime.routing_to_traffic``
    on the device)."""
    s = stats.to(torch.float32)
    if s.dim() != 3 or s.shape[2] != n_experts:
        raise ValueError(f"expected [L, n_src, {n_experts}] stats, got {tuple(s.shape)}")
    L, n_src, _ = s.shape
    per_rank = s.reshape(L, n_src, n_ranks, n_experts // n_ranks).sum(-1)
    if n_src == n_ranks:
        return per_rank
    if n_ranks % n_src == 0:
        k = n_ranks // n_src
        return torch.repeat_interleave(per_rank, k, dim=1) / k
    if n_src % n_ranks == 0:
        return per_rank.reshape(L, n_ranks, n_src // n_ranks, n_ranks).sum(dim=2)
    raise ValueError(f"cannot map {n_src} source shards onto {n_ranks} ranks")


def apply_link_mask_traced(matrix: torch.Tensor, link_mask: torch.Tensor) -> torch.Tensor:
    """``core.faults.apply_link_mask`` on the device: masked off-diagonal
    entries are zeroed and each row's displaced demand spread over the
    row's surviving off-diagonal destinations (uniformly when they carried
    none); a row with no survivor drops it.  Batched over leading dims."""
    a = matrix.to(torch.float32)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=a.device)
    usable = link_mask.to(torch.bool) & ~eye
    dead = ~usable & ~eye
    displaced = torch.where(dead, a, 0.0).sum(-1)
    alive = torch.where(usable, a, 0.0)
    row_alive = alive.sum(-1)
    n_usable = usable.sum(-1)
    uniform = torch.where(n_usable[:, None] > 0, usable / torch.clamp(n_usable, min=1)[:, None], 0.0)
    prop = torch.where(row_alive[..., None] > 0, alive / torch.clamp(row_alive, min=1e-30)[..., None], uniform)
    # the diagonal never routes over the fabric: keep it untouched
    return torch.where(eye, a, alive + displaced[..., None] * prop)


def _cap_matrix(perms, caps, valid, n_phases) -> torch.Tensor:
    """Per-(src, dst) planned capacity [L, n, n] f32 of [L, K, n] plan
    leaves (``A2ASchedule.cap_matrix`` over the stack)."""
    L, K, n = perms.shape
    dev = perms.device
    on = (torch.arange(K, device=dev)[None, :] < n_phases[:, None])[:, :, None] & valid
    upd = torch.where(on, caps[:, :, None].to(torch.float32), 0.0)
    lyr = torch.arange(L, device=dev)[:, None, None]
    src = torch.arange(n, device=dev)[None, None, :]
    flat = (lyr * n + src) * n + perms.long()
    out = torch.zeros(L * n * n, dtype=torch.float32, device=dev)
    return out.index_add_(0, flat.reshape(-1), upd.reshape(-1)).reshape(L, n, n)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class DeviceController:
    """Builds and steps ``DeviceControllerState`` on ``device``: holding it
    is holding the static config (and the table's constant leaves)."""

    def __init__(self, cfg: DeviceControllerConfig, *, device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._consts: dict = {}

    # ---------------------------------------------------------- lifecycle
    def init_state(self, table, traffic=None, link_mask=None) -> DeviceControllerState:
        """State seeded from a host-planned table.  ``traffic`` ([L, n, n])
        primes the EMA (the runtime's smoothed traffic); None starts cold."""
        cfg, dev = self.cfg, self.device
        n = cfg.n_ranks
        L = table.num_layers
        if table.k_max != cfg.k_max or table.n != n:
            raise ValueError(f"table is [{L}, {table.k_max}, {table.n}], config wants k_max={cfg.k_max}, n={n}")
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        if traffic is None:
            smoothed, steps = torch.zeros((L, n, n), **f32), 0
        else:
            smoothed, steps = torch.tensor(_numpy(traffic), **f32), 1
            if tuple(smoothed.shape) != (L, n, n):
                raise ValueError(f"prime traffic shape {tuple(smoothed.shape)} != {(L, n, n)}")
        # copies (torch.tensor): the state must not share storage with the
        # runtime's table or mask, which the host rewrites in place
        mask = torch.ones((n, n), dtype=torch.bool, device=dev) if link_mask is None else (
            torch.tensor(_numpy(link_mask), dtype=torch.bool, device=dev))
        perms, caps, n_phases = (torch.tensor(_numpy(getattr(table, name)), **i32) for name in ("perms", "caps", "n_phases"))
        valid = torch.tensor(_numpy(table.valid), dtype=torch.bool, device=dev)
        R, K = cfg.regime_slots, cfg.k_max
        return DeviceControllerState(
            smoothed=smoothed, perms=perms, caps=caps, valid=valid, n_phases=n_phases,
            capmat=_cap_matrix(perms, caps, valid, n_phases), link_mask=mask,
            steps=torch.tensor(steps, **i32), cooldown=torch.tensor(0, **i32), drift_streak=torch.tensor(0, **i32),
            replans=torch.tensor(0, **i32), drop=torch.tensor(0.0, **f32), drop_spikes=torch.tensor(0, **i32),
            admitted_dropped=torch.tensor(0.0, **f32),
            lib_ref=torch.zeros((R, n, n), **f32), lib_perms=torch.zeros((R, L, K, n), **i32),
            lib_caps=torch.zeros((R, L, K), **i32), lib_valid=torch.zeros((R, L, K, n), dtype=torch.bool, device=dev),
            lib_n_phases=torch.zeros((R, L), **i32), lib_size=torch.tensor(0, **i32),
            warm_swaps=torch.tensor(0, **i32),
        )

    @classmethod
    def from_runtime(cls, runtime, *, device=None, **overrides):
        """Lift a host ``ScheduleRuntime`` into (controller, state) on
        ``device`` (default the runtime's): its policy knobs, its current
        envelope as the static one, its smoothed traffic as the EMA prime."""
        rcfg = runtime.cfg
        table = runtime.table()
        kw = dict(
            n_ranks=rcfg.n_ranks, n_experts=rcfg.n_experts, k_max=table.k_max, ema=rcfg.ema,
            drop_tolerance=rcfg.drop_tolerance, cooldown=rcfg.cooldown, envelope=table.envelope,
            drop_spike_frac=rcfg.drop_spike_frac,
        )
        plan_kwargs = getattr(runtime, "_plan_kwargs", None) or {}
        for k in ("quantum", "min_cap", "slack"):
            if k in plan_kwargs:
                kw[k] = plan_kwargs[k]
        kw.update(overrides)
        ctrl = cls(DeviceControllerConfig(**kw), device=runtime.device if device is None else device)
        state = ctrl.init_state(table, traffic=runtime._smoothed, link_mask=runtime._link_mask)
        return ctrl, state

    def load_regimes(self, state: DeviceControllerState, tables, references) -> DeviceControllerState:
        """Fill the regime library, in place, from host pre-planned tables
        (planned at the config's ``k_max``/envelope, so a swap is
        shape-neutral) and the ``[n, n]`` traffic each was planned for
        (stored normalized, diagonal zeroed).  Returns ``state``."""
        cfg = self.cfg
        R = cfg.regime_slots
        if R == 0:
            raise ValueError("config.regime_slots == 0: size the library before loading regimes")
        if len(tables) != len(references):
            raise ValueError(f"{len(tables)} tables vs {len(references)} references")
        if len(tables) > R:
            raise ValueError(f"{len(tables)} regimes exceed regime_slots={R}")
        n = cfg.n_ranks
        L, K = state.perms.shape[0], cfg.k_max
        lib = {
            "lib_ref": np.zeros((R, n, n), np.float32), "lib_perms": np.zeros((R, L, K, n), np.int32),
            "lib_caps": np.zeros((R, L, K), np.int32), "lib_valid": np.zeros((R, L, K, n), bool),
            "lib_n_phases": np.zeros((R, L), np.int32),
        }
        for r, (tab, ref) in enumerate(zip(tables, references)):
            if (tab.num_layers, tab.k_max, tab.n) != (L, K, n):
                raise ValueError(f"regime {r} table is [{tab.num_layers}, {tab.k_max}, {tab.n}], "
                                 f"library wants [{L}, {K}, {n}]")
            if tab.envelope is not None and cfg.envelope is not None and tuple(tab.envelope) != tuple(cfg.envelope):
                raise ValueError(f"regime {r} envelope {tab.envelope} != config envelope {cfg.envelope}: "
                                 f"a warm swap would not be shape-neutral")
            a = np.asarray(_numpy(ref), np.float64)
            if a.shape != (n, n):
                raise ValueError(f"regime {r} reference shape {a.shape} != {(n, n)}")
            a = a.copy()
            np.fill_diagonal(a, 0.0)
            lib["lib_ref"][r] = (a / max(a.sum(), 1e-9)).astype(np.float32)
            for name in ("perms", "caps", "valid", "n_phases"):
                lib[f"lib_{name}"][r] = _numpy(getattr(tab, name))
        for name, arr in lib.items():
            getattr(state, name).copy_(torch.from_numpy(arr))
        state.lib_size.fill_(len(tables))
        return state

    # -------------------------------------------------------------- views
    def table_of(self, state: DeviceControllerState) -> ScheduleTable:
        """The state's plan as a ``ScheduleTable`` over the plan tensors
        themselves (no copies), so a re-plan shows through it; offsets are
        zeros (max-weight plans serve each pair once), the envelope the
        config's."""
        key = (state.perms.device, tuple(state.perms.shape))
        if key not in self._consts:
            env = self.cfg.envelope
            self._consts[key] = (
                torch.zeros(state.perms.shape, dtype=torch.int32, device=key[0]),
                None if env is None else torch.tensor(env, dtype=torch.int64).to(key[0]),
            )
        offsets, envelope_t = self._consts[key]
        return ScheduleTable(
            perms=state.perms, caps=state.caps, valid=state.valid, offsets=offsets, n_phases=state.n_phases,
            envelope=self.cfg.envelope, envelope_t=envelope_t,
        )

    # --------------------------------------------------------------- step
    def step(self, state: DeviceControllerState, routing, dropped=None) -> DeviceControllerState:
        """One observe -> score -> (re-plan) transition, in place: JAX's
        ``step``.  ``routing``: this step's ``[L, n_src, E]`` realized
        counts; ``dropped``: optional admitted-but-cut counts (summed)."""
        return self._finish(state, self.step_device(state, routing, dropped))

    def step_traffic(self, state: DeviceControllerState, traffic, dropped=None) -> DeviceControllerState:
        """``step`` on already-folded traffic ``[L, n, n]``."""
        return self._finish(state, self.step_device_traffic(state, traffic, dropped))

    def _finish(self, state, out: DeviceStep) -> DeviceControllerState:
        if bool(out.fire):
            self.replan(state, out.routable, warm=bool(out.warm), best=int(out.best))
        return state

    def step_device(self, state: DeviceControllerState, routing, dropped=None) -> DeviceStep:
        """The transition without the plan leaves: no host read (see the
        module doc).  The host re-plans when ``fire`` is set."""
        routing = torch.as_tensor(routing).to(self.device)
        traffic = routing_to_traffic_traced(routing, n_ranks=self.cfg.n_ranks, n_experts=self.cfg.n_experts)
        return self.step_device_traffic(state, traffic, dropped)

    def step_device_traffic(self, state: DeviceControllerState, traffic, dropped=None) -> DeviceStep:
        """``step_device`` on already-folded traffic ``[L, n, n]``."""
        cfg = self.cfg
        n = cfg.n_ranks
        traffic = torch.as_tensor(traffic).to(device=self.device, dtype=torch.float32)
        eye = torch.eye(n, dtype=torch.bool, device=self.device)
        traffic = torch.where(eye[None], 0.0, traffic)
        # (1 - ema) * smoothed exact, rounded once with ema * traffic (XLA's FMA)
        keep = float(np.float32(1.0 - cfg.ema))
        mixed = (state.smoothed.double() * keep + (traffic * cfg.ema).double()).float()
        smoothed = torch.where(state.steps == 0, traffic, mixed)
        # score the routable demand against the CURRENT plan (selector rule)
        routable = apply_link_mask_traced(smoothed, state.link_mask)
        total = routable.sum()
        overflow = torch.clamp(routable - state.capmat, min=0.0).sum()
        drop = torch.where(total > 0, overflow / torch.clamp(total, min=1e-30), 0.0)
        over = drop > cfg.drop_tolerance
        streak = torch.where(over, state.drift_streak + 1, 0)
        cooldown = torch.clamp(state.cooldown - 1, min=0)
        # regime nearest-match on the EMA'd traffic shape (mean over layers,
        # normalized); a degraded mask disables warm matching
        if cfg.regime_slots > 0:
            obs = routable.mean(dim=0)
            obs = obs / torch.clamp(obs.sum(), min=1e-30)
            dist = 0.5 * (obs[None] - state.lib_ref).abs().sum(dim=(-2, -1))
            filled = torch.arange(cfg.regime_slots, device=self.device) < state.lib_size
            dist = torch.where(filled, dist, math.inf)
            best = torch.argmin(dist)
            warm = (state.lib_size > 0) & (dist.amin() <= cfg.regime_threshold) & state.link_mask.all()
        else:
            best = torch.zeros((), dtype=torch.int64, device=self.device)
            warm = torch.zeros((), dtype=torch.bool, device=self.device)
        # a cold re-plan's best-case saving is the whole current drop; a warm
        # swap rides pre-established circuits and is always worth it
        worth = warm | (drop >= cfg.replan_penalty)
        fire = over & (streak >= cfg.hysteresis_steps) & (cooldown == 0) & worth
        if dropped is None:
            dropped_total = torch.zeros((), dtype=torch.float32, device=self.device)
        else:
            dropped_total = torch.as_tensor(dropped).to(device=self.device, dtype=torch.float32).sum()
        spike = dropped_total > cfg.drop_spike_frac * torch.clamp(traffic.sum(), min=1.0)
        state.smoothed.copy_(smoothed)
        state.steps.add_(1)
        state.cooldown.copy_(torch.where(fire, cfg.cooldown, cooldown))
        state.drift_streak.copy_(torch.where(fire, 0, streak))
        state.replans.add_(fire.to(torch.int32))
        state.drop.copy_(drop)
        state.drop_spikes.add_(spike.to(torch.int32))
        state.admitted_dropped.add_(dropped_total)
        state.warm_swaps.add_((fire & warm).to(torch.int32))
        return DeviceStep(fire=fire, warm=warm, best=best, routable=routable)

    def replan(self, state: DeviceControllerState, routable, *, warm: bool, best: int) -> None:
        """The host half of a fired step: the library entry ``best`` (warm)
        or a cold batched-auction plan of ``routable``, written into the
        plan leaves in place."""
        if warm:
            plan = {name: getattr(state, f"lib_{name}")[best] for name in PLAN_LEAVES}
        else:
            plan = self._solve(routable, state.link_mask)
        self._adopt(state, plan)

    def _solve(self, routable, link_mask) -> dict:
        cfg = self.cfg
        return greedy_phases(
            routable, k_max=cfg.k_max, quantum=cfg.quantum, min_cap=cfg.min_cap, slack=cfg.slack, mask=link_mask,
            max_rounds=cfg.max_rounds,
        )

    @staticmethod
    def _adopt(state: DeviceControllerState, plan: dict) -> None:
        capmat = _cap_matrix(plan["perms"], plan["caps"], plan["valid"], plan["n_phases"])
        for name in PLAN_LEAVES:
            getattr(state, name).copy_(plan[name])
        state.capmat.copy_(capmat)

    # ----------------------------------------------------------- incident
    def set_link_mask(self, state: DeviceControllerState, link_mask) -> DeviceControllerState:
        """Adopt a new availability mask and re-plan under it at once (a
        host decision: the health FSM's), cooldown restarted.  In place."""
        mask = torch.tensor(_numpy(link_mask), dtype=torch.bool, device=self.device)
        self._adopt(state, self._solve(apply_link_mask_traced(state.smoothed, mask), mask))
        state.link_mask.copy_(mask)
        state.cooldown.fill_(self.cfg.cooldown)
        state.drift_streak.fill_(0)
        state.replans.add_(1)
        return state

    # ------------------------------------------------------------ metrics
    def metrics(self, state: DeviceControllerState) -> dict:
        """Host fetch of the telemetry (a device-to-host sync: call it on the
        logging cadence, not per step)."""
        return {
            "steps": int(state.steps),
            "device_replans": int(state.replans),
            "drop_fraction": float(state.drop),
            "drift_streak": int(state.drift_streak),
            "cooldown_left": int(state.cooldown),
            "drop_spikes": int(state.drop_spikes),
            "admitted_dropped": float(state.admitted_dropped),
            "link_masked": bool((~state.link_mask).any()),
            "regime_library_size": int(state.lib_size),
            "regime_warm_swaps": int(state.warm_swaps),
        }

"""Schedule planning: decomposition -> executable schedule -> device table.

Host half (numpy): ``A2ASchedule``, ``phase_envelope``, ``plan_schedule``.
Device half: ``ScheduleTable``, the fixed-shape per-layer plan stack whose
leaves are torch tensors on the device, so a MoE layer reads its row's
capacities without a host round trip.  Counterpart of
``repro/core/schedule.py``; every leaf and method result equals the JAX
table's on the same plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import Decomposition

__all__ = ["A2ASchedule", "ScheduleTable", "phase_envelope", "plan_schedule"]


def _round_up(x, quantum: int):
    """Ceil to a multiple of ``quantum`` (scalar int or int array)."""
    return -(-np.asarray(x) // quantum) * quantum


@dataclasses.dataclass(frozen=True)
class A2ASchedule:
    """Static host plan: perms [K, n] int32, caps [K] int32 (per-pair token
    capacity of phase k), valid [K, n] bool (pair carries planned traffic)."""

    perms: np.ndarray
    caps: np.ndarray
    valid: np.ndarray | None = None

    def __post_init__(self):
        if self.valid is None:
            object.__setattr__(self, "valid", np.ones(self.perms.shape, dtype=bool))

    @property
    def num_phases(self) -> int:
        return int(self.perms.shape[0])

    @property
    def n(self) -> int:
        return int(self.perms.shape[1])

    def validate(self) -> None:
        n = self.n
        if self.num_phases == 0:
            return
        perms = np.asarray(self.perms)
        bad_rows = (np.sort(perms, axis=1) != np.arange(n)[None, :]).any(1)
        if bad_rows.any():
            bad = int(np.flatnonzero(bad_rows)[0])
            raise ValueError(f"phase {bad} perm invalid: {perms[bad]}")
        src = np.tile(np.arange(n), self.num_phases)
        pair_ids = (src * n + perms.ravel())[self.valid.ravel()]
        uniq, counts = np.unique(pair_ids, return_counts=True)
        if counts.size and counts.max() > 1:
            dup = int(uniq[np.argmax(counts)])
            raise ValueError(f"pair {(dup // n, dup % n)} valid in two phases")
        if (self.caps <= 0).any():
            raise ValueError("capacities must be positive")


def phase_envelope(schedules, k_max: int, *, slack: float = 1.0, quantum: int = 8) -> np.ndarray:
    """Per-phase-slot capacity bound covering ``schedules``:
    ``round_up(slack * max_plans caps[k])`` (token units); unused slots 0."""
    env = np.zeros(k_max, dtype=np.int64)
    for s in schedules:
        k = min(s.num_phases, k_max)
        env[:k] = np.maximum(env[:k], np.asarray(s.caps[:k], dtype=np.int64))
    grown = _round_up(np.ceil(env * float(slack)).astype(np.int64), quantum)
    return np.where(env > 0, grown, 0).astype(np.int64)


def plan_schedule(
    decomp: Decomposition, *, quantum: int = 8, slack: float = 1.0, min_cap: int = 8
) -> A2ASchedule:
    """Decomposition -> static schedule.  Phase cap = max allocated slot
    times ``slack``, at least ``min_cap``, rounded up to ``quantum``;
    pairs with no planned traffic (and self pairs) are invalid."""
    n = decomp.n
    st = decomp.stacked()
    valid_all = (st.sent > 0) & (st.perms != np.arange(n)[None, :])
    keep = valid_all.any(axis=1)
    if not keep.any():  # all-local traffic: one dark identity phase
        return A2ASchedule(
            perms=np.arange(n, dtype=np.int32)[None, :],
            caps=np.array([max(min_cap, quantum)], dtype=np.int32),
            valid=np.zeros((1, n), dtype=bool),
        )
    valid = valid_all[keep]
    base = np.where(valid, st.alloc[keep], -np.inf).max(axis=1)
    caps = _round_up(
        np.maximum(np.ceil(base * slack).astype(np.int64), min_cap), quantum
    ).astype(np.int32)
    sched = A2ASchedule(perms=st.perms[keep].astype(np.int32), caps=caps, valid=valid)
    sched.validate()
    return sched


def _ceil_div(x: torch.Tensor, q: int) -> torch.Tensor:
    return -torch.div(-x, q, rounding_mode="floor")


@dataclasses.dataclass(frozen=True)
class ScheduleTable:
    """Per-layer plans as fixed-shape device tensors:

      perms    [L, K_max, n] int32  destination of rank i in phase k
      caps     [L, K_max]    int32  per-pair capacity per phase (0 pads)
      valid    [L, K_max, n] bool   pair carries planned traffic
      offsets  [L, K_max, n] int32  multi-phase pair offsets (BvN plans;
                                    zeros for max-weight)
      n_phases [L]           int32  active phases per layer

    ``envelope`` is the static per-phase-slot capacity bound (token units,
    python ints).  ``row(l)`` slices one layer; a row keeps this class.
    """

    perms: torch.Tensor
    caps: torch.Tensor
    valid: torch.Tensor
    offsets: torch.Tensor
    n_phases: torch.Tensor
    envelope: tuple[int, ...] | None = None
    # the envelope as an int64 device tensor, copied to the device once per
    # table so per-layer admission never waits on a host-to-device copy
    envelope_t: torch.Tensor | None = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def is_row(self) -> bool:
        return self.perms.dim() == 2

    @property
    def num_layers(self) -> int:
        if self.is_row:
            raise ValueError("row slice has no layer dim")
        return int(self.perms.shape[0])

    @property
    def k_max(self) -> int:
        return int(self.perms.shape[-2])

    @property
    def n(self) -> int:
        return int(self.perms.shape[-1])

    @classmethod
    def from_schedules(
        cls, schedules, *, k_max: int | None = None, clip: bool = False,
        envelope=None, device: torch.device | str = "cpu",
    ) -> "ScheduleTable":
        """Stack per-layer ``A2ASchedule`` plans into one padded table.
        ``clip`` drops the lightest trailing phases of plans longer than
        ``k_max``; ``envelope`` is ``"auto"``, an explicit sequence of
        ``k_max`` ints, or None."""
        schedules = list(schedules)
        if not schedules:
            raise ValueError("from_schedules needs at least one schedule")
        n = schedules[0].n
        need = max(s.num_phases for s in schedules)
        if k_max is None:
            k_max = need
        elif need > k_max and not clip:
            raise ValueError(
                f"schedule needs {need} phases but the table holds {k_max}; "
                "pass clip=True to shed trailing phases or grow k_max"
            )
        L = len(schedules)
        perms = np.broadcast_to(np.arange(n, dtype=np.int32), (L, k_max, n)).copy()
        caps = np.zeros((L, k_max), dtype=np.int32)
        valid = np.zeros((L, k_max, n), dtype=bool)
        offsets = np.zeros((L, k_max, n), dtype=np.int32)
        n_phases = np.zeros((L,), dtype=np.int32)
        for l, s in enumerate(schedules):
            if s.n != n:
                raise ValueError(f"layer {l}: fabric {s.n} != {n}")
            k = min(s.num_phases, k_max)
            perms[l, :k] = np.asarray(s.perms[:k], dtype=np.int32)
            caps[l, :k] = np.asarray(s.caps[:k], dtype=np.int32)
            valid[l, :k] = np.asarray(s.valid[:k], dtype=bool)
            n_phases[l] = k
        if isinstance(envelope, str):
            if envelope != "auto":
                raise ValueError(f"unknown envelope mode {envelope!r}")
            envelope = phase_envelope(schedules, k_max)
        if envelope is not None:
            envelope = tuple(int(v) for v in np.asarray(envelope).ravel())
            if len(envelope) != k_max:
                raise ValueError(f"envelope has {len(envelope)} slots for k_max={k_max}")
            if any(v < 0 for v in envelope):
                raise ValueError("envelope entries must be >= 0")
        dev = torch.device(device)
        return cls(
            perms=torch.from_numpy(perms).to(dev),
            caps=torch.from_numpy(caps).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            offsets=torch.from_numpy(offsets).to(dev),
            n_phases=torch.from_numpy(n_phases).to(dev),
            envelope=envelope,
            envelope_t=None if envelope is None else torch.tensor(envelope, dtype=torch.int64).to(dev),
        )

    def row(self, l: int) -> "ScheduleTable":
        """Layer ``l``'s slice."""
        if self.is_row:
            raise ValueError("already a row")
        return ScheduleTable(
            perms=self.perms[l], caps=self.caps[l], valid=self.valid[l],
            offsets=self.offsets[l], n_phases=self.n_phases[l],
            envelope=self.envelope, envelope_t=self.envelope_t,
        )

    def envelope_slots(self, e_local: int = 1, *, quantum: int = 8) -> tuple[int, ...]:
        """Static per-phase-slot buffer rows per expert:
        ``max(quantum, round_up(ceil(envelope[k] / e_local), quantum))``,
        0 where the envelope slot is 0."""
        if self.envelope is None:
            raise ValueError("table has no envelope")
        out = []
        for v in self.envelope:
            if v == 0:
                out.append(0)
                continue
            per_expert = -(-v // e_local)
            out.append(max(quantum, -(-per_expert // quantum) * quantum))
        return tuple(int(v) for v in out)

    def phase_slot_caps(self, e_local: int = 1, *, quantum: int = 8) -> torch.Tensor:
        """Per-phase planned capacity in per-expert slot units, clamped to
        the envelope when the table carries one.  [K_max] int32."""
        def slots(v):  # round_up(ceil(v / e_local), quantum), at least quantum
            return torch.clamp(_ceil_div(_ceil_div(v, e_local), quantum) * quantum, min=quantum)

        per_expert = slots(self.caps).to(torch.int32)
        if self.envelope is not None:
            # envelope_slots() on the device copy: 0 stays 0 (a dark slot)
            env = self.envelope_t
            env = torch.where(env == 0, torch.zeros_like(env), slots(env)).to(torch.int32)
            per_expert = torch.minimum(per_expert, env)
        return per_expert

    def pair_caps(self, e_local: int = 1, *, quantum: int = 8) -> torch.Tensor:
        """Per-(src, dst) admitted capacity of a row in per-expert slot
        units: ``sum_k valid[k, i] * phase_slot_caps[k]`` at
        ``(i, perms[k, i])``.  [n, n] int32."""
        if not self.is_row:
            raise ValueError("pair_caps operates on a row slice")
        k_max, n = self.perms.shape
        dev = self.perms.device
        per_expert = self.phase_slot_caps(e_local, quantum=quantum)
        on = (torch.arange(k_max, device=dev) < self.n_phases)[:, None] & self.valid
        upd = torch.where(on, per_expert[:, None], torch.zeros_like(per_expert[:, None]))
        src = torch.arange(n, dtype=torch.int64, device=dev)[None, :].expand(k_max, n)
        flat = (src * n + self.perms.long()).reshape(-1)
        out = torch.zeros(n * n, dtype=torch.int32, device=dev)
        out.index_add_(0, flat, upd.reshape(-1).to(torch.int32))
        return out.reshape(n, n)

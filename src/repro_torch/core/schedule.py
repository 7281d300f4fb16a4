"""Schedule planning: decomposition -> executable schedule -> device table.

Host half (numpy): ``order_phases``, ``A2ASchedule``, ``phase_envelope``,
``phase_offsets``, ``plan_schedule``, ``plan_schedule_bvn``,
``ring_schedule``.  Device half: ``ScheduleTable``, the fixed-shape
per-layer plan stack whose leaves are torch tensors on the device, so a
MoE layer reads its row's capacities without a host round trip.  A
re-planned table of the same shape and envelope is copied into the same
tensors (``fill_``), so a consumer that holds them sees the swap without
new buffers.  Counterpart of ``repro/core/schedule.py``; every leaf and
method result equals the JAX table's on the same plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import Decomposition

__all__ = [
    "A2ASchedule",
    "ScheduleTable",
    "order_phases",
    "phase_envelope",
    "phase_offsets",
    "plan_schedule",
    "plan_schedule_bvn",
    "ring_schedule",
]


def _round_up(x, quantum: int):
    """Ceil to a multiple of ``quantum`` (scalar int or int array)."""
    return -(-np.asarray(x) // quantum) * quantum


def _phase_times(decomp: Decomposition) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dispatch, compute-proxy, combine) duration per phase in token units."""
    st = decomp.stacked()
    d = st.durations()
    c = st.recv_tokens().max(axis=1) if st.num_phases else np.zeros(0)
    return d, c, d.copy()


def order_phases(decomp: Decomposition, how: str = "lpt") -> Decomposition:
    """Reorder phases for the flow-shop makespan (paper §3.3).

    * ``asis``: decomposition order (max-weight: descending weight).
    * ``lpt``: longest dispatch time first, so big phases open long compute
      windows early.
    * ``spt``: shortest first (the anti-heuristic, for contrast).
    * ``johnson3``: Johnson's rule on the 3->2 machine reduction
      (M1' = dispatch + compute, M2' = compute + combine): jobs with
      M1' <= M2' first in ascending M1', then the rest in descending M2'.
    """
    if how == "asis":
        return decomp
    d, c, b = _phase_times(decomp)
    k = len(d)
    if how == "lpt":
        order = list(np.argsort(-d, kind="stable"))
    elif how == "spt":
        order = list(np.argsort(d, kind="stable"))
    elif how == "johnson3":
        m1 = d + c
        m2 = c + b
        first = [i for i in range(k) if m1[i] <= m2[i]]
        first.sort(key=lambda i: m1[i])
        second = [i for i in range(k) if m1[i] > m2[i]]
        second.sort(key=lambda i: -m2[i])
        order = first + second
    else:
        raise ValueError(f"unknown ordering {how!r}")
    return decomp.reordered(order)


@dataclasses.dataclass(frozen=True)
class A2ASchedule:
    """Static host plan: perms [K, n] int32, caps [K] int32 (per-pair token
    capacity of phase k), valid [K, n] bool (pair carries planned traffic;
    a pair is valid in at most one phase unless ``offsets`` is set).
    ``offsets`` [K, n] (BvN plans, where a pair recurs across phases): each
    (phase, src) sends the slice [offset, offset + cap) of its bucket."""

    perms: np.ndarray
    caps: np.ndarray
    valid: np.ndarray | None = None
    offsets: np.ndarray | None = None

    def __post_init__(self):
        if self.valid is None:
            object.__setattr__(self, "valid", np.ones(self.perms.shape, dtype=bool))

    @property
    def num_phases(self) -> int:
        return int(self.perms.shape[0])

    @property
    def n(self) -> int:
        return int(self.perms.shape[1])

    @property
    def total_capacity(self) -> int:
        """Tokens a rank can emit across all phases (= receive capacity)."""
        return int(self.caps.sum())

    @property
    def multi_phase(self) -> bool:
        return self.offsets is not None

    def cap_matrix(self, caps: np.ndarray | None = None) -> np.ndarray:
        """Total per-(src, dst) capacity across phases. [n, n] float64.

        A max-weight or shift plan serves each pair once, so this is its
        phase cap; for BvN it is the pair's summed slots.  The selector
        scores planned drops against traffic ``off`` as
        ``max(off - cap_matrix, 0)``.  ``caps`` overrides the phase caps."""
        n = self.n
        caps = self.caps if caps is None else np.asarray(caps)
        out = np.zeros((n, n))
        if self.num_phases:
            src = np.tile(np.arange(n), self.num_phases)
            caps_b = np.broadcast_to(caps.astype(np.float64)[:, None], self.perms.shape).ravel()
            v = self.valid.ravel()
            np.add.at(out, (src[v], self.perms.ravel()[v]), caps_b[v])
        return out

    def pair_capacity(self) -> int:
        """Largest total slots any (src, dst) pair accumulates."""
        if not self.multi_phase:
            return int(self.caps.max()) if self.caps.size else 0
        per_pair = self.cap_matrix()
        return int(per_pair.max()) if per_pair.size else 0

    def validate(self) -> None:
        n = self.n
        if self.num_phases == 0:
            return
        perms = np.asarray(self.perms)
        bad_rows = (np.sort(perms, axis=1) != np.arange(n)[None, :]).any(1)
        if bad_rows.any():
            bad = int(np.flatnonzero(bad_rows)[0])
            raise ValueError(f"phase {bad} perm invalid: {perms[bad]}")
        if not self.multi_phase:
            src = np.tile(np.arange(n), self.num_phases)
            pair_ids = (src * n + perms.ravel())[self.valid.ravel()]
            uniq, counts = np.unique(pair_ids, return_counts=True)
            if counts.size and counts.max() > 1:
                dup = int(uniq[np.argmax(counts)])
                raise ValueError(f"pair {(dup // n, dup % n)} valid in two phases")
        if (self.caps <= 0).any():
            raise ValueError("capacities must be positive")
        if self.multi_phase:
            # offsets tile disjoint [offset, offset + cap) ranges per pair,
            # in phase order
            cursor = np.zeros((n, n), dtype=np.int64)
            src = np.arange(n)
            for k in range(self.num_phases):
                sel = self.valid[k]
                dst = perms[k][sel]
                expect = cursor[src[sel], dst]
                got = np.asarray(self.offsets[k])[sel]
                if not np.array_equal(got, expect):
                    i = int(np.flatnonzero(got != expect)[0])
                    raise ValueError(f"phase {k} src {int(src[sel][i])}: offset {got[i]} != cumulative {expect[i]}")
                cursor[src[sel], dst] += int(self.caps[k])


def phase_envelope(schedules, k_max: int, *, slack: float = 1.0, quantum: int = 8) -> np.ndarray:
    """Per-phase-slot capacity bound covering ``schedules``:
    ``round_up(slack * max_plans caps[k])`` (token units); unused slots 0."""
    env = np.zeros(k_max, dtype=np.int64)
    for s in schedules:
        k = min(s.num_phases, k_max)
        env[:k] = np.maximum(env[:k], np.asarray(s.caps[:k], dtype=np.int64))
    grown = _round_up(np.ceil(env * float(slack)).astype(np.int64), quantum)
    return np.where(env > 0, grown, 0).astype(np.int64)


def phase_offsets(perms: np.ndarray, valid: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Per-(phase, src) slot offsets of a multi-phase-pair plan: the caps of
    earlier valid phases on the same (src, dst) pair, summed, so phase k
    ships the slice [offset, offset + cap) of the pair's bucket. [K, n]"""
    n = perms.shape[1]
    offsets = np.zeros(perms.shape, dtype=np.int64)
    cursor = np.zeros((n, n), dtype=np.int64)
    src = np.arange(n)
    for k in range(perms.shape[0]):
        sel = np.asarray(valid[k])
        dst = perms[k][sel]
        offsets[k][sel] = cursor[src[sel], dst]
        cursor[src[sel], dst] += int(caps[k])
    return offsets


def ring_schedule(n: int, cap_per_phase: int) -> A2ASchedule:
    """The shifted-ring 1-factorization: n-1 phases, phase k shifts by k+1
    (max-weight's uniform-traffic case, the dense all-to-all's plan)."""
    perms = ((np.arange(n)[None, :] + np.arange(1, n)[:, None]) % n).astype(np.int32)
    caps = np.full(n - 1, cap_per_phase, dtype=np.int32)
    return A2ASchedule(perms=perms, caps=caps)


def plan_schedule_bvn(decomp: Decomposition, *, quantum: int = 8, min_cap: int = 8) -> A2ASchedule:
    """Executable BvN plan: pairs recur across phases (the framed uniform
    slots), with per-(phase, src) offsets so each phase ships the next
    slice of the pair's bucket.  Expect many phases with small caps."""
    n = decomp.n
    st = decomp.stacked()
    valid_all = (st.sent > 0) & (st.perms != np.arange(n)[None, :])
    keep = valid_all.any(axis=1)
    perms = st.perms[keep].astype(np.int32)
    valid = valid_all[keep]
    caps = _round_up(
        np.maximum(np.ceil(st.alloc[keep].max(axis=1)).astype(np.int64), min_cap), quantum
    ).astype(np.int32)
    offsets = phase_offsets(perms, valid, caps)
    sched = A2ASchedule(perms=perms, caps=caps, valid=valid, offsets=offsets.astype(np.int32))
    sched.validate()
    return sched


def plan_schedule(
    decomp: Decomposition,
    *,
    quantum: int = 8,
    slack: float = 1.0,
    min_cap: int = 8,
    cap_quantile: float | None = None,
) -> A2ASchedule:
    """Decomposition -> static schedule.  Phase cap = max allocated slot
    (or its ``cap_quantile`` over the phase's pairs) times ``slack``, at
    least ``min_cap``, rounded up to ``quantum``; pairs with no planned
    traffic (and self pairs) are invalid.  Needs a decomposition whose
    pairs carry traffic in at most one phase (max-weight, shift)."""
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
    alloc = st.alloc[keep]
    if cap_quantile:
        base = np.nanquantile(np.where(valid, alloc, np.nan), cap_quantile, axis=1)
    else:
        base = np.where(valid, alloc, -np.inf).max(axis=1)
    caps = _round_up(
        np.maximum(np.ceil(base * slack).astype(np.int64), min_cap), quantum
    ).astype(np.int32)
    sched = A2ASchedule(perms=st.perms[keep].astype(np.int32), caps=caps, valid=valid)
    sched.validate()
    return sched


def _ceil_div(x: torch.Tensor, q: int) -> torch.Tensor:
    return -torch.div(-x, q, rounding_mode="floor")


TABLE_LEAVES = ("perms", "caps", "valid", "offsets", "n_phases")


def _stack_plans(schedules: list, k_max: int, clip: bool) -> dict[str, np.ndarray]:
    """The table's leaves as host arrays: each plan padded (or, with
    ``clip``, cut) to ``k_max`` phases."""
    n = schedules[0].n
    need = max(s.num_phases for s in schedules)
    if need > k_max and not clip:
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
        if s.offsets is not None:
            offsets[l, :k] = np.asarray(s.offsets[:k], dtype=np.int32)
        n_phases[l] = k
    return {"perms": perms, "caps": caps, "valid": valid, "offsets": offsets, "n_phases": n_phases}


@dataclasses.dataclass(frozen=True)
class ScheduleTable:
    """Per-layer plans as fixed-shape device tensors (``TABLE_LEAVES``):

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
        if k_max is None:
            k_max = max(s.num_phases for s in schedules)
        leaves = _stack_plans(schedules, k_max, clip)
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
            **{name: torch.from_numpy(a).to(dev) for name, a in leaves.items()},
            envelope=envelope,
            envelope_t=None if envelope is None else torch.tensor(envelope, dtype=torch.int64).to(dev),
        )

    def update(self, schedules, *, clip: bool = True) -> "ScheduleTable":
        """A re-planned table with identical leaf shapes and the SAME
        envelope, on this table's device: new tensors (``fill_`` refills
        these ones).  Plans whose caps exceed the envelope are clamped by
        admission, not resized."""
        self._check_plans(schedules)
        return ScheduleTable.from_schedules(
            schedules, k_max=self.k_max, clip=clip, envelope=self.envelope, device=self.perms.device
        )

    def fill_(self, schedules, *, clip: bool = True) -> "ScheduleTable":
        """``update`` in place: copy the re-planned leaves into this table's
        tensors (same storage, same envelope), so whoever holds them sees
        the new plans.  Returns self."""
        schedules = list(schedules)
        self._check_plans(schedules)
        for name, a in _stack_plans(schedules, self.k_max, clip).items():
            getattr(self, name).copy_(torch.from_numpy(a))
        return self

    def clone(self, device: torch.device | str | None = None) -> "ScheduleTable":
        """A copy with storage of its own (on ``device``, default this
        table's): a snapshot that a later ``fill_`` does not reach."""
        dev = self.perms.device if device is None else torch.device(device)
        return dataclasses.replace(
            self,
            **{name: getattr(self, name).to(dev, copy=True) for name in TABLE_LEAVES},
            envelope_t=None if self.envelope_t is None else self.envelope_t.to(dev, copy=True),
        )

    def _check_plans(self, schedules) -> None:
        if self.is_row:
            raise ValueError("a re-plan needs the full table, not a row")
        if len(schedules) != self.num_layers:
            raise ValueError(f"got {len(schedules)} schedules for {self.num_layers} layers")

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

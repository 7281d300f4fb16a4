"""Fault-injection wrapper fabric.

``FaultInjectionFabric`` wraps a registered backend with a
``core.faults.FaultScenario`` and enforces it at the host boundary, as a
fabric manager surfaces a link failure: a schedule that routes a dark
pair is refused (``FabricFaultError`` naming the wrapped backend, the
pair and phase, and the next fabric of the degradation chain) instead of
half delivered.  Pack, dispatch and combine delegate unchanged: once the
planner routes around the dead pairs nothing is left to perturb.

``validate_schedule`` runs the wrapped backend's checks, then holds the
schedule against the scenario's link mask at the current step.  The
port's table rows are concrete tensors, so the check reads them on the
host at every layer call (JAX, whose rows are traced there, checks the
runtime's plans in ``fault_hook`` instead; the port's loops do that too).
``check_transfers`` is the explicit probe a serving loop calls a round.

Wrappers register under ``"faulty:<base>"`` through ``wrap_faulty`` and
mirror the wrapped backend's capability flags.  Counterpart of
``repro/parallel/fabric/faulty.py``.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from repro_torch.core.faults import FaultScenario, check_schedule_mask
from repro_torch.core.schedule import ScheduleTable
from repro_torch.parallel.fabric.base import FABRICS, Fabric, get_fabric, next_fabric

__all__ = ["FaultInjectionFabric", "wrap_faulty"]


def _host(schedule):
    """A ``ScheduleTable`` row as host ``perms``/``valid`` (phases past
    ``n_phases`` carry nothing); anything else as it is."""
    if not isinstance(schedule, ScheduleTable):
        return schedule
    valid = schedule.valid.cpu().numpy()
    k = np.arange(valid.shape[-2]) < schedule.n_phases.cpu().numpy()[..., None]
    return types.SimpleNamespace(perms=schedule.perms.cpu().numpy(), valid=valid & k[..., None])


class FaultInjectionFabric(Fabric):
    """A registered backend wrapped with a deterministic fault scenario.
    Stateful: ``advance(step)`` moves the scenario clock."""

    def __init__(self, base: Fabric, scenario: FaultScenario):
        self.base = base
        self.scenario = scenario
        self.name = f"faulty:{base.name}"
        self.uses_mesh = base.uses_mesh
        self.schedule_kind = base.schedule_kind
        self.requires_envelope = base.requires_envelope
        self.step = 0
        self.faults_raised = 0

    def advance(self, step: int) -> None:
        """Move the scenario clock (the loop's step counter)."""
        self.step = int(step)

    # ------------------------------------------------------------ schedule
    def validate_schedule(self, schedule, *, n: int):
        sched = self.base.validate_schedule(schedule, n=n)
        if sched is not None:
            self._check(sched)
        return sched

    def check_transfers(self, schedule) -> None:
        """Raise ``FabricFaultError`` if ``schedule`` (plans or table rows)
        crosses a dark pair at the current scenario step."""
        self._check(schedule)

    def _check(self, schedule) -> None:
        mask = self.scenario.link_mask(self.step)
        if mask.all():
            return
        items = schedule if isinstance(schedule, (list, tuple)) else [schedule]
        try:
            check_schedule_mask([_host(s) for s in items], mask, backend=self.base.name,
                                next_fabric=next_fabric(self.base.name), step=self.step)
        except Exception:
            self.faults_raised += 1
            raise

    # ------------------------------------------------------------ pipeline
    def pack(self, ctx, x_loc, idx, gates):
        return self.base.pack(ctx, x_loc, idx, gates)

    def dispatch(self, ctx, packed):
        return self.base.dispatch(ctx, packed)

    def combine(self, ctx, packed, state, ys):
        return self.base.combine(ctx, packed, state, ys)

    def unpack(self, ctx, packed, y_slots, t: int) -> torch.Tensor:
        return self.base.unpack(ctx, packed, y_slots, t)

    def wire_encode(self, ctx, packed):
        return self.base.wire_encode(ctx, packed)

    def wire_decode(self, ctx, packed, y_slots):
        return self.base.wire_decode(ctx, packed, y_slots)

    # ----------------------------------------------------------- accounting
    def dispatch_tokens(self, *, n, cap_uniform=0, schedule=None, envelope=None):
        return self.base.dispatch_tokens(n=n, cap_uniform=cap_uniform, schedule=schedule, envelope=envelope)


def wrap_faulty(base_name: str, scenario: FaultScenario) -> str:
    """Register a fault-wrapped backend and return its dispatch name.
    Re-wrapping a base replaces the previous wrapper (scenarios are per
    run); pop ``FABRICS[name]`` when done."""
    fab = FaultInjectionFabric(get_fabric(base_name), scenario)
    FABRICS[fab.name] = fab
    return fab.name

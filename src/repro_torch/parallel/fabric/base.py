"""The fabric seam: per-call context and packed slots.

The MoE layer is one pipeline (route -> admit -> pack -> wire encode ->
dispatch -> grouped expert GEMM -> combine -> wire decode); a fabric owns
the buffer geometry, the movement and the wire codec's domain.  On one
device the only fabric is the virtual dense one (``dense.py``).
Counterpart of ``repro/parallel/fabric/base.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["SCHEDULE_KINDS", "FabricContext", "PackedTokens", "consumes_schedule", "consumes_table"]

# what ``schedule=`` each JAX backend consumes (its ``schedule_kind``):
# nothing, an optional table row (the virtual fabric), a static plan baked
# into the executable, or traced ScheduleTable rows
SCHEDULE_KINDS = {
    "a2a": "none", "dense": "optional_row", "ppermute": "static", "phase_pipelined": "row", "ragged_a2a": "row",
    "hierarchical": "row",
}
_SCHEDULED_ALIAS = "scheduled"  # static plan -> ppermute, table row -> phase_pipelined


def _schedule_kind(name: str) -> str:
    if name not in SCHEDULE_KINDS:
        raise ValueError(
            f"unknown dispatch mode {name!r}: registered fabrics are {', '.join(sorted(SCHEDULE_KINDS))} "
            "(plus the 'scheduled' alias, which resolves by schedule type)"
        )
    return SCHEDULE_KINDS[name]


def consumes_schedule(name: str) -> bool:
    """Does this dispatch name *require* a planned schedule?  ``dense``'s
    optional row does not count (it runs schedule-less unless handed
    one).  Unknown names raise.  JAX ``fabric.consumes_schedule``."""
    return name == _SCHEDULED_ALIAS or _schedule_kind(name) in ("static", "row")


def consumes_table(name: str) -> bool:
    """Does this dispatch name consume ``ScheduleTable`` rows that a
    controller swaps between steps?  False for ``ppermute``, whose plans
    the JAX package bakes into its executable.  JAX ``fabric.consumes_table``."""
    return name == _SCHEDULED_ALIAS or _schedule_kind(name) == "row"


@dataclasses.dataclass(frozen=True)
class FabricContext:
    """What a fabric's hooks receive.  On one device the virtual fabric's
    rank count lives in the schedule row; the multi-rank fabrics add the
    movement's own rank count and index here."""

    cfg: Any  # ModelConfig
    schedule: Any  # ScheduleTable row or None

    @property
    def moe(self):
        return self.cfg.moe


@dataclasses.dataclass
class PackedTokens:
    """A fabric's packed slot space: ``buf`` [.., d] with slot-aligned
    ``pos``/``gate``/``live``; ``admitted`` is the [T*k] admission mask.
    ``wire`` is the slot-shaped bool mask of the slots that cross the
    fabric (live remote slots), the wire codec's domain; None: nothing
    crosses (the schedule-less path)."""

    buf: torch.Tensor
    pos: torch.Tensor
    gate: torch.Tensor
    live: torch.Tensor
    admitted: torch.Tensor
    wire: torch.Tensor | None = None

"""``dense`` fabric, the one-device *virtual* fabric.

Tokens stay put and are grouped by expert into ``[E, C, d]``.  Handed a
``ScheduleTable`` row, it maps tokens to ``row.n`` virtual sources by
contiguous blocks and experts to virtual ranks by contiguous placement,
and clips gates through the shared admission mask, so the schedule
decides which tokens reach the expert GEMM even on one card.
Counterpart of ``repro/parallel/fabric/dense.py``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.schedule import A2ASchedule, ScheduleTable
from repro_torch.parallel.fabric import geometry as g
from repro_torch.parallel.fabric.base import FabricContext, PackedTokens

__all__ = ["DenseFabric"]


class DenseFabric:
    name = "dense"

    def validate_schedule(self, schedule):
        """A row is used, None or a static plan means schedule-less."""
        if schedule is None or isinstance(schedule, A2ASchedule):
            return None
        if not isinstance(schedule, ScheduleTable):
            raise ValueError(f"dense: needs a ScheduleTable row (got {type(schedule).__name__})")
        if not schedule.is_row:
            raise ValueError("dense: rejected a full ScheduleTable — pass table.row(l)")
        return schedule

    def pack(self, ctx: FabricContext, x_loc, idx, gates) -> PackedTokens:
        m = ctx.moe
        t = x_loc.shape[0]
        row = ctx.schedule
        admitted = None
        if row is not None:
            tok = torch.arange(t * m.top_k, dtype=torch.int64, device=x_loc.device) // m.top_k
            src = (tok * row.n) // t  # contiguous virtual source blocks
            gates, admitted = g.admission_mask(idx, gates, row, m.n_experts, src=src)
        cap = g.round8(math.ceil(t * m.top_k / m.n_experts * m.capacity_factor))
        buf, pos, gate, live = g.group_tokens(
            x_loc, idx.reshape(-1), gates.reshape(-1), m.n_experts, cap, admitted=admitted
        )
        if admitted is None:
            admitted = torch.ones(t * m.top_k, dtype=torch.bool, device=x_loc.device)
        return PackedTokens(buf, pos, gate, live, admitted)

    def dispatch(self, ctx: FabricContext, packed: PackedTokens):
        """One block: the whole ``[E, C, d]`` buffer with its explicit
        slot validity (a real admitted token, not the gate sign)."""
        return [(packed.buf, packed.live)], None

    def combine(self, ctx: FabricContext, packed: PackedTokens, state, ys):
        return ys[0]

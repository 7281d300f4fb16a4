"""``dense`` fabric, the one-device *virtual* fabric.

Tokens stay put and are grouped by expert into ``[E, C, d]``.  Handed a
``ScheduleTable`` row, it maps tokens to ``row.n`` virtual sources by
contiguous blocks and experts to virtual ranks by contiguous placement,
and clips gates through the shared admission mask, so the schedule
decides which tokens reach the expert GEMM even on one card.  A slot
whose token's virtual source differs from its bucket's virtual rank
crosses the (virtual) wire: the wire codec quantizes it.  Tokens never
leave the device, so the dispatch slot count is 0.  Counterpart of
``repro/parallel/fabric/dense.py``; its hierarchical-row branch comes
with the hierarchical tables.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.cost_models import wire_bytes_per_token
from repro_torch.core.schedule import A2ASchedule, ScheduleTable
from repro_torch.parallel.fabric import geometry as g
from repro_torch.parallel.fabric.base import FabricContext, PackedTokens
from repro_torch.parallel.fabric.codec import get_codec

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
        wire = None
        if row is not None:
            # a slot crosses the virtual wire iff its token's contiguous source block differs from its
            # bucket's rank: the src/dst convention the admission mask enforces (padding slots die via live)
            dst_v = torch.arange(m.n_experts, device=x_loc.device) // (m.n_experts // row.n)
            src_v = (pos * row.n) // t
            wire = live & (src_v != dst_v[:, None])
        if admitted is None:
            admitted = torch.ones(t * m.top_k, dtype=torch.bool, device=x_loc.device)
        return PackedTokens(buf, pos, gate, live, admitted, wire=wire)

    def dispatch(self, ctx: FabricContext, packed: PackedTokens):
        """One block: the whole ``[E, C, d]`` buffer with its explicit
        slot validity (a real admitted token, not the gate sign)."""
        return [(packed.buf, packed.live)], None

    def combine(self, ctx: FabricContext, packed: PackedTokens, state, ys):
        return ys[0]

    def wire_encode(self, ctx: FabricContext, packed: PackedTokens) -> PackedTokens:
        """QDQ the wire-crossing slots to ``MoECfg.wire_dtype``'s codec
        before dispatch; the bf16 identity and a maskless pack return
        ``packed`` unchanged.  An unknown codec name raises listing them."""
        codec = get_codec(ctx.moe.wire_dtype)
        if codec.is_identity or packed.wire is None:
            return packed
        return dataclasses.replace(packed, buf=codec.apply(packed.buf, packed.wire))

    def wire_decode(self, ctx: FabricContext, packed: PackedTokens, y_slots: torch.Tensor) -> torch.Tensor:
        """QDQ the processed slots on the combine leg through the same
        codec: ``y_slots`` is slot-aligned with ``packed.buf``, so the
        pack-time mask marks the slots whose results cross back."""
        codec = get_codec(ctx.moe.wire_dtype)
        if codec.is_identity or packed.wire is None:
            return y_slots
        return codec.apply(y_slots, packed.wire)

    def dispatch_tokens(self, *, n: int, cap_uniform: int = 0, schedule=None, envelope=None) -> float:
        """Zero: no token crosses an EP fabric (the multi-rank dense path
        pays a ``[T, d]`` activation all-reduce instead, not a dispatch byte)."""
        return 0.0

    def dispatch_bytes(
        self, *, d_model: int, wire_dtype: str = "bf16", compute_bytes: int = 2, n: int, cap_uniform: int = 0,
        schedule=None, envelope=None,
    ) -> float:
        """Per-rank dispatch bytes under ``wire_dtype``'s codec: the slots
        priced at ``wire_bytes_per_token`` (payload at the codec's width
        plus the per-slot scale the quantized codecs ship)."""
        tokens = self.dispatch_tokens(n=n, cap_uniform=cap_uniform, schedule=schedule, envelope=envelope)
        return tokens * wire_bytes_per_token(d_model, wire_dtype, compute_bytes)

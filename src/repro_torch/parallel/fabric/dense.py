"""``dense`` fabric: the one-device *virtual* fabric and, across ranks,
no-A2A expert parallelism (all-reduce combine).

Tokens stay put and are grouped by expert into ``[E, C, d]``.  Handed a
``ScheduleTable`` row, it maps tokens to ``row.n`` virtual sources by
contiguous blocks and experts to virtual ranks by contiguous placement,
and clips gates through the shared admission mask, so the schedule
decides which tokens reach the expert GEMM even on one card.  A slot
whose token's virtual source differs from its bucket's virtual rank
crosses the (virtual) wire: the wire codec quantizes it.

Across ranks (a world of n > 1 EP ranks) every rank packs the model
group's replicated tokens the same way (admission reads the same virtual
sources as on one device), runs only its local experts' ``[e_local, C,
d]`` block, scatters their outputs back and an all-reduce over the model
group sums them.  No token crosses the fabric: the price is the ``[T, d]``
f32 all-reduce.  This is what ``moe_apply`` runs for ``dispatch="dense"``
and for shapes the EP split cannot cut (decode at S = 1), as JAX's
``moe_apply`` falls back on a mesh.

A ``HierarchicalTable`` row is served too (the one-device parity path of
the hierarchical fabric): admission reads the pair's summed per-pair
caps, and only pod-crossing slots ride the wire.  Counterpart of
``repro/parallel/fabric/dense.py``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.hierarchical import HierarchicalTable, check_pod_size
from repro_torch.core.schedule import A2ASchedule
from repro_torch.parallel import collectives as col
from repro_torch.parallel.fabric import geometry as g
from repro_torch.parallel.fabric.base import Fabric, FabricContext, PackedTokens, register_fabric

__all__ = ["DenseFabric"]


@register_fabric
class DenseFabric(Fabric):
    name = "dense"
    uses_mesh = False
    schedule_kind = "optional_row"

    def validate_schedule(self, schedule, *, n: int = 1):
        """A row is used; None or a static plan means schedule-less (a
        static plan has no meaning without phases: dense layers ignore it)."""
        if schedule is None or isinstance(schedule, A2ASchedule):
            return None
        if isinstance(schedule, HierarchicalTable):
            if not schedule.is_row:
                raise ValueError("dense: rejected a full HierarchicalTable — pass table.row(l)")
            check_pod_size(schedule.n, schedule.pod_size)
            return schedule
        return super().validate_schedule(schedule, n=n)

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
            if isinstance(row, HierarchicalTable):
                # two levels: only pod-crossing slots ride the inter wire (same-pod remote slots move on the
                # electrical level, which the codec never touches)
                wire = live & ~g.same_pod(src_v, dst_v[:, None], row.pod_size)
            else:
                wire = live & (src_v != dst_v[:, None])
        if admitted is None:
            admitted = torch.ones(t * m.top_k, dtype=torch.bool, device=x_loc.device)
        return PackedTokens(buf, pos, gate, live, admitted, wire=wire)

    def _local(self, ctx: FabricContext) -> slice:
        """This rank's experts' buckets (all of them on one device)."""
        if not ctx.ep:
            return slice(None)
        return slice(ctx.me * ctx.e_local, (ctx.me + 1) * ctx.e_local)

    def dispatch(self, ctx: FabricContext, packed: PackedTokens):
        """One block: the local experts' ``[e_local, C, d]`` buckets (all
        of ``[E, C, d]`` on one device) with their explicit slot validity
        (a real admitted token, not the gate sign)."""
        lo = self._local(ctx)
        return [(packed.buf[lo], packed.live[lo])], None

    def combine(self, ctx: FabricContext, packed: PackedTokens, state, ys):
        return ys[0]

    def unpack(self, ctx: FabricContext, packed: PackedTokens, y_slots, t: int) -> torch.Tensor:
        if not ctx.ep:
            return super().unpack(ctx, packed, y_slots, t)
        lo = self._local(ctx)
        if packed.wire is not None:
            y_slots = self.wire_decode(ctx, PackedTokens(
                packed.buf[lo], packed.pos[lo], packed.gate[lo], packed.live[lo], packed.admitted,
                wire=packed.wire[lo]), y_slots)
        y = g.ungroup(y_slots, packed.pos[lo], packed.gate[lo], t)  # this rank's experts' share
        return col.all_reduce_sum(y, ctx.group)

    def dispatch_tokens(self, *, n: int, cap_uniform: int = 0, schedule=None, envelope=None) -> float:
        """Zero: no token crosses an EP fabric (the multi-rank dense path
        pays a ``[T, d]`` activation all-reduce instead, not a dispatch byte)."""
        return 0.0

"""``a2a`` fabric: one monolithic all-to-all each way (the paper's baseline).

Tokens are cut over the EP ranks and grouped into uniform
capacity-factor buckets, bucket id ``dst_rank * e_local + local_expert``
(the expert id); one ``all_to_all`` dispatches every bucket and one
returns the processed slots.  Every remote pair pays the full bucket
whatever the traffic: the padding the decomposition fabrics exist to
avoid.  Ignores ``schedule=`` (no plan to execute).  Counterpart of
``repro/parallel/fabric/a2a.py``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.parallel import collectives as col
from repro_torch.parallel.fabric import geometry as g
from repro_torch.parallel.fabric.base import Fabric, FabricContext, PackedTokens, register_fabric

__all__ = ["MonolithicA2AFabric"]


@register_fabric
class MonolithicA2AFabric(Fabric):
    name = "a2a"
    schedule_kind = "none"

    def pack(self, ctx: FabricContext, x_loc, idx, gates) -> PackedTokens:
        m = ctx.moe
        t = x_loc.shape[0]
        cap = g.round8(math.ceil(t * m.top_k / (ctx.n * ctx.e_local) * m.capacity_factor))
        buf, pos, gate, live = g.group_tokens(x_loc, idx.reshape(-1), gates.reshape(-1), ctx.n * ctx.e_local, cap)
        return PackedTokens(
            buf, pos, gate, live,
            admitted=torch.ones(t * m.top_k, dtype=torch.bool, device=x_loc.device),  # no plan: admit all
            meta=cap,
            wire=g.wire_mask_buckets(live, ctx.e_local, ctx.me),
        )

    def dispatch(self, ctx: FabricContext, packed: PackedTokens):
        n, e_local, cap = ctx.n, ctx.e_local, packed.meta
        d = packed.buf.shape[-1]
        recv = col.a2a_dispatch(packed.buf.reshape(n, e_local, cap, d), ctx.group, count=True)
        grouped = recv.transpose(0, 1).reshape(e_local, n * cap, d)  # [n(src), e_local, C, d] by expert
        return [(grouped, None)], None

    def combine(self, ctx: FabricContext, packed: PackedTokens, state, ys):
        n, e_local, cap = ctx.n, ctx.e_local, packed.meta
        d = packed.buf.shape[-1]
        y = ys[0].reshape(e_local, n, cap, d).transpose(0, 1)
        return col.a2a_combine(y, ctx.group).reshape(n * e_local, cap, d)

    def dispatch_tokens(self, *, n: int, cap_uniform: int = 0, schedule=None, envelope=None) -> float:
        """``(n - 1) * cap_uniform`` slots a rank: every remote pair padded
        to the uniform pair bucket."""
        return float((n - 1) * int(cap_uniform))

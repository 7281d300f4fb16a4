"""``ppermute`` fabric: a static decomposed plan as circuit phases.

The all-to-all is decomposed on the host (max-weight, shift or BvN) into
K phases with per-phase capacities; each phase is one permutation of the
EP ranks, with idle pairs shipping nothing (the circuit stays dark).
The plan is fixed for the run (the launcher bakes a uniform one), so a
controller cannot swap it: use ``phase_pipelined`` / ``ragged_a2a`` for
table rows.  The received phase blocks concatenate along the capacity dim
into ONE grouped GEMM (K1) a layer call, so K phases do not fragment the
expert batch; under 2D expert sharding each phase's block keeps a GEMM
of its own (K + 1 launches), as in JAX.  This is the bytes floor of the
executing fabrics (caps, not envelopes, no emulation padding).  Counterpart of
``repro/parallel/fabric/ppermute.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.cost_models import phase_dispatch_tokens
from repro_torch.core.schedule import A2ASchedule, phase_offsets
from repro_torch.parallel import collectives as col
from repro_torch.parallel.fabric import geometry as g
from repro_torch.parallel.fabric.base import Fabric, FabricContext, PackedTokens, register_fabric

__all__ = ["PPermuteFabric"]


@register_fabric
class PPermuteFabric(Fabric):
    name = "ppermute"
    schedule_kind = "static"

    def pack(self, ctx: FabricContext, x_loc, idx, gates) -> PackedTokens:
        m = ctx.moe
        n, e_local = ctx.n, ctx.e_local
        t = x_loc.shape[0]
        schedule: A2ASchedule = ctx.schedule
        # capacities in per-expert units; the local bucket gets at least the uniform cap
        cap_uni = g.round8(math.ceil(t * m.top_k / (n * e_local) * m.capacity_factor))
        phase_caps = g.round8(-(-schedule.caps.astype(np.int64) // e_local))
        if schedule.offsets is not None:
            # multi-phase pairs (BvN): the bucket holds each pair's total across phases
            per_pair = schedule.cap_matrix(caps=phase_caps)
            c_max = max(cap_uni, int(per_pair.max()))
            offsets = phase_offsets(schedule.perms, schedule.valid, phase_caps).astype(schedule.offsets.dtype)
        else:
            c_max = max(cap_uni, int(phase_caps.max()))
            offsets = None
        sched_pe = A2ASchedule(  # the plan in per-expert units
            perms=schedule.perms, caps=np.asarray(phase_caps, dtype=np.int32), valid=schedule.valid, offsets=offsets,
        )
        buf, pos, gate, live = g.group_tokens(x_loc, idx.reshape(-1), gates.reshape(-1), n * e_local, c_max)
        return PackedTokens(
            buf, pos, gate, live,
            admitted=torch.ones(t * m.top_k, dtype=torch.bool, device=x_loc.device),  # plan caps via buckets
            meta=(sched_pe, c_max),
            wire=g.wire_mask_buckets(live, e_local, ctx.me),
        )

    def dispatch(self, ctx: FabricContext, packed: PackedTokens):
        sched_pe, c_max = packed.meta
        d = packed.buf.shape[-1]
        buf = packed.buf.reshape(ctx.n, ctx.e_local, c_max, d)
        blocks = col.scheduled_dispatch(buf, sched_pe, ctx.group, ctx.me, count=True)
        if ctx.two_d:
            # 2D expert sharding keeps one GEMM a phase, as JAX does: each block's gather over the data group
            # stays one phase's capacity (the concatenated buffer would gather every phase at once)
            return [(blk, None) for blk in blocks], None
        # one grouped GEMM over the concatenated phase blocks (one K1 launch, not K + 1)
        sizes = [int(blk.shape[1]) for blk in blocks]
        return [(torch.cat(blocks, dim=1), None)], sizes

    def combine(self, ctx: FabricContext, packed: PackedTokens, state, ys):
        sched_pe, c_max = packed.meta
        d = packed.buf.shape[-1]
        parts = list(ys) if state is None else list(torch.split(ys[0], state, dim=1))
        back = col.scheduled_combine(parts, sched_pe, ctx.group, ctx.me, c_max)
        return back.reshape(ctx.n * ctx.e_local, c_max, d)

    def dispatch_tokens(self, *, n: int, cap_uniform: int = 0, schedule=None, envelope=None) -> float:
        """The plan's own caps over the phases a rank takes part in (dark
        pairs ship nothing)."""
        if schedule is None:
            raise ValueError("ppermute accounting needs the A2ASchedule")
        return float(np.mean(phase_dispatch_tokens(schedule.valid, schedule.caps)))

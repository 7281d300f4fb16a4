"""``phase_pipelined`` fabric: ``ScheduleTable`` rows against a static
phase envelope, the production scheduled path.

The row is ordinary tensor input, so a re-planned table (refilled in
place by the controller) reaches the next layer call with nothing
rebuilt.  Two executions, chosen by whether the row carries an envelope:

**Phase-pipelined (envelope set).**  Dispatch is phase-major: the K_max
phase slots are unrolled, phase k moving a bucket sized to the static
envelope ``envelope_slots[k]``.  Each received phase block enters its own
grouped GEMM (one K1 launch a live phase, the local block last).
Admission and buffer sizing read the same envelope-clamped
``phase_slot_caps``, so every admitted token has a slot.  Each phase
rides a dense all-to-all-shaped buffer ``[n, e_local, env_k, d]`` with one
live destination (JAX's emulation: a plan held in tensors cannot name
the peer of a static pair list), so every rank ships ``(n - 1) *
env_k`` slots a live phase, what ``dispatch_tokens_padded`` counts; the
``ragged_a2a`` fabric keeps this geometry and swaps only the transfer.

**Monolithic (no envelope).**  One dense all-to-all over uniform
capacity-factor buckets; the plan clips through the admission mask, and
what a plan over-promises past the bucket is counted in ``dropped``.

A validity mask (f32 on the wire) travels with the tokens, so the
receiver's K1 skips dark row tiles.  Counterpart of
``repro/parallel/fabric/phase_pipelined.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.cost_models import phase_dispatch_tokens
from repro_torch.parallel import collectives as col
from repro_torch.parallel.fabric import geometry as g
from repro_torch.parallel.fabric.base import Fabric, FabricContext, PackedTokens, register_fabric

__all__ = ["PhasePipelinedFabric"]


@dataclasses.dataclass
class _PhaseMeta:
    """Geometry threaded pack -> dispatch -> combine."""

    bases: tuple[int, ...]
    env_slots: tuple[int, ...]
    c_local: int
    s_remote: int
    on_k: Any  # [K] bool: my participation per phase
    dst_k: Any  # [K] int64: my destination per phase
    on_all: Any  # [K, n] bool: everyone's participation
    host: Any = None  # (perms [K, n], on_all [K, n]) numpy: the ragged transfer's split sizes


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


@register_fabric
class PhasePipelinedFabric(Fabric):
    name = "phase_pipelined"
    schedule_kind = "row"

    # ------------------------------------------------------------- packing
    def pack(self, ctx: FabricContext, x_loc, idx, gates) -> PackedTokens:
        row = ctx.schedule
        if row.envelope is None:
            return self._pack_mono(ctx, x_loc, idx, gates)
        m = ctx.moe
        n, e_local = ctx.n, ctx.e_local
        t = x_loc.shape[0]
        e_flat = idx.reshape(-1)
        rank = g.rank_in_group(e_flat.long())
        # local bucket: the uniform cap, floored at the largest envelope slot
        cap_uni = g.round8(math.ceil(t * m.top_k / (n * e_local) * m.capacity_factor))
        env_slots = row.envelope_slots(e_local)
        c_local = max(cap_uni, max(env_slots) if env_slots else cap_uni)
        slot, admitted, bases, env_slots, n_slots, on_k, dst_k = g.phase_slot_assign(
            row, e_local, ctx.me, e_flat, rank, c_local=c_local
        )
        gates = gates * admitted.reshape(gates.shape)
        buf, pos, gate, live = g.pack_slots(x_loc, slot, gates.reshape(-1), admitted, n_slots)
        k_idx = torch.arange(row.k_max, device=row.perms.device)
        on_all = (k_idx < row.n_phases)[:, None] & row.valid
        meta = _PhaseMeta(bases=bases, env_slots=env_slots, c_local=c_local, s_remote=n_slots - e_local * c_local,
                          on_k=on_k, dst_k=dst_k, on_all=on_all)
        # wire domain: every live slot of the phase-major remote region (the local block never leaves)
        wire = live & (torch.arange(n_slots, device=live.device) < meta.s_remote)
        return PackedTokens(buf, pos, gate, live, admitted, meta=meta, wire=wire)

    def _pack_mono(self, ctx: FabricContext, x_loc, idx, gates) -> PackedTokens:
        m = ctx.moe
        n, e_local = ctx.n, ctx.e_local
        t = x_loc.shape[0]
        src = torch.full((t * m.top_k,), ctx.me, dtype=torch.int64, device=x_loc.device)
        gates, admitted = g.admission_mask(idx, gates, ctx.schedule, m.n_experts, src=src)
        # the buffer cannot follow the plan: every bucket gets the uniform cap, the plan clips within it
        c_max = g.round8(math.ceil(t * m.top_k / (n * e_local) * m.capacity_factor))
        buf, pos, gate, live = g.group_tokens(
            x_loc, idx.reshape(-1), gates.reshape(-1), n * e_local, c_max, admitted=admitted
        )
        return PackedTokens(buf, pos, gate, live, admitted, meta=c_max,
                            wire=g.wire_mask_buckets(live, e_local, ctx.me))

    # ------------------------------------------------------ phase transfer
    # The one seam between phase_pipelined and ragged_a2a: geometry,
    # admission, the per-phase GEMMs and the combine are shared, so the two
    # are equal bit for bit and differ only in the bytes on the wire.
    def _transfer(self, ctx, k, region, vregion, meta: _PhaseMeta):
        """Phase k forward: my [e_local, ck, d] block to ``dst_k[k]``.
        Returns (blk, vblk), the block I serve this phase (zeros when
        nobody targets me).  Emulation: one live destination in an
        all-to-all-shaped buffer."""
        n = ctx.n
        dst = meta.dst_k[k:k + 1]
        send = torch.zeros((n, *region.shape), dtype=region.dtype, device=region.device).index_add(
            0, dst, torch.where(meta.on_k[k], region, _zero(region))[None])
        vsend = torch.zeros((n, *vregion.shape), dtype=torch.float32, device=region.device).index_add(
            0, dst, torch.where(meta.on_k[k], vregion.float(), 0.0)[None])
        recv = col.a2a_dispatch(send, ctx.group, count=True)
        vrecv = col.a2a_dispatch(vsend, ctx.group)
        return recv.sum(dim=0), vrecv.sum(dim=0) > 0  # exactly one live source, or zeros

    def _transfer_back(self, ctx, k, y_k, meta: _PhaseMeta):
        """Phase k return: my processed block back to whoever targeted me
        (the inverse permutation).  Returns the [e_local, ck, d] block of MY
        tokens processed remotely (garbage where I did not take part: the
        caller masks with ``on_k[k]``)."""
        n = ctx.n
        perm = ctx.schedule.perms[k].long()
        inv = torch.zeros(n, dtype=torch.int64, device=perm.device).scatter(
            0, perm, torch.arange(n, device=perm.device))
        got_any = torch.zeros(n, dtype=torch.int32, device=perm.device).index_add(
            0, perm, meta.on_all[k].int())[ctx.me] > 0
        back_send = torch.zeros((n, *y_k.shape), dtype=y_k.dtype, device=y_k.device).index_add(
            0, inv[ctx.me:ctx.me + 1], torch.where(got_any, y_k, _zero(y_k))[None])
        return col.a2a_combine(back_send, ctx.group).sum(dim=0)

    # ------------------------------------------------------------ dispatch
    def dispatch(self, ctx: FabricContext, packed: PackedTokens):
        if ctx.schedule.envelope is None:
            return self._dispatch_mono(ctx, packed)
        meta: _PhaseMeta = packed.meta
        e_local = ctx.e_local
        d = packed.buf.shape[-1]
        blocks, records = [], []
        for k, ck in enumerate(meta.env_slots):
            if ck == 0:
                continue  # dark phase slot: no bytes, no compute
            lo, hi = meta.bases[k], meta.bases[k] + e_local * ck
            region = packed.buf[lo:hi].reshape(e_local, ck, d)
            vregion = packed.live[lo:hi].reshape(e_local, ck)
            blocks.append(self._transfer(ctx, k, region, vregion, meta))
            records.append((k, ck))
        # the local block never crosses the fabric
        blocks.append((packed.buf[meta.s_remote:].reshape(e_local, meta.c_local, d),
                       packed.live[meta.s_remote:].reshape(e_local, meta.c_local)))
        return blocks, records

    def _dispatch_mono(self, ctx: FabricContext, packed: PackedTokens):
        n, e_local, c_max = ctx.n, ctx.e_local, packed.meta
        d = packed.buf.shape[-1]
        recv = col.a2a_dispatch(packed.buf.reshape(n, e_local, c_max, d), ctx.group, count=True)
        recv_v = col.a2a_dispatch(packed.live.reshape(n, e_local, c_max).float(), ctx.group)
        grouped = recv.transpose(0, 1).reshape(e_local, n * c_max, d)
        live_r = recv_v.transpose(0, 1).reshape(e_local, n * c_max) > 0
        return [(grouped, live_r)], None

    # ------------------------------------------------------------- combine
    def combine(self, ctx: FabricContext, packed: PackedTokens, state, ys):
        if ctx.schedule.envelope is None:
            return self._combine_mono(ctx, packed, ys)
        meta: _PhaseMeta = packed.meta
        d = packed.buf.shape[-1]
        parts = []  # the phase blocks in layout order (dark slots hold no rows), then the local block
        for (k, ck), y_k in zip(state, ys):
            back = self._transfer_back(ctx, k, y_k, meta)
            parts.append(torch.where(meta.on_k[k], back, _zero(back)).reshape(ctx.e_local * ck, d))
        parts.append(ys[-1].reshape(ctx.e_local * meta.c_local, d))
        return torch.cat(parts)

    def _combine_mono(self, ctx: FabricContext, packed: PackedTokens, ys):
        n, e_local, c_max = ctx.n, ctx.e_local, packed.meta
        d = packed.buf.shape[-1]
        y = ys[0].reshape(e_local, n, c_max, d).transpose(0, 1)
        return col.a2a_combine(y, ctx.group).reshape(n * e_local, c_max, d)

    # ---------------------------------------------------------- accounting
    def dispatch_tokens(self, *, n: int, cap_uniform: int = 0, schedule=None, envelope=None) -> float:
        """The slots the *plan* puts on the wire: a rank pays ``envelope[k]``
        for each phase slot it takes part in, zero on dark pairs (what a
        circuit fabric or ``ragged_a2a`` carries)."""
        if schedule is None or envelope is None:
            raise ValueError("phase_pipelined accounting needs the plan's valid mask and the envelope")
        k = min(schedule.valid.shape[0], len(np.asarray(envelope)))
        return float(np.mean(phase_dispatch_tokens(schedule.valid[:k], np.asarray(envelope)[:k])))

    def dispatch_tokens_padded(self, *, n: int, envelope=None) -> float:
        """What the dense emulation ships: every live phase slot rides a full
        ``[n, ...]`` buffer, so every rank pays ``(n - 1) * envelope[k]``
        slots a live phase slot, taking part or not."""
        if envelope is None:
            raise ValueError("phase_pipelined accounting needs the envelope")
        env = np.asarray(envelope, dtype=np.int64)
        return float((n - 1) * env[env > 0].sum())

"""``ragged_a2a`` fabric: phase-pipelined dispatch whose per-phase
transfer carries exactly the live envelope bytes per pair.

Subclasses ``phase_pipelined``: geometry, admission, the per-phase
grouped GEMMs and the combine are shared, so the results equal the
parent's bit for bit; only the movement differs.  Where the parent's
emulation ships a full ``[n, ...]`` buffer with one live destination,
each phase here is one ``all_to_all_single`` whose split sizes are
``e_local * env_k`` slots for the live pair and 0 for every other: the
bytes the cost model counts, with no emulation tax.

Split sizes are host ints, so each layer call reads its row's ``perms``,
``valid`` and ``n_phases`` to the host once (one device-to-host copy at
``pack``), not the controller's host mirror: the row the layer runs is
the one whose sizes it ships.  JAX's ``REPRO_FORCE_RAGGED`` and
``ragged_available`` have no counterpart: the port always runs the
ragged movement.  Counterpart of ``repro/parallel/fabric/ragged_a2a.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.parallel import collectives as col
from repro_torch.parallel.fabric.base import FabricContext, PackedTokens, register_fabric
from repro_torch.parallel.fabric.phase_pipelined import PhasePipelinedFabric, _PhaseMeta

__all__ = ["RaggedA2AFabric"]


def _host_plan(row):
    """(perms [K, n], on_all [K, n]) of a row on the host, in one copy."""
    k_max, n = row.perms.shape
    flat = torch.cat([row.perms.reshape(-1).long(), row.valid.reshape(-1).long(),
                      row.n_phases.reshape(1).long()]).cpu().numpy()
    perms = flat[:k_max * n].reshape(k_max, n)
    valid = flat[k_max * n:2 * k_max * n].reshape(k_max, n).astype(bool)
    on_all = (np.arange(k_max) < flat[-1])[:, None] & valid
    return perms, on_all


@register_fabric
class RaggedA2AFabric(PhasePipelinedFabric):
    name = "ragged_a2a"
    schedule_kind = "row"
    requires_envelope = True

    def pack(self, ctx: FabricContext, x_loc, idx, gates) -> PackedTokens:
        packed = super().pack(ctx, x_loc, idx, gates)
        packed.meta = dataclasses.replace(packed.meta, host=_host_plan(ctx.schedule))
        return packed

    @staticmethod
    def _peers(ctx, k, meta: _PhaseMeta):
        """(my destination or None, the rank that targets me or None) in phase k."""
        perms, on_all = meta.host
        me = ctx.me
        dst = int(perms[k, me]) if on_all[k, me] else None
        sender = int(np.nonzero(perms[k] == me)[0][0])
        return dst, sender if on_all[k, sender] else None

    def _transfer(self, ctx, k, region, vregion, meta: _PhaseMeta):
        e_local, ck, d = region.shape
        dst, sender = self._peers(ctx, k, meta)
        blk = col.ppermute(region.reshape(e_local * ck, d), ctx.group, dst=dst, src=sender, count=True)
        # validity as f32 on the wire, as the parent's emulation ships it
        vblk = col.ppermute(vregion.float().reshape(e_local * ck), ctx.group, dst=dst, src=sender)
        return blk.reshape(e_local, ck, d), vblk.reshape(e_local, ck) > 0

    def _transfer_back(self, ctx, k, y_k, meta: _PhaseMeta):
        e_local, ck, d = y_k.shape
        dst, sender = self._peers(ctx, k, meta)
        # the reverse circuit: my processed block back to whoever targeted me; my own tokens
        # come back from the rank I dispatched to
        back = col.ppermute(y_k.reshape(e_local * ck, d), ctx.group, dst=sender, src=dst)
        return back.reshape(e_local, ck, d)

    def dispatch_tokens(self, *, n: int, cap_uniform: int = 0, schedule=None, envelope=None) -> float:
        """Exactly the live envelope slots: ``envelope[k]`` for each phase a
        rank takes part in, zero on dark pairs."""
        if schedule is None or envelope is None:
            raise ValueError("ragged_a2a accounting needs the plan's valid mask and the envelope")
        return super().dispatch_tokens(n=n, schedule=schedule, envelope=envelope)

"""``hierarchical`` fabric: intra-pod electrical dispatch under an
inter-pod circuit schedule, two registered fabrics composed into one.

It consumes a ``core.HierarchicalTable`` row (an intra and an inter
``ScheduleTable`` row from ``hierarchical_plan`` or a
``HierarchicalRuntime``) and runs both plans through the shared
phase-pipelined geometry:

* the pair is ``merged()`` into one flat row with phase axis ``[intra
  slots | inter slots]``, so packing, admission, the per-phase grouped
  GEMMs and the combine are ``phase_pipelined``'s;
* the movement of each phase goes to a composed child through the
  ``_transfer`` / ``_transfer_back`` seam: intra phases to
  ``phase_pipelined`` (the dense per-phase emulation), inter phases to
  ``ragged_a2a`` (exactly the live envelope slots of the pair);
* ``PackedTokens.wire`` marks only the inter-phase slots, so a wire codec
  quantizes the inter-pod bytes and the intra-pod ones stay at compute
  width; ``dispatch_bytes`` prices the two levels so.

``validate_schedule`` and the accounting recurse into both children; a
pod size that does not tile the fabric raises ``core.check_pod_size``'s
``ValueError``.  Counterpart of ``repro/parallel/fabric/hierarchical.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cost_models import wire_bytes_per_token
from repro_torch.core.hierarchical import HierarchicalTable, check_pod_size
from repro_torch.parallel.fabric.base import FabricContext, PackedTokens, _chain_hint, get_fabric, register_fabric
from repro_torch.parallel.fabric.phase_pipelined import PhasePipelinedFabric, _PhaseMeta
from repro_torch.parallel.fabric.ragged_a2a import _host_plan

__all__ = ["HierarchicalFabric"]


@dataclasses.dataclass
class _HierMeta(_PhaseMeta):
    """The merged row's phase geometry and the first inter phase slot."""

    k_intra: int = 0


@register_fabric
class HierarchicalFabric(PhasePipelinedFabric):
    name = "hierarchical"
    schedule_kind = "row"
    requires_envelope = True

    # the composed children, by registry name
    intra_backend = "phase_pipelined"
    inter_backend = "ragged_a2a"

    def _children(self):
        return get_fabric(self.intra_backend), get_fabric(self.inter_backend)

    # ------------------------------------------------------------ schedule
    def validate_schedule(self, schedule, *, n: int):
        hint = _chain_hint(self.name)
        if not isinstance(schedule, HierarchicalTable):
            raise ValueError(
                f"{self.name}: needs a HierarchicalTable (an intra+inter ScheduleTable pair — build one with "
                f"core.hierarchical_plan or a HierarchicalRuntime); got {type(schedule).__name__}" + hint
            )
        n_eff = schedule.n if not self.uses_mesh else n
        try:
            check_pod_size(n_eff, schedule.pod_size)
        except ValueError as e:
            raise ValueError(f"{self.name}: {e}" + hint) from None
        # each level must satisfy the row contract of the child that moves it
        intra_f, inter_f = self._children()
        for level, child, fab in (("intra", schedule.intra, intra_f), ("inter", schedule.inter, inter_f)):
            try:
                fab.validate_schedule(child, n=n)
            except ValueError as e:
                raise ValueError(f"{self.name}: {level} level rejected by its {fab.name!r} child — {e}") from None
        if schedule.intra.n != schedule.inter.n:
            raise ValueError(
                f"{self.name}: levels disagree on fabric size (intra n={schedule.intra.n}, inter "
                f"n={schedule.inter.n})" + hint
            )
        return schedule

    # ------------------------------------------------------------ pipeline
    @staticmethod
    def _merged_ctx(ctx: FabricContext) -> FabricContext:
        return dataclasses.replace(ctx, schedule=ctx.schedule.merged())

    def pack(self, ctx: FabricContext, x_loc, idx, gates) -> PackedTokens:
        hrow: HierarchicalTable = ctx.schedule
        mctx = self._merged_ctx(ctx)
        packed = super().pack(mctx, x_loc, idx, gates)
        meta: _PhaseMeta = packed.meta
        # the wire is the inter seam only: slots of phase blocks k >= k_intra; intra-phase slots move on
        # electrical links at compute width, which the codec must not touch
        ki = hrow.intra.k_max
        intra_end = meta.bases[ki] if ki < len(meta.bases) else meta.s_remote
        s = torch.arange(packed.buf.shape[0], device=packed.buf.device)
        wire = packed.live & (s >= intra_end) & (s < meta.s_remote)
        # the inter child's transfers read the merged row's split sizes from the host, once a layer call
        fields = {f.name: getattr(meta, f.name) for f in dataclasses.fields(meta)}
        meta = _HierMeta(**{**fields, "host": _host_plan(mctx.schedule)}, k_intra=ki)
        return dataclasses.replace(packed, meta=meta, wire=wire)

    def _child(self, k: int, meta: _HierMeta):
        intra_f, inter_f = self._children()
        return intra_f if k < meta.k_intra else inter_f

    def _transfer(self, ctx, k, region, vregion, meta: _HierMeta):
        return self._child(k, meta)._transfer(ctx, k, region, vregion, meta)

    def _transfer_back(self, ctx, k, y_k, meta: _HierMeta):
        return self._child(k, meta)._transfer_back(ctx, k, y_k, meta)

    def dispatch(self, ctx: FabricContext, packed: PackedTokens):
        return super().dispatch(self._merged_ctx(ctx), packed)

    def combine(self, ctx: FabricContext, packed: PackedTokens, state, ys):
        return super().combine(self._merged_ctx(ctx), packed, state, ys)

    # ---------------------------------------------------------- accounting
    @staticmethod
    def _level_args(schedule, envelope):
        """Per-level (plan, envelope) pairs from a ``HierarchicalTable`` row
        (envelopes ride the levels) or explicit ``(intra, inter)`` tuples."""
        if isinstance(schedule, HierarchicalTable):
            return (schedule.intra, schedule.intra.envelope), (schedule.inter, schedule.inter.envelope)
        if schedule is None or envelope is None:
            raise ValueError("hierarchical accounting needs a HierarchicalTable or (intra, inter) pairs of plans "
                             "and envelopes")
        (si, se), (ei, ee) = schedule, envelope
        return (si, ei), (se, ee)

    def dispatch_tokens_split(self, *, n: int, schedule=None, envelope=None) -> dict:
        """Per-rank slots per level, ``{"intra", "inter"}``: each the
        composed child's own count."""
        (si, ei), (se, ee) = self._level_args(schedule, envelope)
        intra_f, inter_f = self._children()
        return {"intra": intra_f.dispatch_tokens(n=n, schedule=si, envelope=ei),
                "inter": inter_f.dispatch_tokens(n=n, schedule=se, envelope=ee)}

    def dispatch_tokens(self, *, n: int, cap_uniform: int = 0, schedule=None, envelope=None) -> float:
        parts = self.dispatch_tokens_split(n=n, schedule=schedule, envelope=envelope)
        return parts["intra"] + parts["inter"]

    def dispatch_bytes(
        self, *, d_model: int, wire_dtype: str = "bf16", compute_bytes: int = 2, n: int, cap_uniform: int = 0,
        schedule=None, envelope=None,
    ) -> float:
        """Intra slots at compute width (the codec never touches them),
        inter slots at ``wire_dtype``'s width plus its scale."""
        parts = self.dispatch_tokens_split(n=n, schedule=schedule, envelope=envelope)
        return (parts["intra"] * wire_bytes_per_token(d_model, "bf16", compute_bytes)
                + parts["inter"] * wire_bytes_per_token(d_model, wire_dtype, compute_bytes))

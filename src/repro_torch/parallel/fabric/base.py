"""The ``Fabric`` protocol and its name registry.

The MoE layer is one pipeline (route -> admit -> pack -> wire encode ->
``fabric.dispatch`` -> grouped expert GEMM -> ``fabric.combine`` -> wire
decode -> scatter back); everything fabric-specific (buffer geometry,
admission source, movement, the wire codec's domain, bytes-on-the-wire
accounting) lives behind a ``Fabric`` resolved from ``MoECfg.dispatch``
by name.  Admission and packing are shared (``geometry``), so two
fabrics given the same plan admit the same choices; they differ only in
movement and padding.  Every fabric emits the stats contract
``{"routing", "dropped"}`` (plus the port's ``admitted``).

Counterpart of ``repro/parallel/fabric/base.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch

from repro_torch.core.cost_models import wire_bytes_per_token
from repro_torch.core.schedule import A2ASchedule, ScheduleTable
from repro_torch.parallel.fabric import geometry as g
from repro_torch.parallel.fabric.codec import get_codec

__all__ = [
    "DEGRADATION_CHAIN",
    "FABRICS",
    "Fabric",
    "FabricContext",
    "PackedTokens",
    "as_fabric_schedule",
    "consumes_schedule",
    "consumes_table",
    "fabric_names",
    "get_fabric",
    "next_fabric",
    "register_fabric",
    "resolve_fabric",
]

# each backend's fallback when the health FSM quarantines it: richest
# movement first, ending at the fabric-free dense path that cannot fault
DEGRADATION_CHAIN = ("ragged_a2a", "phase_pipelined", "a2a", "dense")


def next_fabric(name: str) -> str | None:
    """The backend after ``name`` in the degradation chain; backends
    outside it (wrappers, future fabrics) degrade straight to ``dense``."""
    base = name.split(":", 1)[-1] if ":" in name else name
    if base in DEGRADATION_CHAIN:
        i = DEGRADATION_CHAIN.index(base)
        return DEGRADATION_CHAIN[i + 1] if i + 1 < len(DEGRADATION_CHAIN) else None
    return "dense" if base != "dense" else None


def _chain_hint(name: str) -> str:
    """Suffix of validate errors: where the degradation chain goes next."""
    nxt = next_fabric(name)
    if nxt is None:
        return " [end of degradation chain: no fallback fabric]"
    return f" [degradation chain: next fabric is {nxt!r}]"


@dataclasses.dataclass(frozen=True)
class FabricContext:
    """What a fabric's hooks receive.  ``n`` is the rank count the
    movement runs on (1 off a world: the virtual fabric's ranks live in
    the schedule row), ``e_local`` the experts a rank, ``me`` this rank's
    index in the model group and ``world`` the ``sharding.World`` (None
    on one device).  ``two_d``: 2D expert sharding, where a rank holds a
    slice of each expert's FFN width and each block's tokens are gathered
    over the data group around the expert GEMM (``models.moe``); only with
    ``MoECfg.expert_2d`` in a world of several data groups
    (``World.two_d``), as JAX needs a "data" axis in its mesh."""

    cfg: Any  # ModelConfig
    schedule: Any  # ScheduleTable row, A2ASchedule or None
    n: int = 1
    e_local: int = 0
    me: int = 0
    world: Any = None
    two_d: bool = False

    @property
    def moe(self):
        return self.cfg.moe

    @property
    def group(self):
        return self.world.model_group

    @property
    def ep(self) -> bool:
        """Runs across ranks (a world of more than one EP rank)."""
        return self.world is not None and self.n > 1


@dataclasses.dataclass
class PackedTokens:
    """A fabric's packed slot space: ``buf`` [.., d] with slot-aligned
    ``pos``/``gate``/``live``; ``admitted`` is the [T*k] admission mask;
    ``meta`` is the fabric's own geometry state, threaded to dispatch and
    combine.  ``wire`` is the slot-shaped bool mask of the slots that
    cross the fabric (live remote slots), the wire codec's domain; None:
    nothing crosses (the schedule-less path)."""

    buf: torch.Tensor
    pos: torch.Tensor
    gate: torch.Tensor
    live: torch.Tensor
    admitted: torch.Tensor
    meta: Any = None
    wire: torch.Tensor | None = None


class Fabric:
    """One dispatch backend, registered as a singleton.  Capabilities:

    * ``name``: the registry name ``MoECfg.dispatch`` selects;
    * ``uses_mesh``: runs across the world's ranks (False: the dense
      backend, which also serves every backend on one device, on shapes
      the EP split cannot cut, and as the virtual fabric of a row);
    * ``schedule_kind``: ``"none"``, ``"static"`` (an ``A2ASchedule``),
      ``"row"`` (a ``ScheduleTable`` row, swapped between calls without a
      rebuild) or ``"optional_row"``;
    * ``requires_envelope``: the row must carry a phase envelope.
    """

    name: ClassVar[str]
    uses_mesh: ClassVar[bool] = True
    schedule_kind: ClassVar[str] = "none"
    requires_envelope: ClassVar[bool] = False

    # ------------------------------------------------------------ schedule
    def validate_schedule(self, schedule, *, n: int):
        """Check ``schedule`` for this backend and return what the pipeline
        uses (None for schedule-ignoring backends).  A wrong flavour raises
        ``ValueError`` naming this backend and the degradation chain."""
        kind = self.schedule_kind
        hint = _chain_hint(self.name)
        if kind == "none":
            return None
        if kind == "static":
            if isinstance(schedule, ScheduleTable):
                raise ValueError(
                    f"{self.name}: rejected a traced ScheduleTable row — "
                    "this backend bakes a static A2ASchedule into the "
                    "executable; use the 'phase_pipelined' (or "
                    "'ragged_a2a') fabric for swap-without-recompile rows"
                    + hint
                )
            if not isinstance(schedule, A2ASchedule):
                raise ValueError(f"{self.name}: needs a static A2ASchedule (got {type(schedule).__name__})" + hint)
            return schedule
        if isinstance(schedule, A2ASchedule):
            raise ValueError(
                f"{self.name}: rejected a static A2ASchedule — this "
                "backend consumes traced ScheduleTable rows (build one "
                "with core.ScheduleTable.from_schedules); use the "
                "'ppermute' fabric for static plans" + hint
            )
        if not isinstance(schedule, ScheduleTable):
            if kind == "optional_row" and schedule is None:
                return None
            raise ValueError(f"{self.name}: needs a ScheduleTable row (got {type(schedule).__name__})" + hint)
        if not schedule.is_row:
            raise ValueError(
                f"{self.name}: rejected a full ScheduleTable — pass "
                "table.row(l) (the stack's scan slices rows "
                "automatically)" + hint
            )
        if self.uses_mesh and schedule.n != n:
            raise ValueError(f"{self.name}: schedule row plans {schedule.n} ranks, EP axis has {n}" + hint)
        if self.requires_envelope and schedule.envelope is None:
            raise ValueError(
                f"{self.name}: needs a ScheduleTable row with a phase "
                "envelope (ScheduleTable.from_schedules(..., "
                "envelope='auto') or a ScheduleRuntime with "
                "envelope_slack > 0) — the envelope is the backend's "
                "static buffer geometry" + hint
            )
        return schedule

    # ------------------------------------------------------------ pipeline
    def pack(self, ctx: FabricContext, x_loc, idx, gates) -> PackedTokens:
        """[T, d] tokens and [T, k] routing -> this backend's slot buffer."""
        raise NotImplementedError

    def dispatch(self, ctx: FabricContext, packed: PackedTokens):
        """Move slots.  Returns ``(blocks, state)``: ``blocks`` a list of
        ``(x_block [G, C, d], live [G, C] or None)`` for the expert GEMM
        (G local experts), ``state`` threaded to ``combine``."""
        raise NotImplementedError

    def combine(self, ctx: FabricContext, packed: PackedTokens, state, ys):
        """Return processed blocks to their senders, aligned with ``packed.buf``."""
        raise NotImplementedError

    def unpack(self, ctx: FabricContext, packed: PackedTokens, y_slots, t: int) -> torch.Tensor:
        """Wire-decode the processed slots and scatter them, gate-weighted,
        back to [t, d] f32."""
        return g.ungroup(self.wire_decode(ctx, packed, y_slots), packed.pos, packed.gate, t)

    # ----------------------------------------------------------- wire codec
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

    # ----------------------------------------------------------- accounting
    def dispatch_tokens(self, *, n: int, cap_uniform: int = 0, schedule=None, envelope=None) -> float:
        """Per-rank dispatch slots this backend puts on the wire (mean over
        ranks; padding included, local traffic excluded)."""
        raise NotImplementedError

    def dispatch_bytes(
        self, *, d_model: int, wire_dtype: str = "bf16", compute_bytes: int = 2, n: int, cap_uniform: int = 0,
        schedule=None, envelope=None,
    ) -> float:
        """Per-rank dispatch bytes under ``wire_dtype``'s codec: the slots
        priced at ``wire_bytes_per_token`` (payload at the codec's width
        plus the per-slot scale the quantized codecs ship)."""
        tokens = self.dispatch_tokens(n=n, cap_uniform=cap_uniform, schedule=schedule, envelope=envelope)
        return tokens * wire_bytes_per_token(d_model, wire_dtype, compute_bytes)


# ------------------------------------------------------------------ registry
FABRICS: dict[str, Fabric] = {}


def register_fabric(cls: type[Fabric]) -> type[Fabric]:
    """Class decorator: instantiate and register under ``cls.name``."""
    if not getattr(cls, "name", None):
        raise ValueError(f"{cls.__name__} has no fabric name")
    FABRICS[cls.name] = cls()
    return cls


def fabric_names() -> tuple[str, ...]:
    """Registered backend names, sorted."""
    return tuple(sorted(FABRICS))


def _unknown(name: str) -> ValueError:
    return ValueError(
        f"unknown dispatch mode {name!r}: registered fabrics are "
        f"{', '.join(fabric_names())} (plus the 'scheduled' alias, "
        "which resolves by schedule type)"
    )


def get_fabric(name: str) -> Fabric:
    """Look up a backend by exact registry name."""
    try:
        return FABRICS[name]
    except KeyError:
        raise _unknown(name) from None


_SCHEDULED_ALIAS = "scheduled"  # static plan -> ppermute, table row -> phase_pipelined


def resolve_fabric(name: str, schedule=None) -> Fabric:
    """A ``MoECfg.dispatch`` value (name or alias) -> its backend; the
    ``scheduled`` alias picks ``ppermute`` for an ``A2ASchedule`` and
    ``phase_pipelined`` for a ``ScheduleTable`` row."""
    if name == _SCHEDULED_ALIAS:
        if isinstance(schedule, A2ASchedule):
            return FABRICS["ppermute"]
        if isinstance(schedule, ScheduleTable):
            return FABRICS["phase_pipelined"]
        raise ValueError("scheduled dispatch needs an A2ASchedule or ScheduleTable row")
    return get_fabric(name)


def _schedule_kind(name: str) -> str:
    return get_fabric(name).schedule_kind


def consumes_schedule(name: str) -> bool:
    """Does this dispatch name *require* a planned schedule?  ``dense``'s
    optional row does not count.  Unknown names raise.  JAX
    ``fabric.consumes_schedule``."""
    return name == _SCHEDULED_ALIAS or _schedule_kind(name) in ("static", "row")


def consumes_table(name: str) -> bool:
    """Does this dispatch name consume ``ScheduleTable`` rows that a
    controller swaps between steps?  False for ``ppermute``, whose plan is
    fixed for the run.  JAX ``fabric.consumes_table``."""
    return name == _SCHEDULED_ALIAS or _schedule_kind(name) == "row"


def as_fabric_schedule(name: str, schedule, n_moe_layers: int):
    """Adapt a planner's static ``A2ASchedule`` to what the named fabric
    consumes: row-kind fabrics get a per-layer ``ScheduleTable`` (one row
    per MoE layer, auto envelope); static consumers and the ``scheduled``
    alias take it as it is."""
    if not isinstance(schedule, A2ASchedule) or name == _SCHEDULED_ALIAS:
        return schedule
    if _schedule_kind(name) != "row":
        return schedule
    return ScheduleTable.from_schedules([schedule] * n_moe_layers, envelope="auto")

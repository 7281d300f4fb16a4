"""MoE dispatch fabrics.  One device runs the virtual ``dense`` fabric for
every ``MoECfg.dispatch`` name; the multi-rank backends (``a2a``,
``ppermute``, ``phase_pipelined`` on a mesh, ``ragged_a2a``,
``hierarchical``) come with a later slice.  ``consumes_schedule`` and
``consumes_table`` answer as the JAX registry does for each name."""

from repro_torch.parallel.fabric.base import (
    SCHEDULE_KINDS,
    FabricContext,
    PackedTokens,
    consumes_schedule,
    consumes_table,
)
from repro_torch.parallel.fabric.codec import CODECS, WireCodec, codec_names, get_codec
from repro_torch.parallel.fabric.dense import DenseFabric

# dispatch names the JAX package registers; on one device all of them
# resolve to the virtual dense fabric (repro/models/moe.py, moe_apply)
FABRIC_NAMES = ("a2a", "dense", "faulty", "hierarchical", "phase_pipelined", "ppermute", "ragged_a2a")
# dispatch names whose fabric consumes ScheduleTable rows (JAX: consumes_table)
TABLE_FABRICS = (*(n for n, kind in SCHEDULE_KINDS.items() if kind == "row"), "scheduled")

__all__ = [
    "CODECS", "DenseFabric", "FABRIC_NAMES", "SCHEDULE_KINDS", "TABLE_FABRICS", "FabricContext",
    "PackedTokens", "WireCodec", "codec_names", "consumes_schedule", "consumes_table", "get_codec",
]

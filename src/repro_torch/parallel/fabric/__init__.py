"""``repro_torch.parallel.fabric``: pluggable MoE dispatch backends.

One MoE pipeline (``models/moe.py``) over a name registry of ``Fabric``
backends; ``MoECfg.dispatch`` selects by name.  Importing this package
registers them:

=================  =========================================================
``dense``          the one-device virtual fabric (a row's admission on
                   virtual ranks); across ranks, no-A2A EP with an
                   all-reduce combine
``a2a``            one monolithic all-to-all each way (the paper's baseline)
``ppermute``       a static ``A2ASchedule`` as circuit phases
``phase_pipelined``  ``ScheduleTable`` rows against a phase envelope
                   (swapped without a rebuild; dense per-phase emulation)
``ragged_a2a``     the same geometry, each phase's transfer exactly the
                   live envelope slots of its pair
``hierarchical``   a ``HierarchicalTable`` row: intra-pod phases on
                   ``phase_pipelined``, inter-pod phases on ``ragged_a2a``,
                   only the inter slots on the wire codec
=================  =========================================================

plus the ``scheduled`` alias (by schedule type) and ``faulty:<base>``
wrappers (``wrap_faulty``).  On one device every name runs the virtual
dense fabric, as the JAX package does; across ranks a world
(``parallel.sharding``) must be current.
Counterpart of ``repro/parallel/fabric/__init__.py``.
"""

from repro_torch.parallel.fabric.base import (
    DEGRADATION_CHAIN,
    FABRICS,
    Fabric,
    FabricContext,
    PackedTokens,
    as_fabric_schedule,
    consumes_schedule,
    consumes_table,
    fabric_names,
    get_fabric,
    next_fabric,
    register_fabric,
    resolve_fabric,
)
from repro_torch.parallel.fabric.codec import CODECS, WireCodec, codec_names, get_codec

# importing the backend modules registers them
from repro_torch.parallel.fabric import geometry  # noqa: F401
from repro_torch.parallel.fabric.dense import DenseFabric
from repro_torch.parallel.fabric.a2a import MonolithicA2AFabric
from repro_torch.parallel.fabric.ppermute import PPermuteFabric
from repro_torch.parallel.fabric.phase_pipelined import PhasePipelinedFabric
from repro_torch.parallel.fabric.ragged_a2a import RaggedA2AFabric
from repro_torch.parallel.fabric.hierarchical import HierarchicalFabric
from repro_torch.parallel.fabric.faulty import FaultInjectionFabric, wrap_faulty

__all__ = [
    "CODECS", "DEGRADATION_CHAIN", "FABRICS", "DenseFabric", "Fabric", "FabricContext", "FaultInjectionFabric",
    "HierarchicalFabric", "MonolithicA2AFabric", "PPermuteFabric", "PackedTokens", "PhasePipelinedFabric",
    "RaggedA2AFabric", "WireCodec", "as_fabric_schedule", "codec_names", "consumes_schedule", "consumes_table",
    "fabric_names", "geometry", "get_codec", "get_fabric", "next_fabric", "register_fabric", "resolve_fabric",
    "wrap_faulty",
]

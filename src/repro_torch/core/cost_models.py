"""Compute/communication cost models for the simulator (paper §4.1, Fig 1).

The paper profiles MoE expert execution on RTX PRO 6000 GPUs and observes
a *knee*: execution time is ~linear beyond ~256 tokens, but below that a
fixed ~250us overhead (kernel launch, synchronization, scheduling)
dominates.  We model this as

    T(b) = 0                                   if b == 0
    T(b) = max(floor_us, per_token_us * b)     otherwise

with ``floor_us = 250`` and ``per_token_us`` calibrated so that the knee
sits at ``knee_tokens`` (i.e. per_token_us = floor_us / knee_tokens).
A purely linear model (``floor_us = 0``) isolates decomposition effects
from hardware overheads, mirroring the paper's "linear compute cost
model".  The knee parameters are configurable and can be re-fit from a
measured profile via ``fit_knee`` (``repro_torch.launch.simulate``
fits it to K1's times on the card).

Communication time is ``bytes / bandwidth``; we work in token units and
express bandwidth as tokens/us: ``token_bytes = d_model * dtype_bytes``
(dispatch moves hidden-state vectors, not ids).

Counterpart of ``repro/core/cost_models.py``: the same numpy code, so
the same inputs give the same floats.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ComputeModel",
    "knee_model",
    "linear_model",
    "fit_knee",
    "MIN_SLOPE_US",
    "CommModel",
    "WIRE_DTYPES",
    "wire_bytes_per_token",
    "a2a_dispatch_tokens",
    "phase_dispatch_tokens",
    "pipeline_makespan",
]

# ------------------------------------------------------- wire dtype pricing
# What one dispatched token slot costs on the wire per codec
# (``MoECfg.wire_dtype``; executed by ``parallel.fabric.codec``):
# (payload bytes per element, per-slot scale sidecar bytes).  The scale
# sidecar is the f32 per-slot quantization scale the envelope ships next
# to the payload — accounted honestly, it is real wire traffic.
WIRE_DTYPES: dict[str, tuple[int | None, int]] = {
    "bf16": (None, 0),  # passthrough: payload rides at the compute width
    "fp8": (1, 4),      # e4m3 payload + f32 per-slot scale
    "int8": (1, 4),     # symmetric int8 payload + f32 per-slot scale
}


def wire_bytes_per_token(
    d_model: int, wire_dtype: str = "bf16", compute_bytes: int = 2
) -> float:
    """Bytes one token slot puts on the wire under ``wire_dtype``.

    The dtype-aware term every byte account multiplies slot counts by
    (a fabric's ``dispatch_bytes``, ``CommModel``): payload
    elements at the codec width — the compute width for the ``bf16``
    passthrough — plus the per-slot scale sidecar quantized codecs ship.
    Unknown names raise listing the registered codecs.
    """
    try:
        payload, sidecar = WIRE_DTYPES[wire_dtype]
    except KeyError:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}: registered wire codecs "
            f"are {', '.join(sorted(WIRE_DTYPES))}"
        ) from None
    return float(d_model * (compute_bytes if payload is None else payload) + sidecar)


@dataclasses.dataclass(frozen=True)
class ComputeModel:
    """Piecewise expert-compute model: max(floor, slope*b) for b > 0."""

    floor_us: float
    per_token_us: float
    name: str = "knee"

    def __call__(self, tokens) -> np.ndarray | float:
        t = np.asarray(tokens, dtype=np.float64)
        out = np.where(t > 0, np.maximum(self.floor_us, self.per_token_us * t), 0.0)
        return float(out) if out.ndim == 0 else out


def knee_model(
    *, floor_us: float = 250.0, knee_tokens: int = 256, name: str = "profiled-knee"
) -> ComputeModel:
    """The paper's profiling-based model: 250us floor, knee at ~256 tokens."""
    return ComputeModel(
        floor_us=floor_us, per_token_us=floor_us / knee_tokens, name=name
    )


def linear_model(*, per_token_us: float | None = None) -> ComputeModel:
    """Idealized linear scaling (no fixed overhead)."""
    if per_token_us is None:
        per_token_us = 250.0 / 256.0  # same slope as the default knee model
    return ComputeModel(floor_us=0.0, per_token_us=per_token_us, name="linear")


MIN_SLOPE_US = 1e-9  # fit_knee's slope when the tail's fitted slope is not positive


def fit_knee(batch_sizes: np.ndarray, times_us: np.ndarray) -> ComputeModel:
    """Fit (floor, slope) to a measured profile by least squares on the
    linear tail + median of the small-batch plateau."""
    b = np.asarray(batch_sizes, dtype=np.float64)
    t = np.asarray(times_us, dtype=np.float64)
    order = np.argsort(b)
    b, t = b[order], t[order]
    # Tail slope: robust fit over the upper half of batch sizes.
    half = len(b) // 2
    slope = float(np.polyfit(b[half:], t[half:], 1)[0])
    slope = max(slope, MIN_SLOPE_US)
    # Floor: median time over points whose linear prediction is below it.
    floor = float(np.median(t[: max(half, 1)]))
    for _ in range(8):  # fixed-point: which points sit on the plateau?
        plateau = t[slope * b < floor]
        if plateau.size == 0:
            break
        new_floor = float(np.median(plateau))
        if abs(new_floor - floor) < 1e-9:
            break
        floor = new_floor
    return ComputeModel(floor_us=floor, per_token_us=slope, name="fitted-knee")


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Link/NIC bandwidth in tokens per microsecond + reconfiguration delay.

    Default matches the paper's setup: tokens are d_model-sized bf16
    activations; bandwidth is per-NIC (circuit) bandwidth; reconfiguration
    delay defaults to 10ns (Sirius-class) = 0.01us.
    """

    tokens_per_us: float
    reconf_us: float = 0.01
    bytes_per_token: float = 8192.0  # d_model=4096 bf16 default
    # Dark window of a whole-schedule swap (µs): the fabric blackout
    # while the OCS tears down one circuit set and establishes the next
    # ("to reconfigure or not").  Distinct from the per-phase
    # ``reconf_us`` the simulator charges inside a running schedule.
    # 0.0 = legacy behavior: re-plans are free to adopt.
    replan_dark_us: float = 0.0

    @staticmethod
    def from_hardware(
        *,
        link_gbps: float = 400.0,
        d_model: int = 4096,
        dtype_bytes: int = 2,
        reconf_us: float = 0.01,
        wire_dtype: str = "bf16",
        replan_dark_us: float = 0.0,
    ) -> "CommModel":
        """``wire_dtype`` selects the dispatch codec's bytes-per-token
        term (see ``wire_bytes_per_token``), so the simulator and the
        selector score quantized plans with the bytes their wire really
        carries — ``dtype_bytes`` stays the *compute* width the ``bf16``
        passthrough ships."""
        bytes_per_token = wire_bytes_per_token(d_model, wire_dtype, dtype_bytes)
        bytes_per_us = link_gbps * 1e9 / 8 / 1e6
        return CommModel(
            tokens_per_us=bytes_per_us / bytes_per_token,
            reconf_us=reconf_us,
            bytes_per_token=bytes_per_token,
            replan_dark_us=replan_dark_us,
        )

    def comm_us(self, tokens) -> np.ndarray | float:
        """Transfer time for ``tokens`` (scalar or array, vectorized)."""
        t = np.asarray(tokens, dtype=np.float64)
        out = t / self.tokens_per_us
        return float(out) if out.ndim == 0 else out

    def replan_penalty(self, step_tokens: float) -> float:
        """Drop-fraction-equivalent cost of one schedule swap.

        Tokens the dark window blacks out (``replan_dark_us *
        tokens_per_us``) expressed as a fraction of one observation
        window's tokens — the unit the selector and device controller
        score drops in, so hysteresis can weigh "drop saved by the new
        plan" directly against "tokens lost going dark to adopt it".
        """
        if step_tokens <= 0:
            return 0.0
        return float(self.replan_dark_us * self.tokens_per_us / step_tokens)


# --------------------------------------------------- dispatch byte accounting
def a2a_dispatch_tokens(n: int, cap_slots: int) -> int:
    """Per-rank token *slots* a monolithic padded all-to-all ships.

    Every remote pair gets a full ``cap_slots`` bucket regardless of
    planned traffic — ``(n - 1) * cap_slots`` slots cross the fabric per
    rank.  This is the traced path's legacy cost (and its dark-fiber
    waste: padding bytes ride circuits the plan left idle).  Multiply by
    ``wire_bytes_per_token`` for bytes — what one slot costs depends on
    the wire codec, not just the compute dtype.
    """
    return (n - 1) * int(cap_slots)


def phase_dispatch_tokens(valid: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Per-rank token slots phase-major dispatch ships.  [n] int64.

    ``valid``: [K, n] phase participation; ``caps``: [K] per-pair slot
    sizes (planned caps for the static ppermute path, envelope slot sizes
    for the pipelined traced path).  A rank pays only the phases it
    participates in — dark pairs ship nothing, which is exactly the
    circuit-bytes saving the decomposition exists for.  (The CPU/ICI
    *emulation* of a traced phase rides a dense all_to_all with one live
    slot; on a circuit fabric or with a ragged all-to-all only these
    bytes cross, so this is the number the bench tracks.)
    """
    v = np.asarray(valid, dtype=bool)
    c = np.asarray(caps, dtype=np.int64)
    return (v * c[:, None]).sum(axis=0)


def pipeline_makespan(
    dispatch_us: np.ndarray,
    compute_us: np.ndarray,
    combine_us: np.ndarray | None = None,
) -> tuple[float, float]:
    """(pipelined, serialized) makespan of a dispatch-compute-combine
    phase chain, in us.

    Pipelined: the paper's overlap model — phase k's compute starts when
    both its dispatch and phase k-1's compute are done (one dispatch
    channel, one compute engine, one combine channel; the classic 3-stage
    flow shop):

        d_k = d_{k-1} + dispatch_k
        c_k = max(c_{k-1}, d_k) + compute_k
        b_k = max(b_{k-1}, c_k) + combine_k

    Serialized: the same phases with zero overlap (all dispatch, then all
    compute, then all combine) — the monolithic/fused extreme is the
    special case of a single phase holding the totals.  The gap between
    the two is what phase-pipelining buys; the knee compute model (250us
    floor per launch) is what it *costs* at small phase batches — the
    paper's "don't forget the compute" tension, now queryable.
    """
    d = np.asarray(dispatch_us, dtype=np.float64)
    c = np.asarray(compute_us, dtype=np.float64)
    b = (
        np.zeros_like(d)
        if combine_us is None
        else np.asarray(combine_us, dtype=np.float64)
    )
    d_done = np.cumsum(d)
    c_done = 0.0
    b_done = 0.0
    for k in range(len(d)):
        c_done = max(c_done, d_done[k]) + c[k]
        b_done = max(b_done, c_done) + b[k]
    serialized = float(d.sum() + c.sum() + b.sum())
    return float(b_done), serialized

"""Wire codecs: low-precision payloads for the dispatch fabric.

``MoECfg.wire_dtype`` names the codec tokens ride the fabric in.  The
``bf16`` default is a passthrough (payload at the compute width,
bit-exact); ``fp8`` ships e4m3 payloads and ``int8`` symmetric int8
payloads, both with one f32 scale per slot, so a hot token cannot wash
out a cold one's resolution.

Execution is quantize-dequantize (QDQ) at the fabric seams: the
fabric's ``wire_encode`` QDQs the wire-crossing slots of the packed send
buffer before ``dispatch``, and ``wire_decode`` QDQs the processed slots
the combine leg returns.  Dequantization is per-slot elementwise and
every movement permutes or zero-fills whole slots, so this equals moving
(payload, scale) pairs and dequantizing on arrival; the bytes a slot
costs on the wire come from ``core.cost_models.wire_bytes_per_token``.

Gradients pass straight through (STE): ``x + (qdq(x) - x).detach()``.
Slots outside the ``wire`` mask (local and padding slots) are untouched.

The arithmetic is the one XLA runs for ``repro/parallel/fabric/codec.py``
on the CPU under ``jax.jit`` (as the reference's model steps run), so
both give the same bits (called op by op, outside ``jit``, JAX divides
instead and can land one codec step away): the division of the
slot's amax by 127 or 448 is a product with the f32 reciprocal (XLA folds
the constant) rounded once with the 1e-12 (a fused multiply-add, which
``_scale`` reproduces in f64).
Every other step is a correctly rounded elementwise operation or a max,
so a CUDA tensor gives the bits a CPU tensor does.  The ops are plain
torch with no host read, so a CUDA graph can capture them.  Counterpart
of ``repro/parallel/fabric/codec.py``: the reference runs its codec as
XLA ops, not in Pallas, so this is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.cost_models import WIRE_DTYPES

__all__ = ["WireCodec", "CODECS", "get_codec", "codec_names"]

_EPS = float(np.float32(1e-12))  # zero-slot guard: amax 0 -> scale eps -> QDQ(0) == 0 exactly
_INT8_MAX = 127.0
_E4M3_MAX = 448.0  # float8_e4m3fn finite max
_INV_INT8 = float(np.float32(1.0) / np.float32(_INT8_MAX))  # f32(1/127)
_INV_E4M3 = float(np.float32(1.0) / np.float32(_E4M3_MAX))  # f32(1/448)


def _scale(x: torch.Tensor, inv_max: float) -> torch.Tensor:
    """Per-slot f32 scale ``amax * f32(1/max) + eps``, rounded once, as a
    fused multiply-add rounds it.  The product is exact in f64; the sum is
    rounded to odd there (the f64 rounding, moved one ulp toward what it
    dropped where it landed on an even significand), so its one rounding
    to f32 is the correct one even where the f64 sum sits on an f32 tie."""
    p = x.abs().amax(dim=-1, keepdim=True).double() * inv_max
    s = p + _EPS
    part = s - p
    dropped = (p - (s - part)) + (_EPS - part)  # exact: p + eps - s
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(dropped > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((dropped != 0) & even, torch.nextafter(s, toward), s).float()


def _int8_encode(x: torch.Tensor):
    """[..., d] f32 -> (int8 payload, f32 scale [..., 1]), symmetric,
    round half to even."""
    scale = _scale(x, _INV_INT8)
    q = torch.clamp(torch.round(x / scale), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), scale


def _fp8_encode(x: torch.Tensor):
    """[..., d] f32 -> (e4m3 payload, f32 scale [..., 1]).  The slot's
    amax maps to the e4m3 finite max; the clip guards the cast (e4m3fn
    has no inf: an overflow would be NaN)."""
    scale = _scale(x, _INV_E4M3)
    q = torch.clamp(x / scale, -_E4M3_MAX, _E4M3_MAX)
    return q.to(torch.float8_e4m3fn), scale


def _scaled_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(payload, scale) -> f32 values (both quantized codecs)."""
    return q.to(torch.float32) * scale


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One wire payload format.  ``encode`` maps f32 slots to (payload,
    per-slot scale); ``decode`` inverts it at f32.  ``encode=None`` marks
    the identity passthrough (payload at the compute width).
    ``max_step_over_amax`` is the largest step between two neighbouring
    decoded values of a slot over the slot's amax: a value that moves
    across a rounding boundary moves by at most that times the amax."""

    name: str
    encode: Callable | None = None
    decode: Callable | None = None
    max_step_over_amax: float = 0.0

    @property
    def is_identity(self) -> bool:
        return self.encode is None

    def qdq(self, x: torch.Tensor) -> torch.Tensor:
        """decode∘encode at f32: the codec's value map on the wire."""
        return self.decode(*self.encode(x))

    def apply(self, buf: torch.Tensor, wire: torch.Tensor | None) -> torch.Tensor:
        """QDQ the wire-crossing slots of ``buf`` ([..., d]; ``wire`` is
        the slot-shaped bool mask, None = nothing crosses).  Values
        round-trip the wire format at f32, gradients pass through (STE),
        and the result is cast back to ``buf.dtype``.  The identity codec
        and a maskless buffer return ``buf`` itself."""
        if self.encode is None or wire is None:
            return buf
        x = buf.float()
        y = x + (self.qdq(x) - x).detach()
        return torch.where(wire[..., None], y, x).to(buf.dtype)


CODECS: dict[str, WireCodec] = {
    "bf16": WireCodec("bf16"),
    # e4m3's top binade [256, 448] steps by 32, and the amax maps to 448
    "fp8": WireCodec("fp8", _fp8_encode, _scaled_decode, 32.0 / _E4M3_MAX),
    "int8": WireCodec("int8", _int8_encode, _scaled_decode, 1.0 / _INT8_MAX),
}
# one registry, one price list: a codec without a bytes-per-token entry
# (or the other way round) would misprice the wire
if set(CODECS) != set(WIRE_DTYPES):
    raise RuntimeError("codec registry out of sync with the cost model's WIRE_DTYPES")


def codec_names() -> tuple[str, ...]:
    """Registered codec names, sorted."""
    return tuple(sorted(CODECS))


def get_codec(name: str) -> WireCodec:
    """Look up a codec by ``MoECfg.wire_dtype``; an unknown name raises
    listing the registered codecs."""
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire_dtype {name!r}: registered wire codecs are {', '.join(codec_names())}"
        ) from None

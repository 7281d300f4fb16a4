"""Error-feedback int8 gradient compression.

Per-tensor symmetric int8 quantization with an error-feedback
accumulator: the quantization residual is carried into the next step, so
the scheme is unbiased over time.  The gradients are compressed and
decompressed before the optimizer update: what the wire would deliver.

    ef = ef_int8_init(params)
    ef_int8_compress(grads, ef)   # grads and ef rewritten in place

Per tensor (per JAX leaf: a block leaf there is stacked over layers, so
``groups`` gives the port's per-layer tensors one scale), with ``x = g +
e`` in f32: ``scale = max|x| / 127 + 1e-12``,
``q = clip(round(x / scale), -127, 127)`` (round half to even, an int8
value), ``g <- q * scale`` and ``e <- x - q * scale``.  The arithmetic is
the one XLA runs for ``repro/optim/compression.py`` on the CPU, so both
packages give the same bits: the division by 127 is a product with
f32(1/127) (XLA folds the constant) and the scale is rounded once with
the 1e-12, and the residual is rounded once too (XLA fuses both into
multiply-adds; here they are computed in f64, where the products and
the sums before the last rounding are exact).
Every step is a correctly rounded elementwise operation or a max, so a
CUDA tensor gives the bits a CPU tensor does.  The ef state costs 4 bytes a
parameter; the work runs in place, with one temporary the size of the
tensor and f64 chunks of ``_CHUNK`` elements.  Counterpart of
``repro/optim/compression.py``; the JAX version is plain jnp, not a
Pallas kernel, so this is plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ef_int8_init", "ef_int8_compress"]

_INV127 = float(np.float32(1.0) / np.float32(127.0))  # f32(1/127)
_EPS = float(np.float32(1e-12))
_CHUNK = 1 << 26  # elements per f64 residual chunk (512 MB a temporary)


def ef_int8_init(params: dict) -> dict:
    """Zero f32 error-feedback accumulators, one per parameter."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}


@torch.no_grad()
def _compress_group(gs: list[torch.Tensor], es: list[torch.Tensor]) -> None:
    """One scale over the group's tensors (a JAX leaf stacked over layers)."""
    for g, e in zip(gs, es):
        e.add_(g)  # x = g + e (the sum is commutative: JAX's g + e bit for bit)
    amax = torch.stack([torch.linalg.vector_norm(e, float("inf")) for e in es]).amax()
    # max * f32(1/127) + 1e-12 rounded once, as XLA's fused multiply-add
    scale = (amax.double() * _INV127 + _EPS).float()
    for g, e in zip(gs, es):
        q = torch.div(e, scale).round_().clamp_(-127, 127)  # the int8 values, held in f32
        if g.dtype == torch.float32:
            torch.mul(q, scale, out=g)
        else:
            g.copy_(q * scale)
        xf, qf, scale64 = e.view(-1), q.view(-1), scale.double()
        for i in range(0, xf.numel(), _CHUNK):
            xc = xf[i:i + _CHUNK]
            xc.copy_(xc.double().sub_(qf[i:i + _CHUNK].double().mul_(scale64)))


def ef_int8_compress(grads: dict, ef_state: dict, groups: list[list[str]] | None = None) -> tuple[dict, dict]:
    """Compress ``grads`` with error feedback, in place: each gradient
    becomes what the wire delivers and ``ef_state`` the new residuals.
    ``groups`` lists the names that share one scale (default: each alone);
    a model passes ``Model.reference_groups()``, the JAX leaves, whose
    block leaves are stacked over layers.  Returns ``(grads, ef_state)``."""
    for names in groups or [[n] for n in grads]:
        _compress_group([grads[n] for n in names], [ef_state[n] for n in names])
    return grads, ef_state

"""Core layers: device choice, parameter init, rmsnorm, dense, embed, rope.

The cast convention: the JAX package keeps f32 parameters and casts each
weight to ``COMPUTE_DTYPE`` right before use.  The port stores every such
weight in the compute dtype once (same numbers, half the bytes in bf16)
and keeps f32 what JAX uses in f32: norm scales and the router.
Activations run in the compute dtype, norms and softmaxes in f32.
Counterpart of ``repro/models/layers.py``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = [
    "resolve_device",
    "normal_param",
    "ones_param",
    "rmsnorm",
    "dense",
    "embed",
    "rope",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent;
    nothing falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on the card; pass "
            "device='cpu' to run the plain PyTorch versions instead"
        )
    return dev


def normal_param(shape, scale: float, *, gen, device, dtype) -> nn.Parameter:
    """``N(0, 1) * scale`` drawn in f32 from ``gen`` on ``device``, stored
    in ``dtype`` (``gen`` None: uninitialized storage, to be loaded)."""
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale
    return nn.Parameter(w.to(dtype), requires_grad=False)


def ones_param(d: int, *, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=torch.float32, device=device), requires_grad=False)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """f32 RMS norm, result in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` [d_in, d_out] stored in the compute dtype."""
    return x @ w


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, D]; positions: [..., S]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., :, None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

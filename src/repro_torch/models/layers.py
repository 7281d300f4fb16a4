"""Core layers: device choice, parameter init, rmsnorm, groupnorm, dense,
embed, rope, sinusoidal positions and the dense FFNs (SwiGLU, GELU MLP).

The cast convention: the JAX package keeps f32 parameters and casts each
weight to ``COMPUTE_DTYPE`` right before use.  The port stores those
weights in a storage dtype of its own (``Model(param_dtype=...)``): the
compute dtype for serving (the cast at use is then a no-op and the bytes
are halved in bf16), f32 masters for training (the cast at use carries
the gradient back to f32, as JAX's ``cast`` does).  Norm scales and the
router are f32 in both, as JAX uses them.  Activations run in the
compute dtype, norms and softmaxes in f32.  Counterpart of
``repro/models/layers.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "resolve_device",
    "normal_param",
    "ones_param",
    "full_param",
    "rmsnorm",
    "groupnorm",
    "dense",
    "embed",
    "rope",
    "sinusoidal_pos",
    "SwiGLU",
    "GeluMLP",
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
        w = torch.empty(shape, dtype=dtype, device=device)
    else:
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(scale).to(dtype)
    return nn.Parameter(w, requires_grad=False)


def ones_param(d: int, *, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=torch.float32, device=device), requires_grad=False)


def full_param(shape, value: float, *, device) -> nn.Parameter:
    """An f32 parameter filled with ``value``."""
    return nn.Parameter(torch.full(shape, value, dtype=torch.float32, device=device), requires_grad=False)


class _RMSNorm(torch.autograd.Function):
    """f32 RMS norm whose backward computes in f32 and hands ``dx`` back in
    ``x.dtype`` and ``dscale`` in the scale's dtype (JAX ``_rmsnorm_bwd``)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        r = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, r, scale)
        return (xf * r * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, r, scale = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        gs = gf * scale
        dot = torch.sum(gs * xf, dim=-1, keepdim=True)
        dx = r * gs - (r**3) * xf * dot / x.shape[-1]
        dscale = torch.sum(gf * xf * r, dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """f32 RMS norm, result in x.dtype."""
    return _RMSNorm.apply(x, scale, eps)


def groupnorm(x: torch.Tensor, scale, bias, *, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel dim in f32 with the population variance
    (as ``jnp.var``), result in x.dtype (RWKV6's per-head norm)."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, groups, d // groups)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y.reshape(*lead, d) * scale + bias).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w`` (+ ``b``) with ``w`` [d_in, d_out] and ``b`` [d_out] cast to
    x's (compute) dtype at use; the bias is added in that dtype, as JAX's
    ``dense_apply`` does."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def embed(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of ``table`` cast to ``dtype``; the whole table is cast before
    the gather, as JAX does, so duplicate ids sum their cotangents in
    ``dtype`` in the backward."""
    return table.to(dtype)[ids]


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, D]; positions: [..., S]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., :, None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_pos(seq: int, d: int, *, offset=0, dtype: torch.dtype, device) -> torch.Tensor:
    """The classic sinusoidal position table [seq, d] (sin at even
    columns, cos at odd), computed in f32 and cast to ``dtype``.
    ``offset`` is an int or a [B] int tensor (each row at its own
    position; the table is then [B, seq, d])."""
    pos = torch.arange(seq, device=device)[:, None]
    if isinstance(offset, torch.Tensor):
        pos = pos[None] + offset.to(device=device, dtype=torch.int64)[:, None, None]  # [B, seq, 1]
    else:
        pos = pos + offset
    dim = torch.arange(0, d, 2, device=device, dtype=torch.float32)
    angle = pos.float() / torch.pow(torch.tensor(10_000.0, device=device), dim / d)
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).flatten(-2).to(dtype)


class SwiGLU(nn.Module):
    """The dense SwiGLU FFN: w_gate, w_up [d, F] and w_down [F, d] in the
    storage dtype (JAX ``swiglu_init``)."""

    def __init__(self, d: int, d_ff: int, *, gen, device, dtype):
        super().__init__()
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.w_gate = normal_param((d, d_ff), d**-0.5, **kw)
        self.w_up = normal_param((d, d_ff), d**-0.5, **kw)
        self.w_down = normal_param((d_ff, d), d_ff**-0.5, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """silu(x W_gate) in f32, rounded to x's dtype, times x W_up, then W_down."""
        h = F.silu(dense(x, self.w_gate).float()).to(x.dtype) * dense(x, self.w_up)
        return dense(h, self.w_down)


class GeluMLP(nn.Module):
    """The 2-matrix GELU MLP (GPT-BigCode, granite-34b): w_up [d, F] and
    w_down [F, d] in the storage dtype (JAX ``gelu_mlp_init``)."""

    def __init__(self, d: int, d_ff: int, *, gen, device, dtype):
        super().__init__()
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.w_up = normal_param((d, d_ff), d**-0.5, **kw)
        self.w_down = normal_param((d_ff, d), d_ff**-0.5, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """GELU in f32 with the tanh approximation (``jax.nn.gelu``'s
        default; PyTorch's default is the exact erf form), rounded to x's dtype."""
        h = F.gelu(dense(x, self.w_up).float(), approximate="tanh").to(x.dtype)
        return dense(h, self.w_down)

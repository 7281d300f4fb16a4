"""Mamba (S6) mixer for the Jamba hybrid: in_proj -> causal depthwise conv
-> SiLU -> selective scan (data-dependent dt, B, C; zero-order hold) ->
gate -> out_proj.  The scan runs in kernel K6
(``kernels.mamba_scan.selective_scan``) exactly where the JAX model runs
its ``lax.scan`` (``_scan_ssm``), in prefill and decode alike; in training
``mamba_seq`` is differentiable in every parameter (the scan's backward is
K6b), and ``h_out`` stays a serving argument.

Dtypes follow the JAX mixer: ``a_log``, ``dt_bias`` and ``d_skip`` are
f32 parameters used in f32; the projections and ``conv_w`` / ``conv_b``
take the storage dtype and are cast to the compute dtype at use.  The
``x_proj`` output is rounded to the compute dtype before B and C are
widened to f32; ``dt`` is ``softplus(dt_proj(.) in f32 + dt_bias)``; the
scan's y (f32, with the skip term) is rounded to the compute dtype and
multiplied by ``silu(z)`` rounded to it.

Decode state per layer: ``{"h": [B, di, ds] f32, "tail": [B, cw - 1, di]}``
(the last ``cw - 1`` conv inputs, in the cache's dtype).  Counterpart of
``repro/models/mamba.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import ops as k6
from repro_torch.models.layers import dense, normal_param

__all__ = ["Mamba", "mamba_dims", "mamba_seq", "mamba_step", "mamba_init_state"]


def mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, d_state, conv_width, dt_rank = ceil(d / 16))."""
    h = cfg.hybrid
    return h.expand * cfg.d_model, h.d_state, h.conv_width, -(-cfg.d_model // 16)


class Mamba(nn.Module):
    """One layer's parameters (JAX ``mamba_init``): ``in_proj`` [d, 2 di],
    ``conv_w`` [cw, di], ``conv_b`` [di], ``x_proj`` [di, dtr + 2 ds],
    ``dt_proj`` [dtr, di], ``out_proj`` [di, d] in the storage dtype;
    ``dt_bias`` [di], ``a_log`` [di, ds] and ``d_skip`` [di] in f32."""

    def __init__(self, cfg: ModelConfig, *, gen, device, dtype):
        super().__init__()
        d = cfg.d_model
        di, ds, cw, dtr = mamba_dims(cfg)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.in_proj = normal_param((d, 2 * di), d**-0.5, **kw)
        self.conv_w = normal_param((cw, di), cw**-0.5, **kw)
        self.conv_b = nn.Parameter(torch.zeros(di, dtype=dtype, device=device), requires_grad=False)
        self.x_proj = normal_param((di, dtr + 2 * ds), di**-0.5, **kw)
        self.dt_proj = normal_param((dtr, di), dtr**-0.5, **kw)
        f32 = dict(dtype=torch.float32, device=device)
        self.dt_bias = nn.Parameter(torch.full((di,), math.log(math.expm1(0.01)), **f32), requires_grad=False)
        a = torch.arange(1, ds + 1, **f32)[None, :].expand(di, ds)
        self.a_log = nn.Parameter(torch.log(a).contiguous(), requires_grad=False)
        self.d_skip = nn.Parameter(torch.ones(di, **f32), requires_grad=False)
        self.out_proj = normal_param((di, d), di**-0.5, **kw)


def _ssm_params(p: Mamba, cfg: ModelConfig, xc: torch.Tensor):
    """xc [..., di] -> (dt [..., di] f32, B [..., ds] f32, C [..., ds] f32)."""
    _, ds, _, dtr = mamba_dims(cfg)
    proj = dense(xc, p.x_proj)  # the compute dtype, before B and C widen
    dt_r, b, c = torch.split(proj, [dtr, ds, ds], dim=-1)
    pre = dense(dt_r, p.dt_proj).float() + p.dt_bias
    dt = torch.logaddexp(pre, torch.zeros((), device=pre.device))  # softplus, as jax.nn.softplus
    return dt, b.float(), c.float()


def _gate_out(p: Mamba, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """out_proj(y in the compute dtype * silu(z) rounded to it)."""
    return dense(y.to(dtype) * F.silu(z.float()).to(dtype), p.out_proj)


def mamba_seq(p: Mamba, cfg: ModelConfig, x: torch.Tensor, h0=None, h_out=None):
    """Full-sequence forward over x [B, S, d] from h0 (None: zeros).
    Returns (y [B, S, d], (h [B, di, ds] f32, conv tail [B, cw - 1, di])):
    ``h_out`` (optional, [B, di, ds] f32) receives the final state in place."""
    _, s, _ = x.shape
    di, _, cw, _ = mamba_dims(cfg)
    x1, z = torch.split(dense(x, p.in_proj), [di, di], dim=-1)
    pad = F.pad(x1, (0, 0, cw - 1, 0))  # causal: cw - 1 zero steps before t = 0
    w = p.conv_w.to(x.dtype)
    conv = pad[:, 0:s] * w[0]
    for i in range(1, cw):
        conv = conv + pad[:, i:i + s] * w[i]
    conv = conv + p.conv_b.to(x.dtype)
    xc = F.silu(conv.float()).to(x.dtype)
    dt, bmat, cmat = _ssm_params(p, cfg, xc)
    y, h = k6.selective_scan(xc, dt, bmat, cmat, -torch.exp(p.a_log), p.d_skip, h0, h_out)
    return _gate_out(p, y, z, x.dtype), (h, pad[:, s:])


def mamba_init_state(cfg: ModelConfig, batch: int, *, dtype=torch.bfloat16, device) -> dict:
    di, ds, cw, _ = mamba_dims(cfg)
    return {
        "h": torch.zeros((batch, di, ds), dtype=torch.float32, device=device),
        "tail": torch.zeros((batch, cw - 1, di), dtype=dtype, device=device),
    }


def mamba_step(p: Mamba, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """One-token decode, x [B, 1, d], updating ``state`` ({"h", "tail"}) in
    place: the scan (K6 at S = 1) writes the new h into ``state["h"]``.
    Returns (y [B, 1, d], state)."""
    di = mamba_dims(cfg)[0]
    x1, z = torch.split(dense(x, p.in_proj), [di, di], dim=-1)  # [B, 1, di]
    window = torch.cat([state["tail"].to(x1.dtype), x1], dim=1)  # [B, cw, di]
    xc = (window * p.conv_w.to(x.dtype)[None]).sum(dim=1, keepdim=True) + p.conv_b.to(x.dtype)
    xc = F.silu(xc.float()).to(x.dtype)
    dt, bmat, cmat = _ssm_params(p, cfg, xc)
    y, _ = k6.selective_scan(xc, dt, bmat, cmat, -torch.exp(p.a_log), p.d_skip, state["h"], state["h"])
    state["tail"].copy_(window[:, 1:])
    return _gate_out(p, y, z, x.dtype), state

"""RWKV6 ("Finch") block: data-dependent token shift and decay, and the WKV
recurrence, which runs in kernel K5 (``kernels.rwkv_wkv.wkv6``) exactly
where the JAX model runs its scan ``_wkv_scan``; in training its backward
is kernel K5b, where XLA differentiates the scan.

Dtypes follow the JAX block: the token-shift mixes, the LoRA weights, the
decay base ``w0``, the bonus ``u``, the group norm and the channel-mix
mixes are f32 parameters used in f32; only the eight ``dense`` weights
(``wr wk wv wg wo cm_k cm_v cm_r``) take the storage dtype.  r/k/v/g come
out of ``dense`` in the compute dtype, the decay ``w`` is f32, and the
recurrence returns ``y`` in f32, which stays f32 through the group norm
and the SiLU gate and is cast to the compute dtype before ``wo``.

Decode state per layer: (last token of the time mix [B, d], WKV state
[B, H, D, D] f32, last token of the channel mix [B, d]).  Counterpart of
``repro/models/rwkv.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv_wkv import ops as wkv_ops
from repro_torch.models.layers import dense, full_param, groupnorm, normal_param, ones_param

__all__ = ["RWKV", "rwkv_time_mix", "rwkv_channel_mix", "rwkv_init_state", "LORA_MIX", "LORA_DECAY", "STREAMS"]

LORA_MIX = 32
LORA_DECAY = 64
STREAMS = ("w", "k", "v", "r", "g")
DENSE = ("wr", "wk", "wv", "wg", "wo", "cm_k", "cm_v", "cm_r")  # the weights in the storage dtype


class RWKV(nn.Module):
    """One layer's time-mix and channel-mix parameters (JAX ``rwkv_init``)."""

    def __init__(self, cfg: ModelConfig, *, gen, device, dtype):
        super().__init__()
        d, hd, f = cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff
        f32 = dict(gen=gen, device=device, dtype=torch.float32)
        kw = dict(gen=gen, device=device, dtype=dtype)
        n = len(STREAMS)
        self.mu = full_param((n, d), 0.5, device=device)
        self.mix_w1 = normal_param((d, n * LORA_MIX), 0.01, **f32)
        self.mix_w2 = normal_param((n, LORA_MIX, d), 0.01, **f32)
        self.w0 = full_param((d,), -2.0, device=device)
        self.decay_w1 = normal_param((d, LORA_DECAY), 0.01, **f32)
        self.decay_w2 = normal_param((LORA_DECAY, d), 0.01, **f32)
        self.u = normal_param((d // hd, hd), 0.1, **f32)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, normal_param((d, d), d**-0.5, **kw))
        self.ln_x_scale = ones_param(d, device=device)
        self.ln_x_bias = full_param((d,), 0.0, device=device)
        self.cm_mu_k = full_param((d,), 0.5, device=device)
        self.cm_mu_r = full_param((d,), 0.5, device=device)
        self.cm_k = normal_param((d, f), d**-0.5, **kw)
        self.cm_v = normal_param((f, d), f**-0.5, **kw)
        self.cm_r = normal_param((d, d), d**-0.5, **kw)


def _ddlerp(p: RWKV, x, x_prev) -> dict:
    """Data-dependent token shift for the five streams: x, x_prev [B, S, d]
    -> stream -> mixed [B, S, d] in x.dtype."""
    sx = (x_prev - x).float()
    xf = x.float()
    base = xf + sx * p.mu[STREAMS.index("w")]  # the shared probe stream
    lora = torch.tanh(base @ p.mix_w1)
    lora = lora.reshape(*lora.shape[:-1], len(STREAMS), LORA_MIX)
    deltas = torch.einsum("...sl,sld->...sd", lora, p.mix_w2)
    return {name: (xf + sx * (p.mu[i] + deltas[..., i, :])).to(x.dtype) for i, name in enumerate(STREAMS)}


def _decay(p: RWKV, xw) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1), f32.  xw: [B, S, d]."""
    lora = torch.tanh(xw.float() @ p.decay_w1) @ p.decay_w2
    return torch.exp(-torch.exp(p.w0 + lora))


def _heads(x, hd: int):
    *lead, d = x.shape
    return x.reshape(*lead, d // hd, hd)


def _wkv(r, k, v, w, u, s0):
    """The recurrence on [B, S, H, D] streams through K5 (differentiable:
    K5b in the backward), which takes their [B, H, S, D] views by stride.
    Returns (y [B, S, H, D] f32, S_final)."""
    y, s = wkv_ops.wkv6(*(t.transpose(1, 2) for t in (r, k, v, w)), u, s0)
    return y.transpose(1, 2), s


def rwkv_time_mix(p: RWKV, cfg: ModelConfig, x, state=None):
    """x: [B, S, d]; state = (x_last [B, d], S [B, H, D, D] f32) or None
    (a zero token and, in K5, S = 0).  Returns (y, (x[:, -1], S_final))."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    if state is None:
        x_last, s0 = torch.zeros((b, d), dtype=x.dtype, device=x.device), None
    else:
        x_last, s0 = state
    x_prev = torch.cat([x_last[:, None, :], x[:, :-1]], dim=1)
    mixed = _ddlerp(p, x, x_prev)
    r = _heads(dense(mixed["r"], p.wr), hd)
    k = _heads(dense(mixed["k"], p.wk), hd)
    v = _heads(dense(mixed["v"], p.wv), hd)
    g = dense(mixed["g"], p.wg)
    w = _heads(_decay(p, mixed["w"]), hd)  # f32
    y, s_new = _wkv(r, k, v, w, p.u, s0)
    y = groupnorm(y.reshape(b, s, d), p.ln_x_scale, p.ln_x_bias, groups=d // hd)
    y = y * F.silu(g.float()).to(y.dtype)
    return dense(y.to(x.dtype), p.wo), (x[:, -1, :], s_new)


def rwkv_channel_mix(p: RWKV, x, state=None):
    """x: [B, S, d]; state = x_last [B, d] or None.  Returns (y, x[:, -1])."""
    b, s, d = x.shape
    x_last = torch.zeros((b, d), dtype=x.dtype, device=x.device) if state is None else state
    x_prev = torch.cat([x_last[:, None, :], x[:, :-1]], dim=1)
    sx = (x_prev - x).float()
    xf = x.float()
    xk = (xf + sx * p.cm_mu_k).to(x.dtype)
    xr = (xf + sx * p.cm_mu_r).to(x.dtype)
    k = torch.square(torch.relu(dense(xk, p.cm_k).float())).to(x.dtype)
    r = torch.sigmoid(dense(xr, p.cm_r).float())
    return r.to(x.dtype) * dense(k, p.cm_v), x[:, -1, :]


def rwkv_init_state(cfg: ModelConfig, batch: int, *, dtype=torch.bfloat16, device) -> dict:
    """Zeroed decode state of one layer: ``x_tm`` / ``x_cm`` [B, d] in
    ``dtype``, ``s`` [B, H, D, D] f32."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return {
        "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "s": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32, device=device),
        "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }

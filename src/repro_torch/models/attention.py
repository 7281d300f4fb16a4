"""Attention: GQA/MQA/MHA with RoPE (or none, where the model adds
sinusoidal positions to its embeddings), optional QKV bias and sliding
window, prefill through the flash kernel (K4),
one-token decode against the KV cache, and the training path
(``attn_train``: full masked attention, or the chunked online softmax
beyond 2 * CHUNK tokens, in plain PyTorch with autograd).

The KV cache of one layer is ``{"k", "v": [B, slots, K, D], "pos":
[B, slots]}`` (``pos`` is the absolute position held in a slot, -1 when
empty).  Unlike the JAX package, which returns new cache arrays, the port
writes the cache in place and returns the same dict.  A sliding-window
arch's cache is a ring of ``slots`` positions: position p lives in slot
``p % slots``, in prefill and decode alike, so a decode step overwrites
the oldest position.  (The JAX prefill keeps the last ``slots`` positions
in slots ``0..slots-1`` instead, so after a prompt with ``S % slots != 0``
its first decode step evicts a position still inside the window; the port
differs from it there, and agrees wherever ``S <= slots`` or
``S % slots == 0``.)  Counterpart of
``repro/models/attention.py``; prefill always runs K4, whatever
``repro.models.attention.USE_PALLAS_FLASH`` says.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as k4
from repro_torch.models.layers import dense, normal_param, rope

__all__ = [
    "Attention", "attn_init", "init_cache", "attn_flash", "attn_prefill", "attn_decode", "attn_full", "attn_chunked",
    "attn_train",
]

NEG = -1e30
CHUNK = 512  # JAX attn_train switches to its chunked path beyond 2 * CHUNK tokens


class Attention(nn.Module):
    """q/k/v/o projections, [d_in, d_out] each, in the storage dtype, and
    with ``qkv_bias`` the q/k/v biases (zeros, as JAX inits them; cast at
    use like the weights)."""

    def __init__(self, cfg: ModelConfig, *, gen, device, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.q = normal_param((d, cfg.n_heads * hd), d**-0.5, **kw)
        self.k = normal_param((d, cfg.n_kv_heads * hd), d**-0.5, **kw)
        self.v = normal_param((d, cfg.n_kv_heads * hd), d**-0.5, **kw)
        self.o = normal_param((cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5, **kw)
        if cfg.qkv_bias:
            for name, width in (("q_bias", cfg.n_heads * hd), ("k_bias", cfg.n_kv_heads * hd),
                                ("v_bias", cfg.n_kv_heads * hd)):
                setattr(self, name, nn.Parameter(torch.zeros(width, dtype=dtype, device=device), requires_grad=False))
        else:
            self.q_bias = self.k_bias = self.v_bias = None


def attn_init(cfg: ModelConfig, *, gen, device, dtype) -> Attention:
    return Attention(cfg, gen=gen, device=device, dtype=dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16, device) -> dict:
    """Empty KV cache; a sliding-window arch holds only the window."""
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window
    slots = min(max_len, window) if window else max_len
    return {
        "k": torch.zeros((batch, slots, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32, device=device),
    }


def _qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(x, p.q, p.q_bias).reshape(b, s, cfg.n_heads, hd)
    k = dense(x, p.k, p.k_bias).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(x, p.v, p.v_bias).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.pos_embedding == "rope":
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    return q * (hd**-0.5), k, v


def _apply_out(p: Attention, out_bshd: torch.Tensor) -> torch.Tensor:
    b, s = out_bshd.shape[:2]
    return dense(out_bshd.reshape(b, s, -1), p.o)


def _mask_pos(cfg: ModelConfig, qpos: torch.Tensor, kpos: torch.Tensor) -> torch.Tensor:
    """[S, T] bool for query positions ``qpos`` and key positions ``kpos``:
    causal, and the sliding window when the arch has one."""
    m = kpos[None, :] <= qpos[:, None]
    if cfg.sliding_window:
        m &= qpos[:, None] - kpos[None, :] < cfg.sliding_window
    return m


def attn_full(p: Attention, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full (quadratic) masked attention over x [B, S, d], differentiable.
    Rounds where JAX ``attn_full`` does: logits f32 from compute-dtype q/k,
    softmax f32, weights cast to v's dtype, output projection in the
    compute dtype."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    kh = cfg.n_kv_heads
    qg = q.reshape(b, s, kh, cfg.n_heads // kh, -1)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())  # [B, K, G, S, T]
    pos = positions[0]
    logits = torch.where(_mask_pos(cfg, pos, pos), logits, torch.full((), NEG, device=x.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return _apply_out(p, out)


def _kv_step(cfg: ModelConfig, qc, kc, vc, qpos, kpos, m_run, l_run, acc):
    """One kv block of the online softmax: qc [B, c, K, G, D], kc/vc
    [B, c, K, D]; carries m/l [B, K, G, c] and acc [B, K, G, c, D] (f32)."""
    logits = torch.einsum("bskgd,btkd->bkgst", qc.float(), kc.float())
    logits = torch.where(_mask_pos(cfg, qpos, kpos), logits, torch.full((), NEG, device=qc.device))
    m_new = torch.maximum(m_run, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    scale = torch.exp(m_run - m_new)
    l_new = l_run * scale + p.sum(dim=-1)
    pv = torch.einsum("bkgst,btkd->bkgsd", p.to(vc.dtype), vc)
    return m_new, l_new, acc * scale[..., None] + pv.float()


def attn_chunked(p: Attention, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Flash-style chunked attention over x [B, S, d], differentiable: a
    loop over ``CHUNK``-token q blocks, each an online softmax over every
    kv block (masked logits ``NEG``, the running max from -inf, f32
    accumulators, output ``acc / max(l, 1e-30)``), each kv block
    recomputed in the backward (``torch.utils.checkpoint``, as JAX's
    ``jax.checkpoint``) instead of keeping its [B, K, G, c, c]
    probabilities.  Counterpart of JAX ``attn_chunked``: plain PyTorch,
    since JAX trains through this path too (K4 has no backward)."""
    b, s, _ = x.shape
    c = CHUNK
    assert s % c == 0, (s, c)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kh
    pos = positions[0]
    outs = []
    for i in range(s // c):
        qc, qpos = q[:, i * c:(i + 1) * c].reshape(b, c, kh, g, hd), pos[i * c:(i + 1) * c]
        m = torch.full((b, kh, g, c), -math.inf, dtype=torch.float32, device=x.device)
        l = torch.zeros((b, kh, g, c), dtype=torch.float32, device=x.device)
        acc = torch.zeros((b, kh, g, c, hd), dtype=torch.float32, device=x.device)
        for j in range(s // c):
            blk = slice(j * c, (j + 1) * c)
            m, l, acc = checkpoint(_kv_step, cfg, qc, k[:, blk], v[:, blk], qpos, pos[blk], m, l, acc,
                                   use_reentrant=False)
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)  # [B, S, K, G, D] f32
    return _apply_out(p, out.to(x.dtype))


def attn_train(p: Attention, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Training attention: ``attn_full`` up to 2 * CHUNK tokens,
    ``attn_chunked`` beyond, as JAX ``attn_train`` switches."""
    if x.shape[1] > 2 * CHUNK:
        return attn_chunked(p, cfg, x)
    return attn_full(p, cfg, x)


def attn_flash(p: Attention, cfg: ModelConfig, x: torch.Tensor, *, offset: int = 0):
    """Full-sequence attention through K4.  Returns (y, (k, v, positions))."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :] + offset
    q, k, v = _qkv(p, cfg, x, positions)
    # the kernel wrapper scales q itself, after undoing _qkv's pre-scale
    # (``prescale``, in the working dtype, so q is rounded twice, as in the
    # JAX package); on the card both roundings happen in the kernel's Q load,
    # and q, k, v are read as [B, H, S, D] views of their [B, S, H, D] storage
    out = k4.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=cfg.sliding_window, prescale=cfg.resolved_head_dim**0.5,
    )  # [B, H, S, D], its transpose dense on the card
    return _apply_out(p, out.transpose(1, 2)), (k, v, positions)


def attn_prefill(p: Attention, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """Attention over the prompt, filling the cache.  Returns (y, cache)."""
    y, (k, v, positions) = attn_flash(p, cfg, x)
    b, s = x.shape[:2]
    slots = cache["k"].shape[1]
    if s >= slots:  # keep the last ``slots`` positions, position p in slot p % slots
        start = s - slots
        at = torch.arange(start, s, device=x.device) % slots
        cache["k"][:, at] = k[:, start:].to(cache["k"].dtype)
        cache["v"][:, at] = v[:, start:].to(cache["v"].dtype)
        cache["pos"][:, at] = positions[:, start:].expand(b, slots)
    else:
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        cache["pos"][:, :s] = positions.expand(b, s)
    return y, cache


def attn_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor, cache: dict, step):
    """One-token decode (x [B, 1, d]).  ``step`` is the new token's absolute
    position: a Python int (every row at one depth) or a [B] int32 tensor
    (continuous batching: each row at its own depth, so cache writes
    scatter per row at ``(row, slot)`` and the causal and window mask is
    taken against per-row query positions).  The tensor form reads nothing
    on the host, so a CUDA graph replays it with new values.  Plain
    PyTorch: the JAX package runs this as XLA einsums, not a kernel."""
    b = x.shape[0]
    per_slot = isinstance(step, torch.Tensor)
    if per_slot:
        if step.dim() != 1 or step.shape[0] != b:
            raise ValueError(f"a per-slot step must be [{b}], got {tuple(step.shape)}")
        step = step.to(device=x.device, dtype=torch.int32)
        positions = step[:, None]
    else:
        positions = torch.full((1, 1), step, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    slots = cache["k"].shape[1]
    slot = step % slots if cfg.sliding_window else step
    if per_slot:
        at = (torch.arange(b, device=x.device), slot.long())
        qpos = step[:, None]  # [B, 1]
    else:
        at = (slice(None), slot)
        qpos = step
    cache["k"][at] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][at] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][at] = step
    kc, vc, pos = cache["k"], cache["v"], cache["pos"]
    kh = cfg.n_kv_heads
    qg = q.reshape(b, 1, kh, cfg.n_heads // kh, -1)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), kc.float())  # [B,K,G,1,T]
    valid = (pos >= 0) & (pos <= qpos)
    if cfg.sliding_window:
        valid &= (qpos - pos) < cfg.sliding_window
    logits = torch.where(valid[:, None, None, None, :], logits, torch.full((), NEG, device=x.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(vc.dtype), vc)  # [B, 1, K, G, D]
    return _apply_out(p, out), cache

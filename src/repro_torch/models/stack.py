"""Layer stack: a Python loop over layers takes the JAX ``lax.scan``'s
place, handing ``table.row(l)`` to the l-th MoE layer.  The training
stack checkpoints each block under ``cfg.remat == "block"``
(``torch.utils.checkpoint``, as JAX's ``jax.checkpoint`` of a period),
so the backward recomputes the block's forward, K1, K5 or K6 included,
under the world the forward ran in (the card's autograd runs a backward
on a thread of its own, where the caller's ``ep_world`` is not current).

Three mixers are ported, chosen by ``cfg.layer_kind(j)``: attention and
Mamba, each followed by an FFN chosen by ``cfg.ffn_kind(j)`` (the MoE
layer, the dense SwiGLU or, under ``ffn_gelu``, the GELU MLP), and RWKV6
(time mix + channel mix).  A layer's decode state is a dict: the KV cache
of ``attention.init_cache``, Mamba's ``{"h", "tail"}`` or RWKV6's
``rwkv.rwkv_init_state``.  Training runs every kind (a Mamba block's
scan backward is K6b).  Counterpart of ``repro/models/stack.py``.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hierarchical import HierarchicalTable
from repro_torch.core.schedule import A2ASchedule, ScheduleTable
from repro_torch.models import attention as attn
from repro_torch.models import mamba, rwkv
from repro_torch.models.layers import GeluMLP, SwiGLU, ones_param, rmsnorm
from repro_torch.models.moe import MoE, moe_apply, moe_init
from repro_torch.parallel.sharding import current_world, ep_world

__all__ = [
    "Block", "block_init", "block_train", "block_prefill", "block_decode", "stack_train", "stack_cache",
    "moe_rows", "schedule_rows",
]


class Block(nn.Module):
    """``ln1``, ``mixer`` and ``ln2``, plus ``ffn`` for an attention or a
    Mamba block (MoE, SwiGLU or GELU MLP); an rwkv6 block's channel mix
    lives in its mixer."""

    def __init__(self, cfg: ModelConfig, j: int, *, gen, device, dtype, experts=None):
        super().__init__()
        self.kind = cfg.layer_kind(j)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.ln1 = ones_param(cfg.d_model, device=device)
        if self.kind == "rwkv6":
            self.mixer = rwkv.RWKV(cfg, **kw)
            self.ln2 = ones_param(cfg.d_model, device=device)
            return
        self.mixer = attn.attn_init(cfg, **kw) if self.kind == "attn" else mamba.Mamba(cfg, **kw)
        self.ln2 = ones_param(cfg.d_model, device=device)
        if cfg.ffn_kind(j) == "moe":
            self.ffn = moe_init(cfg, **kw, experts=experts)
        elif cfg.ffn_gelu:
            self.ffn = GeluMLP(cfg.d_model, cfg.d_ff, **kw)
        else:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, **kw)


def block_init(cfg: ModelConfig, j: int, *, gen, device, dtype, experts=None) -> Block:
    """``experts`` (lo, hi): the MoE FFN keeps those experts (an EP rank's slice)."""
    return Block(cfg, j, gen=gen, device=device, dtype=dtype, experts=experts)


def block_train(p: Block, cfg: ModelConfig, x, schedule, *, collect_stats=False):
    """One training layer over x [B, S, d].  Returns (x, stats-or-None);
    an rwkv6 layer (time mix from S = 0, then channel mix) and a dense FFN
    have no stats; a Mamba mixer scans from a zero state."""
    h = rmsnorm(x, p.ln1, eps=cfg.norm_eps)
    if p.kind == "rwkv6":
        y, _ = rwkv.rwkv_time_mix(p.mixer, cfg, h)
        x = x + y
        y, _ = rwkv.rwkv_channel_mix(p.mixer, rmsnorm(x, p.ln2, eps=cfg.norm_eps))
        return x + y, None
    if p.kind == "mamba":
        x = x + mamba.mamba_seq(p.mixer, cfg, h)[0]
    else:
        x = x + attn.attn_train(p.mixer, cfg, h)
    h = rmsnorm(x, p.ln2, eps=cfg.norm_eps)
    return _ffn(p, cfg, x, h, schedule, collect_stats)


def stack_train(layers, cfg: ModelConfig, x, schedule, *, collect_stats=False):
    """Run the training stack over x [B, S, d].  ``schedule`` is None or a
    ``ScheduleTable`` with one row per MoE layer.  With ``collect_stats``
    returns ``(x, stats)``, the per-layer MoE stats stacked over layers
    (``routing`` [L, 1, E], ``dropped`` / ``admitted`` [L, 1])."""
    stats = []
    world = current_world()

    def contexts():  # (forward, recompute): the recompute re-enters the forward's world
        return contextlib.nullcontext(), ep_world(world)

    for p, row in zip(layers, schedule_rows(schedule, cfg)):
        if cfg.remat == "block":
            x, st = checkpoint(block_train, p, cfg, x, row, collect_stats=collect_stats, use_reentrant=False,
                               context_fn=contexts)
        elif cfg.remat == "none":
            x, st = block_train(p, cfg, x, row, collect_stats=collect_stats)
        else:
            raise ValueError(f"remat {cfg.remat!r}: the port runs 'none' or 'block'")
        stats.append(st)
    return (x, stack_stats(stats)) if collect_stats else x


def block_prefill(p: Block, cfg: ModelConfig, x, cache: dict, schedule, *, collect_stats=False):
    """One layer over the prompt, filling ``cache`` in place.  Returns
    (x, cache, stats-or-None)."""
    h = rmsnorm(x, p.ln1, eps=cfg.norm_eps)
    if p.kind == "rwkv6":
        y, (x_tm, s) = rwkv.rwkv_time_mix(p.mixer, cfg, h)
        return _rwkv_channel(p, cfg, x + y, cache, x_tm, s, None)
    if p.kind == "mamba":  # the scan writes the final state into the cache's own tensor
        y, (_, tail) = mamba.mamba_seq(p.mixer, cfg, h, h_out=cache["h"])
        cache["tail"].copy_(tail)
    else:
        y, cache = attn.attn_prefill(p.mixer, cfg, h, cache)
    x = x + y
    h = rmsnorm(x, p.ln2, eps=cfg.norm_eps)
    x, stats = _ffn(p, cfg, x, h, schedule, collect_stats)
    return x, cache, stats


def block_decode(p: Block, cfg: ModelConfig, x, cache: dict, step, schedule, *, collect_stats=False,
                 token_weight=None):
    """One decode layer, updating ``cache`` in place.  ``step`` is an int
    or a [B] per-slot position tensor (``attn.attn_decode``; rwkv6 and Mamba
    layers ignore it); ``token_weight`` ([B, 1] f32) weights the MoE routing
    counts only.  Returns (x, cache, stats-or-None)."""
    h = rmsnorm(x, p.ln1, eps=cfg.norm_eps)
    if p.kind == "rwkv6":
        y, (x_tm, s) = rwkv.rwkv_time_mix(p.mixer, cfg, h, state=(cache["x_tm"].to(h.dtype), cache["s"]))
        return _rwkv_channel(p, cfg, x + y, cache, x_tm, s, cache["x_cm"])
    if p.kind == "mamba":
        y, cache = mamba.mamba_step(p.mixer, cfg, h, cache)
    else:
        y, cache = attn.attn_decode(p.mixer, cfg, h, cache, step)
    x = x + y
    h = rmsnorm(x, p.ln2, eps=cfg.norm_eps)
    x, stats = _ffn(p, cfg, x, h, schedule, collect_stats, token_weight)
    return x, cache, stats


def _rwkv_channel(p: Block, cfg, x, cache: dict, x_tm, s, x_cm_last):
    """The rwkv6 block after its time mix: channel mix, then the new state
    (the tokens in the cache's dtype, S in f32) copied into ``cache``'s own
    tensors, so a captured decode step carries it from replay to replay."""
    h = rmsnorm(x, p.ln2, eps=cfg.norm_eps)
    state = None if x_cm_last is None else x_cm_last.to(h.dtype)
    y, x_cm = rwkv.rwkv_channel_mix(p.mixer, h, state=state)
    cache["x_tm"].copy_(x_tm)
    cache["s"].copy_(s)
    cache["x_cm"].copy_(x_cm)
    return x + y, cache, None


def _ffn(p: Block, cfg, x, h, schedule, collect_stats, token_weight=None):
    if not isinstance(p.ffn, MoE):
        return x + p.ffn(h), None
    if collect_stats:
        y, stats = moe_apply(p.ffn, cfg, h, schedule=schedule, return_stats=True, token_weight=token_weight)
        return x + y, stats
    return x + moe_apply(p.ffn, cfg, h, schedule=schedule), None


def stack_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16, device) -> list[dict]:
    """One cache dict per layer: a KV cache for attention, the O(1) decode
    state for rwkv6 and Mamba."""
    states = {"rwkv6": rwkv.rwkv_init_state, "mamba": mamba.mamba_init_state}
    return [
        states[cfg.layer_kind(j)](cfg, batch, dtype=dtype, device=device) if cfg.layer_kind(j) in states
        else attn.init_cache(cfg, batch, max_len, dtype=dtype, device=device)
        for j in range(cfg.n_layers)
    ]


def moe_rows(cfg: ModelConfig) -> list[int | None]:
    """The table row of each layer: the MoE layers take rows 0, 1, ... in
    layer order, a non-MoE layer None.  JAX lays its rows out as [period,
    MoE position in the period] (``_schedule_rows``): row p * m + i for the
    i-th MoE layer of period p, with m MoE layers a period, which is the
    same order (Jamba: layers 1, 3, 5, 7 of each 8 take rows 4 p + 0..3)."""
    rows, n = [], 0
    for l in range(cfg.n_layers):
        rows.append(n if cfg.ffn_kind(l) == "moe" else None)
        n += rows[-1] is not None
    return rows


def schedule_rows(schedule, cfg: ModelConfig) -> list:
    """Per-layer schedules: ``table.row(i)`` for the MoE layer of row i
    (``moe_rows``), None for a layer without MoE; a static
    ``A2ASchedule`` goes to every MoE layer, as JAX broadcasts it."""
    if schedule is None:
        return [None] * cfg.n_layers
    if isinstance(schedule, A2ASchedule):
        return [None if i is None else schedule for i in moe_rows(cfg)]
    if not isinstance(schedule, (ScheduleTable, HierarchicalTable)) or schedule.is_row:
        raise TypeError("the stack takes a full ScheduleTable or HierarchicalTable (one row per MoE layer) or None")
    if schedule.num_layers != cfg.n_moe_layers:
        raise ValueError(f"table has {schedule.num_layers} rows for {cfg.n_moe_layers} MoE layers")
    return [None if i is None else schedule.row(i) for i in moe_rows(cfg)]


def stack_stats(per_layer: list) -> dict | None:
    """Per-layer stats dicts (None for a layer without MoE) -> one dict of
    [n_moe_layers, ...] tensors, or None for a model without MoE."""
    moe = [s for s in per_layer if s is not None]
    return {key: torch.stack([s[key] for s in moe]) for key in moe[0]} if moe else None

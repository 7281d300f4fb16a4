"""Layer stack: a Python loop over layers takes the JAX ``lax.scan``'s
place, handing ``table.row(l)`` to the l-th MoE layer.  The training
stack checkpoints each block under ``cfg.remat == "block"``
(``torch.utils.checkpoint``, as JAX's ``jax.checkpoint`` of a period),
so the backward recomputes the block's forward, K1 included.

Two block kinds are ported, chosen by ``cfg.layer_kind(j)``: attention +
MoE/SwiGLU (Mixtral's pattern) and RWKV6 (time mix + channel mix, whose
per-layer state is the dict of ``rwkv.rwkv_init_state``; serving only).
Counterpart of ``repro/models/stack.py``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import ScheduleTable
from repro_torch.models import attention as attn
from repro_torch.models import rwkv
from repro_torch.models.layers import ones_param, rmsnorm
from repro_torch.models.moe import moe_apply, moe_init

__all__ = [
    "Block", "block_init", "block_train", "block_prefill", "block_decode", "stack_train", "stack_cache",
    "moe_rows", "schedule_rows",
]


class Block(nn.Module):
    """``ln1``, ``mixer`` and ``ln2``, plus ``ffn`` for an attention block;
    an rwkv6 block's channel mix lives in its mixer."""

    def __init__(self, cfg: ModelConfig, j: int, *, gen, device, dtype):
        super().__init__()
        self.kind = cfg.layer_kind(j)
        self.ln1 = ones_param(cfg.d_model, device=device)
        if self.kind == "rwkv6":
            self.mixer = rwkv.RWKV(cfg, gen=gen, device=device, dtype=dtype)
            self.ln2 = ones_param(cfg.d_model, device=device)
            return
        if cfg.ffn_kind(j) != "moe":
            raise NotImplementedError("dense-FFN blocks are not ported yet (ROADMAP: other mixers)")
        self.mixer = attn.attn_init(cfg, gen=gen, device=device, dtype=dtype)
        self.ln2 = ones_param(cfg.d_model, device=device)
        self.ffn = moe_init(cfg, gen=gen, device=device, dtype=dtype)


def block_init(cfg: ModelConfig, j: int, *, gen, device, dtype) -> Block:
    return Block(cfg, j, gen=gen, device=device, dtype=dtype)


def block_train(p: Block, cfg: ModelConfig, x, schedule, *, collect_stats=False):
    """One training layer over x [B, S, d].  Returns (x, stats-or-None)."""
    if p.kind != "attn":
        raise NotImplementedError(f"training {p.kind} blocks is not ported yet (ROADMAP: RWKV training)")
    h = rmsnorm(x, p.ln1, eps=cfg.norm_eps)
    x = x + attn.attn_train(p.mixer, cfg, h)
    h = rmsnorm(x, p.ln2, eps=cfg.norm_eps)
    return _ffn(p, cfg, x, h, schedule, collect_stats)


def stack_train(layers, cfg: ModelConfig, x, schedule, *, collect_stats=False):
    """Run the training stack over x [B, S, d].  ``schedule`` is None or a
    ``ScheduleTable`` with one row per MoE layer.  With ``collect_stats``
    returns ``(x, stats)``, the per-layer MoE stats stacked over layers
    (``routing`` [L, 1, E], ``dropped`` / ``admitted`` [L, 1])."""
    stats = []
    for p, row in zip(layers, schedule_rows(schedule, cfg)):
        if cfg.remat == "block":
            x, st = checkpoint(block_train, p, cfg, x, row, collect_stats=collect_stats, use_reentrant=False)
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
    y, cache = attn.attn_prefill(p.mixer, cfg, h, cache)
    x = x + y
    h = rmsnorm(x, p.ln2, eps=cfg.norm_eps)
    x, stats = _ffn(p, cfg, x, h, schedule, collect_stats)
    return x, cache, stats


def block_decode(p: Block, cfg: ModelConfig, x, cache: dict, step, schedule, *, collect_stats=False,
                 token_weight=None):
    """One decode layer, updating ``cache`` in place.  ``step`` is an int
    or a [B] per-slot position tensor (``attn.attn_decode``; an rwkv6 layer
    ignores it); ``token_weight`` ([B, 1] f32) weights the MoE routing
    counts only.  Returns (x, cache, stats-or-None)."""
    h = rmsnorm(x, p.ln1, eps=cfg.norm_eps)
    if p.kind == "rwkv6":
        y, (x_tm, s) = rwkv.rwkv_time_mix(p.mixer, cfg, h, state=(cache["x_tm"].to(h.dtype), cache["s"]))
        return _rwkv_channel(p, cfg, x + y, cache, x_tm, s, cache["x_cm"])
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
    if collect_stats:
        y, stats = moe_apply(p.ffn, cfg, h, schedule=schedule, return_stats=True, token_weight=token_weight)
        return x + y, stats
    return x + moe_apply(p.ffn, cfg, h, schedule=schedule), None


def stack_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16, device) -> list[dict]:
    """One cache dict per layer: a KV cache for attention, the O(1) decode
    state for rwkv6."""
    return [
        rwkv.rwkv_init_state(cfg, batch, dtype=dtype, device=device) if cfg.layer_kind(j) == "rwkv6"
        else attn.init_cache(cfg, batch, max_len, dtype=dtype, device=device)
        for j in range(cfg.n_layers)
    ]


def moe_rows(cfg: ModelConfig) -> list[int | None]:
    """The table row of each layer: the MoE layers take rows 0, 1, ... in
    layer order (JAX lays its rows out as [period, MoE position in the
    period], ``moe_positions``: the same order), a non-MoE layer None."""
    rows, n = [], 0
    for l in range(cfg.n_layers):
        rows.append(n if cfg.ffn_kind(l) == "moe" else None)
        n += rows[-1] is not None
    return rows


def schedule_rows(schedule, cfg: ModelConfig) -> list:
    """Per-layer schedules: ``table.row(i)`` for the MoE layer of row i
    (``moe_rows``), None for a layer without MoE."""
    if schedule is None:
        return [None] * cfg.n_layers
    if not isinstance(schedule, ScheduleTable) or schedule.is_row:
        raise TypeError("the stack takes a full ScheduleTable (one row per MoE layer) or None")
    if schedule.num_layers != cfg.n_moe_layers:
        raise ValueError(f"table has {schedule.num_layers} rows for {cfg.n_moe_layers} MoE layers")
    return [None if i is None else schedule.row(i) for i in moe_rows(cfg)]


def stack_stats(per_layer: list) -> dict | None:
    """Per-layer stats dicts (None for a layer without MoE) -> one dict of
    [n_moe_layers, ...] tensors, or None for a model without MoE."""
    moe = [s for s in per_layer if s is not None]
    return {key: torch.stack([s[key] for s in moe]) for key in moe[0]} if moe else None

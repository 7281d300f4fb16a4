"""Layer stack: a Python loop over layers takes the JAX ``lax.scan``'s
place, handing ``table.row(l)`` to the l-th MoE layer.  The training
stack checkpoints each block under ``cfg.remat == "block"``
(``torch.utils.checkpoint``, as JAX's ``jax.checkpoint`` of a period),
so the backward recomputes the block's forward, K1 included.

Only attention + MoE/SwiGLU blocks are ported (Mixtral's pattern).
Counterpart of ``repro/models/stack.py``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import ScheduleTable
from repro_torch.models import attention as attn
from repro_torch.models.layers import ones_param, rmsnorm
from repro_torch.models.moe import moe_apply, moe_init

__all__ = [
    "Block", "block_init", "block_train", "block_prefill", "block_decode", "stack_train", "stack_cache",
    "schedule_rows",
]


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, j: int, *, gen, device, dtype):
        super().__init__()
        if cfg.ffn_kind(j) != "moe":
            raise NotImplementedError("dense-FFN blocks are not ported yet (ROADMAP: other mixers)")
        self.ln1 = ones_param(cfg.d_model, device=device)
        self.mixer = attn.attn_init(cfg, gen=gen, device=device, dtype=dtype)
        self.ln2 = ones_param(cfg.d_model, device=device)
        self.ffn = moe_init(cfg, gen=gen, device=device, dtype=dtype)


def block_init(cfg: ModelConfig, j: int, *, gen, device, dtype) -> Block:
    return Block(cfg, j, gen=gen, device=device, dtype=dtype)


def block_train(p: Block, cfg: ModelConfig, x, schedule, *, collect_stats=False):
    """One training layer over x [B, S, d].  Returns (x, stats-or-None)."""
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
    """One layer over the prompt.  Returns (x, cache, stats-or-None)."""
    h = rmsnorm(x, p.ln1, eps=cfg.norm_eps)
    y, cache = attn.attn_prefill(p.mixer, cfg, h, cache)
    x = x + y
    h = rmsnorm(x, p.ln2, eps=cfg.norm_eps)
    x, stats = _ffn(p, cfg, x, h, schedule, collect_stats)
    return x, cache, stats


def block_decode(p: Block, cfg: ModelConfig, x, cache: dict, step: int, schedule, *, collect_stats=False):
    """One decode layer.  Returns (x, cache, stats-or-None)."""
    h = rmsnorm(x, p.ln1, eps=cfg.norm_eps)
    y, cache = attn.attn_decode(p.mixer, cfg, h, cache, step)
    x = x + y
    h = rmsnorm(x, p.ln2, eps=cfg.norm_eps)
    x, stats = _ffn(p, cfg, x, h, schedule, collect_stats)
    return x, cache, stats


def _ffn(p: Block, cfg, x, h, schedule, collect_stats):
    if collect_stats:
        y, stats = moe_apply(p.ffn, cfg, h, schedule=schedule, return_stats=True)
        return x + y, stats
    return x + moe_apply(p.ffn, cfg, h, schedule=schedule), None


def stack_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16, device) -> list[dict]:
    """One KV cache dict per layer."""
    return [attn.init_cache(cfg, batch, max_len, dtype=dtype, device=device) for _ in range(cfg.n_layers)]


def schedule_rows(schedule, cfg: ModelConfig) -> list:
    """Per-layer schedules: ``table.row(l)`` for each MoE layer, or None."""
    if schedule is None:
        return [None] * cfg.n_layers
    if not isinstance(schedule, ScheduleTable) or schedule.is_row:
        raise TypeError("the stack takes a full ScheduleTable (one row per MoE layer) or None")
    if schedule.num_layers != cfg.n_moe_layers:
        raise ValueError(f"table has {schedule.num_layers} rows for {cfg.n_moe_layers} MoE layers")
    return [schedule.row(l) for l in range(cfg.n_layers)]


def stack_stats(per_layer: list[dict]) -> dict:
    """Per-layer stats dicts -> one dict of [n_moe_layers, ...] tensors."""
    return {key: torch.stack([s[key] for s in per_layer]) for key in per_layer[0]}

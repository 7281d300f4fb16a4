"""Mixture-of-Experts FFN: route -> admit -> pack -> grouped expert GEMM
(kernel K1) -> combine, on the one-device virtual fabric.

Top-k softmax gating with capacity-factor dropping; a ``ScheduleTable``
row's admission decides which choices reach the expert GEMM, and its
virtual ranks decide which slots cross the wire codec.  Every
``MoECfg.dispatch`` name runs the virtual dense fabric here, as it does
in the JAX package on one device (``repro/models/moe.py``, ``moe_apply``).
On a CUDA tensor the expert FFN always runs K1 (and K2/K3 in its
backward), whatever ``MoECfg.use_pallas`` says.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import ScheduleTable
from repro_torch.kernels.moe_gemm import ops as k1
from repro_torch.models.layers import normal_param
from repro_torch.parallel.fabric import FABRIC_NAMES, DenseFabric, FabricContext
from repro_torch.parallel.fabric import geometry as geom

__all__ = ["MoE", "moe_init", "moe_apply"]

_DENSE = DenseFabric()


class MoE(nn.Module):
    """router [d, E] (f32, as JAX uses it), w_gate/w_up [E, d, F] and
    w_down [E, F, d] in the storage dtype, cast to the compute dtype at use."""

    def __init__(self, cfg: ModelConfig, *, gen, device, dtype):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
        self.router = normal_param((d, e), 0.02, gen=gen, device=device, dtype=torch.float32)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.w_gate = normal_param((e, d, f), d**-0.5, **kw)
        self.w_up = normal_param((e, d, f), d**-0.5, **kw)
        self.w_down = normal_param((e, f, d), f**-0.5, **kw)


def moe_init(cfg: ModelConfig, *, gen, device, dtype) -> MoE:
    return MoE(cfg, gen=gen, device=device, dtype=dtype)


def _router(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """x [T, d] -> (expert ids [T, k] int32, gates [T, k] f32)."""
    m = cfg.moe
    logits = x.float() @ p.router.float()
    vals, idx = torch.topk(logits, m.top_k, dim=-1)
    if m.router_norm_topk:
        gates = torch.softmax(vals, dim=-1)
    else:
        gates = torch.gather(torch.softmax(logits, dim=-1), -1, idx)
    return idx.to(torch.int32), gates


def _expert_ffn(p: MoE, x: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over expert groups: [E, C, d] -> [E, C, d] via K1
    (differentiable through K2/K3)."""
    return k1.moe_gemm(x, p.w_gate.to(x.dtype), p.w_up.to(x.dtype), p.w_down.to(x.dtype), row_valid)


def _pipeline_body(fabric, ctx: FabricContext, x_loc, p: MoE, *, return_stats: bool, token_weight=None):
    m = ctx.moe
    t = x_loc.shape[0]
    idx, gates = _router(p, ctx.cfg, x_loc)
    packed = fabric.pack(ctx, x_loc, idx, gates)
    # wire codec: QDQ the wire-crossing slots on both legs (the bf16 identity leaves them as they are)
    packed = fabric.wire_encode(ctx, packed)
    blocks, state = fabric.dispatch(ctx, packed)
    ys = [_expert_ffn(p, blk, live) for blk, live in blocks]
    y_slots = fabric.combine(ctx, packed, state, ys)
    y_slots = fabric.wire_decode(ctx, packed, y_slots)
    y_loc = geom.ungroup(y_slots, packed.pos, packed.gate, t)  # [t, d] f32
    if not return_stats:
        return y_loc
    counts = geom.routing_counts(idx, m.n_experts, weight=token_weight)[None, :]
    return y_loc, geom.stats_tree(counts, packed.admitted, packed.live)


def moe_apply(
    p: MoE, cfg: ModelConfig, x: torch.Tensor, *, schedule=None, return_stats: bool = False, token_weight=None,
):
    """The MoE FFN on x [B, S, d].  ``schedule`` is None or a
    ``ScheduleTable`` row.  With ``return_stats`` also returns
    ``{"routing": [1, E], "dropped": [1], "admitted": [1]}``: realized
    pre-drop demand, plan-admitted choices that packing cut, and the
    plan-admitted choices.  ``token_weight`` ([B, S] f32, optional,
    stats-only) scales each token's routing count: the serving engine's
    slot-liveness mask.  Vacated slots are still routed and admitted."""
    m = cfg.moe
    if isinstance(schedule, ScheduleTable) and not schedule.is_row:
        raise ValueError("moe_apply consumes per-layer rows — pass table.row(l)")
    if m.dispatch not in FABRIC_NAMES and m.dispatch != "scheduled":
        raise ValueError(
            f"unknown dispatch mode {m.dispatch!r}: fabrics are {', '.join(FABRIC_NAMES)} "
            "(plus the 'scheduled' alias)"
        )
    b, s, d = x.shape
    t = b * s
    ctx = FabricContext(cfg=cfg, schedule=_DENSE.validate_schedule(schedule))
    weight = None if token_weight is None else token_weight.reshape(t)
    res = _pipeline_body(_DENSE, ctx, x.reshape(t, d), p, return_stats=return_stats, token_weight=weight)
    if not return_stats:
        return res.to(x.dtype).reshape(b, s, d)
    y, stats = res
    return y.to(x.dtype).reshape(b, s, d), stats

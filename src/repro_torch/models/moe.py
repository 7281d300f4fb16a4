"""Mixture-of-Experts FFN: ONE pipeline over pluggable dispatch fabrics.

route (top-k) -> admit -> pack -> ``fabric.dispatch`` -> grouped expert
GEMM (kernel K1) -> ``fabric.combine`` -> scatter back, with the fabric
resolved from ``MoECfg.dispatch`` by name (``parallel.fabric``).

On one device (no world, or a world of one EP rank) every name runs the
virtual dense fabric, as the JAX package does there: a ``ScheduleTable``
row's admission decides which choices reach the expert GEMM, and its
virtual ranks which slots cross the wire codec.  Under a world of n > 1
EP ranks (``parallel.sharding.ep_world``) the layer cuts the sequence
into n contiguous chunks, rank ``me`` running the fabric on
``x[:, me * S / n : (me + 1) * S / n]`` (JAX's sequence-sharded
``shard_map`` input), and all-gathers the outputs over the model group.
``dispatch="dense"``, and any sequence that does not split evenly over
the ranks (decode at S = 1), take the dense fabric's EP form instead
(local experts over the replicated tokens, an all-reduce combine), as
JAX's ``moe_apply`` falls back on a mesh.  ``PATH_CALLS`` counts the
layer calls by path.

A rank holds just the experts ``world.expert_range(E)`` (``Model(...,
expert_shard=)``); a module holding any other count raises.  Under 2D
expert sharding (``MoECfg.expert_2d`` in a world of several data groups,
JAX's ``train_rules(expert_2d=True)``) it holds also just its data
group's slice of their FFN width, ``world.ffn_range(F)``: every fabric,
and the dense EP form, then runs each block through ``_expert_block``,
which gathers the data groups' tokens around the GEMM on that slice.
Gradients across ranks follow ``parallel.collectives``' convention: the
router's and the input's are partial on each rank and sum over the model
group to the one-device gradient; an expert's is whole on its rank (under
2D: its FFN slice's, summed over every data group's tokens).

On a CUDA tensor the expert FFN always runs K1 (and K2/K3 in its
backward), on every fabric, whatever ``MoECfg.use_pallas`` says; a
block the fabric ships without validity computes every row tile.
Counterpart of ``repro/models/moe.py``.
"""

from __future__ import annotations

import collections

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hierarchical import HierarchicalTable
from repro_torch.core.schedule import ScheduleTable
from repro_torch.kernels.moe_gemm import ops as k1
from repro_torch.models.layers import normal_param
from repro_torch.parallel import collectives as col
from repro_torch.parallel.fabric import FABRICS, FabricContext, get_fabric, resolve_fabric
from repro_torch.parallel.fabric import geometry as geom
from repro_torch.parallel.sharding import current_world

__all__ = ["MoE", "PATH_CALLS", "moe_init", "moe_apply"]

# MoE layer calls by path: "virtual" (one device), "dense_ep" (the dense fabric across ranks) or the EP fabric's name
PATH_CALLS: collections.Counter = collections.Counter()


class MoE(nn.Module):
    """router [d, E] (f32, as JAX uses it), w_gate/w_up [E, d, F] and
    w_down [E, F, d] in the storage dtype, cast to the compute dtype at use.
    ``experts`` (lo, hi) keeps only those experts (an EP rank's slice) and
    ``ffn`` (lo, hi) only those columns of their FFN width (a data group's
    slice under 2D expert sharding)."""

    def __init__(self, cfg: ModelConfig, *, gen, device, dtype, experts=None, ffn=None):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
        experts = slice(*((0, e) if experts is None else experts))
        ffn = slice(*((0, f) if ffn is None else ffn))
        self.router = normal_param((d, e), 0.02, gen=gen, device=device, dtype=torch.float32)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.w_gate = _expert_param((e, d, f), d**-0.5, (experts, slice(None), ffn), **kw)
        self.w_up = _expert_param((e, d, f), d**-0.5, (experts, slice(None), ffn), **kw)
        self.w_down = _expert_param((e, f, d), f**-0.5, (experts, ffn, slice(None)), **kw)


def _expert_param(shape, scale: float, part: tuple, *, gen, device, dtype) -> nn.Parameter:
    """The part ``part`` (a slice per axis) of a seeded [E, ...] draw.  The
    whole tensor is drawn, so the generator's stream (and every later
    parameter) is the one-device model's."""
    sizes = tuple(len(range(*s.indices(n))) for s, n in zip(part, shape))
    if sizes == tuple(shape):
        return normal_param(shape, scale, gen=gen, device=device, dtype=dtype)
    if gen is None:
        return normal_param(sizes, scale, gen=None, device=device, dtype=dtype)
    full = normal_param(shape, scale, gen=gen, device=device, dtype=dtype)
    return nn.Parameter(full.data[part].clone(), requires_grad=False)


def moe_init(cfg: ModelConfig, *, gen, device, dtype, experts=None, ffn=None) -> MoE:
    return MoE(cfg, gen=gen, device=device, dtype=dtype, experts=experts, ffn=ffn)


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


def _local_experts(p: MoE, cfg: ModelConfig, world) -> tuple:
    """(w_gate, w_up, w_down) of the experts this rank runs: all of them
    on one device, its ``world.expert_range`` across ranks (the module
    holds just that slice) and, under 2D expert sharding, its
    ``world.ffn_range`` of their FFN width."""
    m = cfg.moe
    e, f = m.n_experts, m.d_ff_expert
    held, held_f = p.w_gate.shape[0], p.w_gate.shape[2]
    ws = (p.w_gate, p.w_up, p.w_down)
    if world is None or world.size == 1:
        if (held, held_f) != (e, f):
            raise ValueError(f"the module holds {held} of {e} experts, {held_f} of {f} FFN columns: run it under "
                             f"its world")
        return ws
    lo, hi = world.expert_range(e)
    if held != hi - lo:
        raise ValueError(f"the module holds {held} experts; EP rank {world.me} of {world.n} runs {hi - lo}")
    f_lo, f_hi = world.ffn_range(f) if world.two_d(cfg) else (0, f)
    if held_f != f_hi - f_lo:
        raise ValueError(f"the module holds {held_f} FFN columns of each expert; data group {world.data_index} of "
                         f"{world.n_data} runs {f_hi - f_lo} (expert_2d={m.expert_2d})")
    return ws


def _expert_ffn(ws, x: torch.Tensor, row_valid) -> torch.Tensor:
    """Grouped SwiGLU over expert groups: [G, C, d] -> [G, C, d] via K1
    (differentiable through K2/K3); ``row_valid`` None computes every row."""
    if row_valid is None:
        row_valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    return k1.moe_gemm(x, *(w.to(x.dtype) for w in ws), row_valid)


def _expert_block(ctx: FabricContext, ws, blk: torch.Tensor, live) -> torch.Tensor:
    """The grouped expert compute of one fabric block [G, C, d]: every
    fabric's blocks pass through here.  Under 2D expert sharding the block
    (and its validity) is all-gathered over the data group along the
    capacity dim, K1 runs on the rank's slice of the FFN width, and the
    partial outputs are reduce-scattered back, each data group keeping its
    own rows summed over every slice.  The backward gathers the data
    groups' cotangents, so an expert slice's gradient is summed over every
    data group's tokens."""
    if not ctx.two_d:
        return _expert_ffn(ws, blk, live)
    group, n_data = ctx.world.data_group, ctx.world.n_data
    g, c, d = blk.shape
    every = col.all_gather(blk, group).permute(1, 0, 2, 3).reshape(g, n_data * c, d)
    if live is not None:
        live = col.all_gather_stats(live.float(), group).permute(1, 0, 2).reshape(g, n_data * c) > 0
    y_part = _expert_ffn(ws, every, live)
    return col.reduce_scatter(y_part.reshape(g, n_data, c, d).permute(1, 0, 2, 3), group)


def _pipeline_body(fabric, ctx: FabricContext, x_loc, p: MoE, ws, *, return_stats: bool, token_weight=None):
    m = ctx.moe
    t = x_loc.shape[0]
    idx, gates = _router(p, ctx.cfg, x_loc)
    packed = fabric.pack(ctx, x_loc, idx, gates)
    # wire codec: QDQ the wire-crossing slots on both legs (the bf16 identity leaves them as they are)
    packed = fabric.wire_encode(ctx, packed)
    blocks, state = fabric.dispatch(ctx, packed)
    # one cast of the local experts a layer call, shared by every block's launch (as JAX casts once): under
    # autograd each launch would otherwise keep a copy of its own for the backward
    ws = tuple(w.to(x_loc.dtype) for w in ws)
    ys = [_expert_block(ctx, ws, blk, live) for blk, live in blocks]
    y_slots = fabric.combine(ctx, packed, state, ys)
    y_loc = fabric.unpack(ctx, packed, y_slots, t)  # [t, d] f32
    if not return_stats:
        return y_loc
    counts = geom.routing_counts(idx, m.n_experts, weight=token_weight)[None, :]
    return y_loc, geom.stats_tree(counts, packed.admitted, packed.live)


def _sum_data(stats: dict, world) -> dict:
    """Stats summed over data replicas (JAX sums the batch shards)."""
    if world is None or world.n_data == 1:
        return stats
    out = {}
    with torch.no_grad():
        for key, v in stats.items():
            v = v.clone()
            torch.distributed.all_reduce(v, group=world.data_group)
            out[key] = v
    return out


def _moe_dense(p, cfg, x, fabric, schedule, return_stats, token_weight, world):
    """The dense fabric: virtual on one device, its EP form across ranks."""
    b, s, d = x.shape
    t = b * s
    n = 1 if world is None else world.n
    ctx = FabricContext(cfg=cfg, schedule=schedule, n=n, e_local=cfg.moe.n_experts // n,
                        me=0 if world is None else world.me, world=world,
                        two_d=world is not None and world.two_d(cfg))
    PATH_CALLS["dense_ep" if ctx.ep else "virtual"] += 1
    weight = None if token_weight is None else token_weight.reshape(t)
    res = _pipeline_body(fabric, ctx, x.reshape(t, d), p, _local_experts(p, cfg, world),
                         return_stats=return_stats, token_weight=weight)
    if not return_stats:
        return res.to(x.dtype).reshape(b, s, d)
    y, stats = res
    return y.to(x.dtype).reshape(b, s, d), _sum_data(stats, world)


def _moe_ep_pipeline(p, cfg, x, fabric, schedule, return_stats, token_weight, world):
    """The pipeline on this rank's sequence chunk, outputs all-gathered over
    the model group; stats stacked over the source ranks (``routing``
    [n, E], ``dropped`` / ``admitted`` [n])."""
    m = cfg.moe
    n, me = world.n, world.me
    b, s, d = x.shape
    s_loc = s // n
    chunk = slice(me * s_loc, (me + 1) * s_loc)
    ctx = FabricContext(cfg=cfg, schedule=schedule, n=n, e_local=m.n_experts // n, me=me, world=world,
                        two_d=world.two_d(cfg))
    PATH_CALLS[fabric.name] += 1
    weight = None if token_weight is None else token_weight[:, chunk].reshape(b * s_loc)
    res = _pipeline_body(fabric, ctx, x[:, chunk].reshape(b * s_loc, d), p, _local_experts(p, cfg, world),
                         return_stats=return_stats, token_weight=weight)
    y_loc, stats = res if return_stats else (res, None)
    y = col.all_gather(y_loc.to(x.dtype).reshape(b, s_loc, d), world.model_group)  # [n, b, s_loc, d]
    y = y.permute(1, 0, 2, 3).reshape(b, s, d)
    if not return_stats:
        return y
    flat = torch.cat([stats["routing"][0], stats["dropped"].reshape(1), stats["admitted"].reshape(1)])
    every = col.all_gather_stats(flat, world.model_group)  # [n, E + 2]
    e = m.n_experts
    return y, _sum_data({"routing": every[:, :e], "dropped": every[:, e], "admitted": every[:, e + 1]}, world)


def moe_apply(
    p: MoE, cfg: ModelConfig, x: torch.Tensor, *, schedule=None, return_stats: bool = False, token_weight=None,
):
    """The MoE FFN on x [B, S, d] through the fabric ``cfg.moe.dispatch``
    names.  ``schedule`` is what that fabric consumes: None, a static
    ``A2ASchedule`` (ppermute), a ``ScheduleTable`` row or a
    ``HierarchicalTable`` row.  With
    ``return_stats`` also returns ``{"routing", "dropped", "admitted"}``:
    realized pre-drop demand [n_src, E], plan-admitted choices that
    packing cut [n_src] and the plan-admitted choices [n_src], one row
    per EP source rank (a single row on one device and on the dense
    fabric).  ``token_weight`` ([B, S] f32, optional, stats-only) scales
    each token's routing count: the serving engine's slot-liveness mask.
    Vacated slots are still routed and admitted."""
    m = cfg.moe
    mode = m.dispatch
    if isinstance(schedule, (ScheduleTable, HierarchicalTable)) and not schedule.is_row:
        raise ValueError("moe_apply consumes per-layer rows — pass table.row(l)")
    if mode != "scheduled":
        get_fabric(mode)  # unknown names fail fast, listing the registry
    world = current_world()
    n = 1 if world is None else world.n
    if n == 1 or mode == "dense" or x.shape[1] % n:
        fabric = FABRICS["dense"]
        return _moe_dense(p, cfg, x, fabric, fabric.validate_schedule(schedule, n=1), return_stats,
                          token_weight, world)
    fabric = resolve_fabric(mode, schedule)
    sched = fabric.validate_schedule(schedule, n=n)
    if not fabric.uses_mesh:
        return _moe_dense(p, cfg, x, fabric, sched, return_stats, token_weight, world)
    return _moe_ep_pipeline(p, cfg, x, fabric, sched, return_stats, token_weight, world)

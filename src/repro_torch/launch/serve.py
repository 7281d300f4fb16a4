"""Batched serving entry point: plan a schedule, prefill, greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --smoke --batch 4 --prompt-len 64 --new-tokens 16 --controller

With ``--controller`` a ``ScheduleRuntime`` (``make_serving_controller``)
observes each round's demand estimate, re-plans between rounds when the
estimate drifts (``--drift shift|hotspot|skew``; ``shift`` by default, as
JAX's launcher, ``none`` for a fixed demand) and swaps its table into
the MoE layers when the arch's dispatch consumes table rows (e.g.
``phase_pipelined``); each round then runs ``prefill`` over ``[B, S]``
prompts and ``new_tokens`` greedy ``decode_step``s under that table.  A
swap refills the same device tensors unless the phase envelope grows or
shrinks (``table_rebuilds``).  The estimate for round ``r`` is
``tokens * scenario.expert_probs(r)`` broadcast to ``[L, 1, E]`` with
``tokens = batch * prompt_len * top_k``, as the JAX launcher feeds its
controller (an estimate, not realized routing).  An arch without MoE
(``rwkv6-7b`` and the dense configs) plans no table: the controller is
disabled, as the JAX launcher's is, and the MoE counts stay 0; the hybrid
(``jamba-1.5-large-398b``) plans one row per MoE layer.  An arch with a
modality frontend gets ``frontend_tokens`` precomputed embeddings a
prompt, N(0, 1) from the round's generator, prepended to its tokens.

Across ranks (``torchrun --nproc-per-node 4 -m repro_torch.launch.serve
...``, or a world ``parallel.sharding.spawn_world`` starts) the launcher
builds the (data, model) world from ``WORLD_SIZE``, each rank holding
its model group slice of the experts (``Model(expert_shard=)``), and
serves under it: the controller plans over the model group's ``n``
ranks, its table rows go into the table fabrics, ``ppermute`` gets one
uniform static plan baked for the run (as JAX's launcher bakes it), and
each data group serves its slice of the batch.  Every rank runs the same
deterministic host controller on the same estimate; the tables are held
equal across ranks once a round (a difference raises).  Prefill takes
the fabric; decode (S = 1) takes the dense fabric's EP form.  A config
with ``expert_2d`` is refused across several data groups: training runs
2D expert sharding, serving does not yet (``ROADMAP.md`` §1).
Counterpart of ``repro/launch/serve.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import decompose, plan_schedule
from repro_torch.core.drift import DRIFT_KINDS, DriftScenario
from repro_torch.core.runtime import Decision, make_serving_controller
from repro_torch.core.schedule import TABLE_LEAVES
from repro_torch.models import Model
from repro_torch.parallel.fabric import consumes_schedule, consumes_table
from repro_torch.parallel.sharding import close_world, ep_world, init_world

__all__ = ["ServeResult", "serve", "controller_line", "demand_estimate", "uniform_estimate", "main"]

log = logging.getLogger("repro_torch.launch.serve")


@dataclasses.dataclass
class ServeResult:
    prefill_ms: list[float]
    decode_ms: list[float]
    plan_ms: list[float]
    tokens: torch.Tensor  # [rounds, B, new_tokens] generated ids (host)
    first_logits: torch.Tensor  # round 0 prefill last-token logits [B, V] (host)
    admitted: float  # plan-admitted expert choices over all layers and steps (0 without MoE)
    dropped: float  # of those, cut at packing (capacity overflow)
    routed: float  # all expert choices (pre-drop demand)
    moe_by_round: list[tuple[float, float, float]]  # (admitted, dropped, routed) of each round
    table: object  # the last round's ScheduleTable, a copy on the device (None without a controller or MoE)
    decisions: list[Decision]  # each round's controller decision (empty without a controller)
    tables: list  # each round's ScheduleTable, a host copy (empty without a controller)
    controller: list[dict]  # the runtime's metrics() after each round's observe (empty without a controller)
    prompts: list  # each round's prompts [B, S] (host), the whole batch across data groups

    def decode_tok_s(self, batch: int, new_tokens: int) -> list[float]:
        return [batch * new_tokens / (ms / 1e3) for ms in self.decode_ms]


def uniform_estimate(cfg, tokens: float) -> np.ndarray:
    """Routing-count estimate ``[n_moe_layers, 1, E]``: ``tokens`` routed
    choices spread evenly over the experts."""
    m = cfg.moe
    return np.full((cfg.n_moe_layers, 1, m.n_experts), tokens / m.n_experts, np.float32)


def demand_estimate(cfg, tokens: float, scenario: DriftScenario, r: int) -> np.ndarray:
    """Round ``r``'s routing-count estimate ``[n_moe_layers, 1, E]``:
    ``tokens`` routed choices spread by the scenario's expert popularity."""
    probs = scenario.expert_probs(r)[None, None, :]
    return np.broadcast_to(tokens * probs, (cfg.n_moe_layers, 1, cfg.moe.n_experts))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def static_plan(cfg, n_ranks: int, tokens: float):
    """The uniform static plan a fabric that cannot swap plans runs
    (``ppermute``): ``tokens`` choices spread evenly over the pairs,
    decomposed by the config's strategy, 1.5x slack (JAX's launcher)."""
    uniform = np.full((n_ranks, n_ranks), tokens / n_ranks**2)
    return plan_schedule(decompose(uniform, cfg.moe.schedule_strategy), slack=1.5)


def check_same_table(table, world) -> None:
    """Raise unless every rank of the world holds this table's leaves."""
    mine = torch.cat([getattr(table, name).reshape(-1).long().cpu() for name in TABLE_LEAVES])
    if world.backend == "nccl":  # NCCL moves device tensors only
        mine = mine.to(world.device)
    every = [torch.empty_like(mine) for _ in range(world.size)]
    torch.distributed.all_gather(every, mine)
    bad = [r for r, t in enumerate(every) if not torch.equal(t, mine)]
    if bad:
        raise RuntimeError(f"rank {world.rank}: ranks {bad} hold another schedule table")


def _gather_data(t: torch.Tensor, world) -> torch.Tensor:
    """The data groups' row slices of ``t`` (dim 0) joined back, in order."""
    if world is None or world.n_data == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world.n_data)]
    torch.distributed.all_gather(parts, t.contiguous(), group=world.data_group)
    return torch.cat(parts)


def serve(
    model: Model,
    *,
    batch: int,
    prompt_len: int,
    new_tokens: int,
    rounds: int = 1,
    controller: bool = True,
    virtual_ranks: int = 8,
    drift: str = "none",
    seed: int = 0,
    world=None,
) -> ServeResult:
    """Serve ``rounds`` batches of random prompts (made from ``seed``),
    re-planning between rounds under the ``drift`` scenario.  With
    ``world`` (``parallel.sharding.World``) every rank of it calls this:
    the controller plans over the model group's ranks instead of
    ``virtual_ranks``.  A config with ``expert_2d`` is not served across
    several data groups yet (``NotImplementedError``)."""
    if world is not None and world.two_d(model.cfg):
        raise NotImplementedError(
            "serving under expert_2d across several data groups (its decode on the dense EP form, each data "
            "group's batch slice) is not ported yet: ROADMAP.md §1")
    with ep_world(world):
        return _serve(model, batch=batch, prompt_len=prompt_len, new_tokens=new_tokens, rounds=rounds,
                      controller=controller, n_ranks=virtual_ranks if world is None else world.n, drift=drift,
                      seed=seed, world=world)


def _serve(model, *, batch, prompt_len, new_tokens, rounds, controller, n_ranks, drift, seed, world) -> ServeResult:
    cfg, device = model.cfg, model.device
    runtime = scenario = None
    if controller:
        runtime, scenario = make_serving_controller(cfg, n_ranks=n_ranks, drift=drift, rounds=rounds, device=device)
        if runtime is None:
            log.info("controller disabled: arch %s has no MoE whose experts tile %d ranks", cfg.name, n_ranks)
    use_table = runtime is not None and consumes_table(cfg.moe.dispatch)
    static = None
    if (world is not None and cfg.moe is not None and consumes_schedule(cfg.moe.dispatch)
            and not consumes_table(cfg.moe.dispatch)):
        # a fabric that cannot swap plans (ppermute) gets one uniform plan for the run
        static = static_plan(cfg, world.n, float(batch * prompt_len * cfg.moe.top_k))
        log.info("baked a static %s plan (%d ranks): %s cannot swap plans at runtime",
                 cfg.moe.schedule_strategy, world.n, cfg.moe.dispatch)
    n_data, data_index = (1, 0) if world is None else (world.n_data, world.data_index)
    if batch % n_data:
        raise ValueError(f"batch {batch} does not split over {n_data} data groups")
    rows = slice(data_index * batch // n_data, (data_index + 1) * batch // n_data)
    prefill_ms, decode_ms, plan_ms, tokens, decisions, tables, metrics, moe_by_round = [], [], [], [], [], [], [], []
    all_prompts = []
    first_logits = table = None
    for r in range(rounds):
        t0 = time.perf_counter()
        if runtime is not None:
            est = demand_estimate(cfg, float(batch * prompt_len * cfg.moe.top_k), scenario, r)
            decision = runtime.observe(est)
            if decision.changed:
                log.info("round %d: controller swap (%s)", r, "library miss" if decision.replanned else "library hit")
            table = runtime.table()  # the same tensors as last round unless the envelope changed
            if world is not None:
                check_same_table(table, world)
            decisions.append(decision)
            tables.append(table.clone("cpu"))
            metrics.append(runtime.metrics())
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        schedule = table if use_table else static
        gen = torch.Generator(device=device).manual_seed(seed + r)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=device)
        prefix = cfg.frontend_tokens if cfg.frontend != "none" else 0
        ext = None if not prefix else torch.randn(
            (batch, prefix, cfg.d_model), generator=gen, device=device).to(model.dtype)[rows]
        all_prompts.append(prompts.cpu())
        prompts = prompts[rows]
        caches = model.init_cache(prompts.shape[0], prefix + prompt_len + new_tokens)
        _sync(device)
        t0 = time.perf_counter()
        logits, caches, stats = model.prefill(prompts, caches, ext, schedule=schedule, collect_stats=True)
        _sync(device)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        step_stats = [stats]
        if r == 0:
            first_logits = _gather_data(logits, world).cpu()
        token = torch.argmax(logits, dim=-1)
        out = []
        t0 = time.perf_counter()
        for i in range(new_tokens):
            logits, caches, stats = model.decode_step(
                token, caches, prefix + prompt_len + i, schedule=schedule, collect_stats=True
            )
            token = torch.argmax(logits, dim=-1)
            out.append(token)
            step_stats.append(stats)
        _sync(device)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(_gather_data(torch.stack(out, dim=1), world).cpu())
        totals = torch.zeros(3, dtype=torch.float64, device=device)  # admitted, dropped, routed
        for st in step_stats:
            if st is None:  # no MoE layer
                continue
            totals += torch.stack(
                [st["admitted"].sum(), st["dropped"].sum(), st["routing"].sum()]
            ).double()
        moe_by_round.append(tuple(float(v) for v in totals.cpu()))
        log.info(
            "round %d: plan %.1f ms | prefill %.1f ms (%.0f tok/s) | decode %.1f ms (%.0f tok/s)",
            r, plan_ms[-1], prefill_ms[-1], batch * prompt_len / (prefill_ms[-1] / 1e3),
            decode_ms[-1], batch * new_tokens / (decode_ms[-1] / 1e3),
        )
    if runtime is not None:
        log.info(controller_line(runtime.summary()))
    admitted, dropped, routed = (sum(v) for v in zip(*moe_by_round))
    return ServeResult(
        prefill_ms=prefill_ms, decode_ms=decode_ms, plan_ms=plan_ms,
        tokens=torch.stack(tokens), first_logits=first_logits,
        admitted=admitted, dropped=dropped, routed=routed, moe_by_round=moe_by_round,
        table=None if table is None else table.clone(), decisions=decisions, tables=tables, controller=metrics,
        prompts=all_prompts,
    )


def controller_line(summary: dict) -> str:
    """The closing ``controller:`` log line of a serve run."""
    return (
        f"controller: {summary['replan_events']} re-plan events, {summary['warm_hits']} warm / "
        f"{summary['cold_plans']} cold plans, {summary['table_rebuilds']} table rebuilds, "
        f"observe {summary['observe_us_per_step']:.0f}us/round"
    )


def main(argv=None) -> ServeResult:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=2, help="request batches")
    ap.add_argument("--controller", action="store_true", help="re-plan MoE schedules between rounds")
    ap.add_argument("--drift", default="shift", choices=DRIFT_KINDS,
                    help="demand drift across rounds (with --controller)")
    ap.add_argument("--virtual-ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    kw = dict(batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens, rounds=args.rounds,
              controller=args.controller, virtual_ranks=args.virtual_ranks, drift=args.drift)
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return serve(Model(cfg, device=args.device, seed=0), **kw)
    world = init_world(args.device)
    try:
        if world.rank:
            logging.getLogger().setLevel(logging.WARNING)  # rank 0 logs the run
        model = Model(cfg, device=world.device, seed=0, expert_shard=(world.me, world.n))
        return serve(model, **kw, world=world)
    finally:
        close_world()


if __name__ == "__main__":
    main()

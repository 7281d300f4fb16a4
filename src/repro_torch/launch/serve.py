"""Batched serving entry point: plan a schedule, prefill, greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --smoke --batch 4 --prompt-len 64 --new-tokens 16 --controller

Each round plans one ``ScheduleTable`` from the round's demand estimate
(``--controller``; the table reaches the MoE layers when the arch's
dispatch consumes table rows, e.g. ``phase_pipelined``), runs
``prefill`` over ``[B, S]`` prompts and then ``new_tokens`` greedy
``decode_step``s with that table.  The estimate for round ``r`` is
``tokens * DriftScenario(drift).expert_probs(r)`` broadcast to
``[L, 1, E]`` with ``tokens = batch * prompt_len * top_k``, as the JAX
launcher feeds its controller.  An arch without MoE (``rwkv6-7b``) plans
no table: the controller is disabled, as the JAX launcher's is, and the
MoE counts stay 0.  Counterpart of ``repro/launch/serve.py``;
the controller's EMA and re-planning between rounds come with the
host-controller slice, so only ``--drift none`` runs here.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.drift import DriftScenario
from repro_torch.core.runtime import plan_serving_table
from repro_torch.models import Model
from repro_torch.parallel.fabric import TABLE_FABRICS

__all__ = ["ServeResult", "serve", "demand_estimate", "uniform_estimate", "main"]

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
    table: object  # the last round's ScheduleTable (None without a controller or MoE)

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


def serve(
    model: Model,
    *,
    batch: int,
    prompt_len: int,
    new_tokens: int,
    rounds: int = 1,
    controller: bool = True,
    virtual_ranks: int = 8,
    seed: int = 0,
) -> ServeResult:
    """Serve ``rounds`` batches of random prompts (made from ``seed``)."""
    cfg, device = model.cfg, model.device
    if controller and cfg.moe is None:
        log.info("controller disabled: arch %s has no MoE", cfg.name)
        controller = False
    use_table = controller and cfg.moe.dispatch in TABLE_FABRICS
    prefill_ms, decode_ms, plan_ms, tokens = [], [], [], []
    first_logits = table = None
    if controller:
        half = max(rounds // 2, 1)  # the JAX serving controller's scenario settings
        scenario = DriftScenario("none", cfg.moe.n_experts, shift_step=half, window=half, seed=0)
    totals = torch.zeros(3, dtype=torch.float64, device=device)  # admitted, dropped, routed
    for r in range(rounds):
        t0 = time.perf_counter()
        table = None
        if controller:
            est = demand_estimate(cfg, float(batch * prompt_len * cfg.moe.top_k), scenario, r)
            table = plan_serving_table(
                est, n_ranks=virtual_ranks, n_experts=cfg.moe.n_experts,
                strategy=cfg.moe.schedule_strategy, device=device,
            )
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        schedule = table if use_table else None
        gen = torch.Generator(device=device).manual_seed(seed + r)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=device)
        caches = model.init_cache(batch, prompt_len + new_tokens)
        _sync(device)
        t0 = time.perf_counter()
        logits, caches, stats = model.prefill(prompts, caches, schedule=schedule, collect_stats=True)
        _sync(device)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        step_stats = [stats]
        if r == 0:
            first_logits = logits.cpu()
        token = torch.argmax(logits, dim=-1)
        out = []
        t0 = time.perf_counter()
        for i in range(new_tokens):
            logits, caches, stats = model.decode_step(
                token, caches, prompt_len + i, schedule=schedule, collect_stats=True
            )
            token = torch.argmax(logits, dim=-1)
            out.append(token)
            step_stats.append(stats)
        _sync(device)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(torch.stack(out, dim=1).cpu())
        for st in step_stats:
            if st is None:  # no MoE layer
                continue
            totals += torch.stack(
                [st["admitted"].sum(), st["dropped"].sum(), st["routing"].sum()]
            ).double()
        log.info(
            "round %d: plan %.1f ms | prefill %.1f ms (%.0f tok/s) | decode %.1f ms (%.0f tok/s)",
            r, plan_ms[-1], prefill_ms[-1], batch * prompt_len / (prefill_ms[-1] / 1e3),
            decode_ms[-1], batch * new_tokens / (decode_ms[-1] / 1e3),
        )
    admitted, dropped, routed = (float(v) for v in totals.cpu())
    return ServeResult(
        prefill_ms=prefill_ms, decode_ms=decode_ms, plan_ms=plan_ms,
        tokens=torch.stack(tokens), first_logits=first_logits,
        admitted=admitted, dropped=dropped, routed=routed, table=table,
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
    ap.add_argument("--controller", action="store_true", help="plan MoE schedules per round")
    ap.add_argument("--drift", default="none", choices=("none", "shift", "hotspot", "skew"))
    ap.add_argument("--virtual-ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    if args.drift != "none":
        raise NotImplementedError(
            f"--drift {args.drift}: drift scenarios come with the host controller (ROADMAP M6)"
        )
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device, seed=0)
    return serve(
        model, batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        rounds=args.rounds, controller=args.controller, virtual_ranks=args.virtual_ranks,
    )


if __name__ == "__main__":
    main()

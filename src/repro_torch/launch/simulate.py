"""The paper's compute knee measured on the kernel the port runs, and the
paper's Fig. 3/4 makespan tables on that measured compute model.

    PYTHONPATH=src python -m repro_torch.launch.simulate
    PYTHONPATH=src python -m repro_torch.launch.simulate --routers mixtral-8x7b --device cpu --smoke

``profile_knee`` times K1 (``kernels/moe_gemm``, ``moe_gemm``) for one
virtual rank of a router at its full width: the rank's experts
(``n_experts // N_RANKS``) with ``b`` live rows spread over them round
robin, ``C`` rounded up to whole ``ROW_TILE`` tiles.  Per ``b`` it takes
two times: the device time (after a warm-up, ``reps`` calls captured as
one CUDA graph and replayed between CUDA events, so the host's launch
cost does not pace the kernels: at small ``b`` a K1 call takes less time
on the card than on the host; the calls rotate over ``COPIES`` copies of
the rank's weights so that weights which fit the card's 50 MB L2 are not
read warm), and the per-call time (host clock around one call and a
synchronize, the median: the host's launch cost is in it, as it is in the
paper's profiled floor).  ``fit_knee`` fits each curve.  On a CPU device
the plain version runs and both times are host times.

``paper_tables`` is ``benchmarks/fig3_small_batch.py``'s ``makespans``:
the mean MoE-layer makespan of the static-ring all-to-all, the ideal
all-to-all, and BvN and max-weight with and without overlap, over a
synthetic trace.  The communication model stays the paper's (400 Gb/s
circuits, 10 ns reconfiguration): the card has no optical fabric, so only
the compute model is the card's.  Counterpart of
``benchmarks/fig1_compute_knee.py`` (which profiles a CPU matmul) and of
``examples/simulate_paper.py``'s ``figures_3_and_4``.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch.core.cost_models import CommModel, ComputeModel, fit_knee, knee_model
from repro_torch.core.decompose import decompose
from repro_torch.core.simulator import simulate_decomposition, simulate_ideal, simulate_sequential
from repro_torch.core.traffic import ROUTERS, RouterConfig, gen_trace
from repro_torch.kernels.moe_gemm import ops as k1
from repro_torch.models.layers import resolve_device

__all__ = ["KNEE_BATCHES", "KneeProfile", "rank_weights", "rank_batch", "profile_knee", "paper_tables", "headline", "main"]

# benchmarks/fig1_compute_knee.py's axis, and the ~16k tokens a rank receives under the speed workload
KNEE_BATCHES = (1, 4, 16, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
N_RANKS = 8  # the paper's fabric: 8 ranks
REPS, COPIES, WARMUP = 20, 4, 2  # timed calls a point, weight copies they rotate over, untimed calls first
WEIGHT_SEED, BATCH_SEED, TRACE_SEED, ITERATIONS = 0, 1, 0, 24
LINK_GBPS, RECONF_US = 400.0, 0.01  # the paper's circuits (benchmarks/common.py)
STRATS = ("bvn", "maxweight")


@dataclasses.dataclass
class KneeProfile:
    """One router's K1 profile on one virtual rank (times in µs)."""

    router: str
    experts: int  # experts on the rank
    batches: list[int]
    device_us: list[float]  # per launch, CUDA events around a graph replay of back-to-back launches
    call_us: list[float]  # per call with a synchronize after it, median
    device_fit: ComputeModel
    call_fit: ComputeModel
    device: str


def _router(router: RouterConfig | str) -> RouterConfig:
    return ROUTERS[router] if isinstance(router, str) else router


def rank_weights(router: RouterConfig | str, *, device, copies: int = 1):
    """``copies`` seeded bf16 copies of one rank's expert weights,
    ``(w_gate [E, d, F], w_up [E, d, F], w_down [E, F, d])`` each, drawn
    as the model draws them (``N(0, 1)·d^-0.5`` and ``·F^-0.5``)."""
    r = _router(router)
    e, d, f = r.experts_per_rank(N_RANKS), r.d_model, r.d_ff
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)

    def draw(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    return [(draw((e, d, f), d**-0.5), draw((e, d, f), d**-0.5), draw((e, f, d), f**-0.5)) for _ in range(copies)]


def rank_batch(router: RouterConfig | str, b: int, *, device):
    """``b`` live rows on one rank's experts, round robin: ``x`` [E, C, d]
    bf16 (seeded N(0, 1)) and ``row_valid`` [E, C], ``C`` the busiest
    expert's rows rounded up to whole ``ROW_TILE`` tiles."""
    r = _router(router)
    e = r.experts_per_rank(N_RANKS)
    rows = [b // e + (i < b % e) for i in range(e)]
    c = -(-max(rows) // k1.ROW_TILE) * k1.ROW_TILE
    gen = torch.Generator(device=device).manual_seed(BATCH_SEED)
    x = torch.randn((e, c, r.d_model), generator=gen, device=device).to(torch.bfloat16)
    row_valid = torch.arange(c, device=device)[None, :] < torch.tensor(rows, device=device)[:, None]
    return x, row_valid


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_us(fn, device: torch.device, reps: int) -> float:
    """Mean µs a call over ``reps`` back-to-back calls: on the card the
    calls captured as one CUDA graph, timed with CUDA events around a
    replay after an untimed one; on a CPU the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        return (time.perf_counter() - t0) / reps * 1e6
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def _call_us(fn, device: torch.device, reps: int) -> float:
    """Median µs of one call followed by a synchronize."""
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


@torch.no_grad()
def profile_knee(router: RouterConfig | str, batches=KNEE_BATCHES, *, device=None, reps: int = REPS) -> KneeProfile:
    """K1's device and per-call time against the tokens ``b`` on one
    virtual rank of ``router`` (module doc), each fitted with ``fit_knee``."""
    r = _router(router)
    dev = resolve_device(device)
    weights = rank_weights(r, device=dev, copies=COPIES)
    device_us, call_us = [], []
    for b in batches:
        x, row_valid = rank_batch(r, b, device=dev)

        def call(i):
            return k1.moe_gemm(x, *weights[i % len(weights)], row_valid)

        for i in range(WARMUP):
            call(i)
        _sync(dev)
        device_us.append(_device_us(call, dev, reps))
        call_us.append(_call_us(call, dev, reps))
        del x, row_valid
    return KneeProfile(
        router=r.name, experts=r.experts_per_rank(N_RANKS), batches=list(batches), device_us=device_us,
        call_us=call_us, device_fit=fit_knee(np.array(batches), np.array(device_us)),
        call_fit=fit_knee(np.array(batches), np.array(call_us)), device=str(dev),
    )


def paper_tables(
    router_name: str, compute: ComputeModel, workload: str = "mmlu", iterations: int = ITERATIONS,
) -> dict[str, float]:
    """Mean MoE-layer makespan (µs) per strategy over ``gen_trace(router_name,
    workload, seed=TRACE_SEED)``: ``ring-seq``, ``ideal``, ``bvn``,
    ``bvn+ovl``, ``maxweight``, ``maxweight+ovl``, on the paper's circuits
    at the router's width."""
    comm = CommModel.from_hardware(link_gbps=LINK_GBPS, d_model=ROUTERS[router_name].d_model, reconf_us=RECONF_US)
    rows: dict[str, list[float]] = {}

    def add(key, val):
        rows.setdefault(key, []).append(val)

    for m in gen_trace(router_name, workload, iterations=iterations, seed=TRACE_SEED):
        add("ring-seq", simulate_sequential(m, compute, comm).makespan_us)
        add("ideal", simulate_ideal(m, compute, comm).makespan_us)
        for strat in STRATS:
            d = decompose(m, strat)
            local = d.meta["local_tokens"]
            for ovl in (True, False):
                r = simulate_decomposition(d, compute, comm, overlap=ovl, local_tokens=local)
                add(f"{strat}{'+ovl' if ovl else ''}", r.makespan_us)
    return {k: float(np.mean(v)) for k, v in rows.items()}


def headline(res: dict[str, float]) -> dict[str, float]:
    """fig3's two ratios: max-weight + overlap over the ideal all-to-all,
    and BvN + overlap over the static ring."""
    return {"mw_vs_ideal": res["maxweight+ovl"] / res["ideal"], "bvn_ovl_vs_ring": res["bvn+ovl"] / res["ring-seq"]}


def knee_lines(p: KneeProfile) -> list[str]:
    """The profile as printable lines: one per ``b``, then the two fits
    beside the paper's model."""
    paper = knee_model()
    out = [f"knee {p.router} b={b}: device {dev:.2f} us, per call {call:.2f} us ({p.experts} experts a rank, {p.device})"
           for b, dev, call in zip(p.batches, p.device_us, p.call_us)]
    for what, fit in (("device time", p.device_fit), ("per-call time", p.call_fit)):
        out.append(f"knee {p.router} fit ({what}): floor {fit.floor_us:.2f} us, slope {fit.per_token_us:.5f} us/token, "
                   f"knee at {fit.floor_us / fit.per_token_us:.0f} tokens | paper: floor {paper.floor_us:.0f} us, "
                   f"slope {paper.per_token_us:.5f} us/token (knee 256)")
    return out


def table_lines(router_name: str, models: dict[str, ComputeModel], *, iterations: int = ITERATIONS) -> list[str]:
    """Fig. 3 (``mmlu``) and Fig. 4 (``speed``) under each compute model."""
    out = []
    for workload, fig in (("mmlu", "Fig. 3"), ("speed", "Fig. 4")):
        for label, model in models.items():
            res = paper_tables(router_name, model, workload=workload, iterations=iterations)
            ratios = headline(res)
            out.append(f"{fig} ({workload}) {router_name} under {label}: " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(res.items())) + " us | " + ", ".join(
                f"{k} {v:.3f}" for k, v in ratios.items()) + f" | maxweight+ovl beats bvn+ovl: "
                f"{res['maxweight+ovl'] < res['bvn+ovl']}")
    return out


def main(argv=None) -> list[KneeProfile]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--routers", default="mixtral-8x7b,dbrx,qwen3-moe", help="comma-separated ROUTERS names")
    ap.add_argument("--device", default="cuda", help="'cpu' times the plain version on the host")
    ap.add_argument("--smoke", action="store_true",
                    help="narrow widths (d = F = 128), b up to 256, 2 timed calls a point and 2 trace iterations")
    args = ap.parse_args(argv)
    reps, iterations = (2, 2) if args.smoke else (REPS, ITERATIONS)
    profiles = []
    for name in args.routers.split(","):
        router, batches = ROUTERS[name], KNEE_BATCHES
        if args.smoke:
            router, batches = dataclasses.replace(router, d_model=128, d_ff=128), KNEE_BATCHES[:6]
        p = profile_knee(router, batches, device=args.device, reps=reps)
        print("\n".join(knee_lines(p)))
        models = {"the measured device-time knee": p.device_fit, "the paper's knee_model()": knee_model()}
        print("\n".join(table_lines(name, models, iterations=iterations)))
        profiles.append(p)
    return profiles


if __name__ == "__main__":
    main()

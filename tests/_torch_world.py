"""Rank-side bodies of the multi-rank tests (``test_torch_fabric_world.py``,
``test_torch_serve_world.py``, ``test_torch_fabric_world_cuda.py``,
``test_torch_train_world.py``).

The ranks are spawned processes that import this module, so it imports
torch, numpy and ``repro_torch`` only, never JAX; the pytest parent
computes the JAX side.  Each body takes the rank's ``World`` and a spec
of numpy arrays and plans, and returns numpy results.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ModelConfig, MoECfg
from repro_torch.core.hierarchical import hierarchical_decompose, hierarchical_plan
from repro_torch.core.schedule import ScheduleTable, plan_schedule
from repro_torch.kernels.moe_gemm import ops as k1
from repro_torch.models import moe as pmoe
from repro_torch.parallel import collectives as col
from repro_torch.parallel.fabric import FabricContext, get_fabric, wrap_faulty
from repro_torch.parallel.sharding import ep_world

N_RANKS = 4
K1_COUNTERS = {"k1": k1.moe_gemm, "k2": k1.moe_gemm_dgrad, "k3": k1.moe_gemm_wgrad}


def layer_cfg(dispatch: str = "dense", capacity_factor: float = 8.0) -> ModelConfig:
    """The smoke layer of JAX's cross-fabric parity matrix
    (``tests/multidev_fabric.py``): d 32, 8 experts of 48, top-2."""
    return ModelConfig(
        name=f"fabric-{dispatch}", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=97,
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=48, capacity_factor=capacity_factor, dispatch=dispatch),
    )


def mixtral_layer_cfg(dispatch: str) -> ModelConfig:
    """The smoke Mixtral's MoE layer (its tight capacity factor 1.25)."""
    cfg = smoke_config("mixtral-8x7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))


def with_dispatch(cfg: ModelConfig, dispatch: str) -> ModelConfig:
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))


def build_table(plan, envelope, device="cpu") -> ScheduleTable:
    """A one-layer table of ``plan`` (``envelope`` "auto", None or explicit)."""
    return ScheduleTable.from_schedules([plan], k_max=N_RANKS, clip=True, envelope=envelope, device=device)


def build_hierarchical(traffic, pod_size: int, device="cpu"):
    """The one-layer two-level table of ``traffic`` (``tests/multidev_fabric.py``'s knobs)."""
    return hierarchical_plan(traffic, pod_size, n_layers=1, slack=1.5, quantum=8, device=device)


def build_schedule(spec, device="cpu"):
    """A case's schedule: None, an ``A2ASchedule`` (taken as it is),
    ``("row", plan, envelope)``, the row of a one-layer table, or
    ``("hrow", traffic, pod_size)``, the row of a two-level table."""
    if isinstance(spec, tuple) and spec[0] == "row":
        return build_table(spec[1], spec[2], device).row(0)
    if isinstance(spec, tuple) and spec[0] == "hrow":
        return build_hierarchical(spec[1], spec[2], device).row(0)
    return spec


def load_layer(cfg: ModelConfig, params: dict, world, *, device="cpu", dtype=torch.float32) -> pmoe.MoE:
    """An MoE layer holding the rank's slice of the experts of ``params``
    (numpy: router [d, E], w_gate / w_up [E, d, F], w_down [E, F, d])."""
    lo, hi = world.expert_range(cfg.moe.n_experts)
    p = pmoe.moe_init(cfg, gen=None, device=device, dtype=dtype, experts=(lo, hi))
    p.router.data.copy_(torch.from_numpy(params["router"]))
    for name in ("w_gate", "w_up", "w_down"):
        getattr(p, name).data.copy_(torch.from_numpy(params[name][lo:hi]).to(dtype))
    return p


def loss_weight(world) -> float:
    """This rank's share of the loss: unequal shares summing to 1, so the
    gradients' sum over ranks is the one-device gradient and a wrong
    all-gather backward shows; powers of two (1/2, 1/4, ..., the last two
    alike), so a bf16 cotangent's share is exact."""
    return 2.0 ** -min(world.me + 1, world.n - 1)


def run_layer(p, cfg, x, schedule, world, *, grad: bool = True) -> dict:
    """One layer call under ``world``, forward and (with ``grad``) the
    backward of ``loss_weight * sum(y**2)``: y, the rank's partial dx and
    router gradient, its experts' gradients, the stats, the token slots it
    sent, and K1/K2/K3 launches."""
    x = x.detach().clone().requires_grad_(grad)
    for name in ("router", "w_gate", "w_up", "w_down"):
        getattr(p, name).requires_grad_(grad)
        getattr(p, name).grad = None
    for fn in K1_COUNTERS.values():
        fn.launches = 0
    col.SLOTS_SENT[0] = 0
    pmoe.PATH_CALLS.clear()
    with ep_world(world):
        y, stats = pmoe.moe_apply(p, cfg, x, schedule=schedule, return_stats=True)
        slots = col.SLOTS_SENT[0]
        if grad:
            share = 1.0 if world is None else loss_weight(world)
            (share * (y.float() ** 2).sum()).backward()
    out = {
        "y": y.detach().float().cpu().numpy(), "slots": slots, "paths": dict(pmoe.PATH_CALLS),
        **{k: v.detach().cpu().numpy() for k, v in stats.items()},
        "launches": {k: fn.launches for k, fn in K1_COUNTERS.items()},
    }
    if grad:
        out["dx"] = x.grad.float().cpu().numpy()
        for name in ("router", "w_gate", "w_up", "w_down"):
            out[name] = getattr(p, name).grad.float().cpu().numpy()
    return out


def _pack(world, cfg, p, x, fabric_name, schedule) -> dict:
    """One rank's pack of its chunk (the dense fabric: of every token)."""
    fabric = get_fabric(fabric_name)
    n, me = world.n, world.me
    b, s, d = x.shape
    dense = fabric_name == "dense"
    x_loc = x.reshape(b * s, d) if dense else x[:, me * (s // n):(me + 1) * (s // n)].reshape(-1, d)
    ctx = FabricContext(cfg=cfg, schedule=schedule, n=n, e_local=cfg.moe.n_experts // n, me=me, world=world)
    idx, gates = pmoe._router(p, cfg, x_loc)
    packed = fabric.pack(ctx, x_loc, idx, gates)
    out = {"x_loc": x_loc.numpy(), "idx": idx.numpy(), "gates": gates.detach().numpy()}
    for key in ("buf", "pos", "gate", "live", "admitted", "wire"):
        out[key] = getattr(packed, key).detach().numpy()
    return out


def fabric_world(world, spec: dict) -> dict:
    """Every case of ``spec["cases"]`` (name -> (dispatch, schedule spec)),
    the faulty wrapper's cases, the swap of a re-planned row and the
    per-rank packs at the smoke Mixtral's tight capacity."""
    torch.manual_seed(0)
    x = torch.from_numpy(spec["x"])
    out = {}
    for case, (dispatch, sched_spec, *moe_kw) in spec["cases"].items():
        cfg = layer_cfg(dispatch)
        if moe_kw:  # pod_size, wire_dtype
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw[0]))
        p = load_layer(cfg, spec["params"], world)
        out[case] = run_layer(p, cfg, x, build_schedule(sched_spec), world)

    # the two-level table's swaps: an intra-only re-plan, then both levels, refilled in place between calls
    traffic = spec["hier_traffic"]
    table = build_hierarchical(traffic, 2)
    cfg = layer_cfg("hierarchical")
    p = load_layer(cfg, spec["params"], world)
    ptrs = (table.intra.perms.data_ptr(), table.inter.perms.data_ptr())
    calls = [run_layer(p, cfg, x, table.row(0), world)]
    i_d, e_d = hierarchical_decompose(traffic * 0.7, 2)
    table.intra.fill_([plan_schedule(i_d, slack=1.5, quantum=8)])
    calls.append(run_layer(p, cfg, x, table.row(0), world))
    table.inter.fill_([plan_schedule(e_d, slack=1.5, quantum=8)])
    calls.append(run_layer(p, cfg, x, table.row(0), world))
    out["hier_swaps"] = {"calls": calls, "same_storage": (table.intra.perms.data_ptr(),
                                                          table.inter.perms.data_ptr()) == ptrs}

    # the fault-injection wrapper: a dead link the plan avoids runs; one it routes is refused
    for case, (scenario, row_spec) in spec["faulty"].items():
        name = wrap_faulty("phase_pipelined", scenario)
        try:
            cfg = layer_cfg(name)
            p = load_layer(cfg, spec["params"], world)
            try:
                out[case] = run_layer(p, cfg, x, build_schedule(row_spec), world)
            except Exception as e:  # noqa: BLE001 - the refusal is the result
                out[case] = {"error": type(e).__name__, "message": str(e),
                             **{k: getattr(e, k, None) for k in ("backend", "pair", "phase", "next_fabric")}}
        finally:
            from repro_torch.parallel.fabric import FABRICS

            FABRICS.pop(name, None)

    # a re-planned row swapped into the same table between calls: nothing rebuilt
    for fabric in ("phase_pipelined", "ragged_a2a"):
        plan_a, plan_b, envelope = spec["swap"]
        table = build_table(plan_a, envelope)
        cfg = layer_cfg(fabric)
        p = load_layer(cfg, spec["params"], world)
        ptr = table.perms.data_ptr()
        first = run_layer(p, cfg, x, table.row(0), world)
        table.fill_([plan_b])
        second = run_layer(p, cfg, x, table.row(0), world)
        out[f"swap_{fabric}"] = {
            "first": first, "second": second, "same_storage": table.perms.data_ptr() == ptr,
            "envelope": table.envelope, "perms": table.perms.numpy(), "caps": table.caps.numpy(),
            "pack": _pack(world, cfg, p, x, fabric, table.row(0)),
        }

    # a module holding every expert is refused under the world (a rank holds its slice only)
    cfg = layer_cfg("a2a")
    every = pmoe.moe_init(cfg, gen=None, device="cpu", dtype=torch.float32)
    try:
        with torch.no_grad(), ep_world(world):
            pmoe.moe_apply(every, cfg, x)
        out["all_experts"] = None
    except ValueError as e:
        out["all_experts"] = str(e)

    # each rank's pack at the smoke Mixtral's tight capacity
    xm = torch.from_numpy(spec["pack_x"])
    packs = {}
    for fabric, sched_spec in spec["packs"].items():
        cfg = mixtral_layer_cfg(fabric)
        p = load_layer(cfg, spec["pack_params"], world)
        packs[fabric] = _pack(world, cfg, p, xm, fabric, build_schedule(sched_spec))
    out["packs"] = packs
    return out


def serve_world(world, spec: dict) -> dict:
    """The launcher's ``serve`` across the world: the smoke Mixtral (the
    JAX parameters ``spec["params"]``, this rank's experts) at f32, under
    ``spec["cfg"]``'s dispatch and then under ``ppermute`` (the launcher's
    baked uniform plan); the parameters gathered back by ``to_reference``."""
    from repro_torch.launch.serve import serve
    from repro_torch.models.transplant import load_reference, to_reference

    cfg = spec["cfg"]
    model = load_reference(cfg, spec["params"], device=spec.get("device", "cpu"), dtype=torch.float32,
                           rank=world.me, n_model=world.n)
    gathered = to_reference(model, world=world)
    pmoe.PATH_CALLS.clear()
    model.cfg = with_dispatch(cfg, "ppermute")
    static = serve(model, world=world, **spec["serve"])
    static_paths = dict(pmoe.PATH_CALLS)
    model.cfg = cfg
    pmoe.PATH_CALLS.clear()
    res = serve(model, world=world, **spec["serve"])
    from repro_torch.serve import ServeEngine

    try:
        with ep_world(world):
            ServeEngine(cfg, model, device=spec.get("device", "cpu"))
        engine_refused = False
    except NotImplementedError:
        engine_refused = True
    return {
        "engine_refused": engine_refused,
        "tokens": res.tokens.numpy(), "first_logits": res.first_logits.float().numpy(),
        "prompts": [t.numpy() for t in res.prompts],
        "tables": [{name: getattr(t, name).numpy() for name in ("perms", "caps", "valid", "offsets", "n_phases")}
                   | {"envelope": t.envelope} for t in res.tables],
        "decisions": [(d.changed, d.replanned) for d in res.decisions],
        "moe_by_round": res.moe_by_round, "paths": dict(pmoe.PATH_CALLS),
        "gathered": gathered,
        "static": {"tokens": static.tokens.numpy(), "first_logits": static.first_logits.float().numpy(),
                   "moe_by_round": static.moe_by_round, "paths": static_paths},
    }


def card_world(world, spec: dict) -> dict:
    """Each fabric in bf16 on the card (K1 forward, K2/K3 backward) beside
    one process's dense fabric on the whole layer, computed on each rank
    with the same kernels: the reference's y and gradients, then each
    case's (``run_layer``)."""
    dev = world.device
    x = torch.from_numpy(spec["x"]).to(dev, torch.bfloat16)
    cfg = with_dispatch(spec["cfg"], "dense")
    full = pmoe.moe_init(cfg, gen=None, device=dev, dtype=torch.bfloat16)
    full.router.data.copy_(torch.from_numpy(spec["params"]["router"]))
    for name in ("w_gate", "w_up", "w_down"):
        getattr(full, name).data.copy_(torch.from_numpy(spec["params"][name]))
    ref = run_layer(full, cfg, x, None, None)  # no world: the one-device dense fabric
    lo, hi = world.expert_range(cfg.moe.n_experts)
    for name in ("w_gate", "w_up", "w_down"):
        ref[name] = ref[name][lo:hi]
    out = {"ref": ref}
    for case, (dispatch, sched_spec) in spec["cases"].items():
        ccfg = with_dispatch(spec["cfg"], dispatch)
        p = load_layer(ccfg, spec["params"], world, device=dev, dtype=torch.bfloat16)
        out[case] = run_layer(p, ccfg, x, build_schedule(sched_spec, device=dev), world)
    return out


# ------------------------------------------------------------ training across ranks
class CaptureOpt:
    """An optimizer that keeps a copy of the gradients (and the clip norm)
    it is handed, then updates as the one it wraps."""

    def __init__(self, opt):
        self.opt, self.grads, self.norm = opt, None, None

    def init(self, params, **kw):
        return self.opt.init(params, **kw)

    def update(self, grads, state, params, **kw):
        self.grads = {n: g.detach().float().cpu().numpy().copy() for n, g in grads.items()}
        out = self.opt.update(grads, state, params, **kw)
        self.norm = float(out[2]["grad_norm"])
        return out


def train_model(cfg: ModelConfig, params: dict, world, device="cpu"):
    """The model of the JAX parameters ``params`` in f32, holding this
    rank's experts (every expert without a world)."""
    from repro_torch.models.transplant import load_reference

    kw = {} if world is None else {"rank": world.me, "n_model": world.n_model}
    return load_reference(cfg, params, device=device, dtype=torch.float32, param_dtype=torch.float32,
                          requires_grad=True, **kw)


def step_grads(cfg: ModelConfig, params: dict, world, data: dict) -> dict:
    """One train step at ``data`` (``DataConfig`` kwargs, step 0, two
    microbatches): the loss, the clip norm and the gradients the update was
    handed (this rank's, reduced over the world)."""
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.optim import AdamW
    from repro_torch.parallel import data_parallel as dp
    from repro_torch.train import make_train_step

    model = train_model(cfg, params, world)
    opt = CaptureOpt(AdamW(lr=1e-3))
    data_cfg = DataConfig(**data)
    rows = slice(None) if world is None else dp.batch_rows(data_cfg.global_batch, world)
    with ep_world(world):
        step = make_train_step(model, opt, microbatches=2, collect_routing=True)
        metrics = step(SyntheticStream(data_cfg).batch(0, host_slice=rows))
    return {"loss": float(metrics["loss"]), "norm": opt.norm, "grads": opt.grads,
            "dropped": float(metrics["moe_stats"]["dropped"].sum())}


def _loop(cfg, params, world, data, ckpt, *, steps, ckpt_every=5, microbatches=2, log_every=1, grad_compress=None,
          **kw):
    """``train_loop`` at JAX's multidev_train knobs (peak lr 1e-3, warmup 4)
    on a fresh model of ``params``; returns (result, model)."""
    from repro_torch.data import DataConfig
    from repro_torch.train import TrainLoopConfig, train_loop

    model = train_model(cfg, params, world)
    loop_cfg = TrainLoopConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=ckpt_every, microbatches=microbatches,
                               peak_lr=1e-3, warmup=4, log_every=log_every, grad_compress=grad_compress)
    with ep_world(world):
        res = train_loop(model, DataConfig(**data), loop_cfg, **kw)
    return res, model


def _summary(res: dict) -> dict:
    return {k: res[k] for k in ("history", "final_step", "failures", "final_loss")}


def _state(model) -> dict:
    """This rank's parameters (numpy f32) by name."""
    return {n: p.detach().float().cpu().numpy().copy() for n, p in model.named_parameters()}


def train_world(world, spec: dict) -> dict:
    """JAX's ``tests/multidev_train.py`` checks on this rank, then the
    port's own: (a) a clean run, the same run with a failure on rank
    ``spec["fault_rank"]`` only, and an elastic restart of its checkpoint
    on ``spec["layout_b"]``; (b) the host controller over ``scheduled``
    dispatch under drift, each swap's table recorded; with ``spec["nodrop"]``
    (c) one step's reduced gradients (under ``a2a`` and ``dense``) and (d)
    the first losses of a loop at a capacity where nothing drops; (e) the checkpoint's state as the fault
    run left it; (f) what a world refuses."""
    import os

    import numpy as np

    from repro_torch.core import ControllerConfig, DriftScenario, ScheduleRuntime
    from repro_torch.parallel.sharding import regroup

    cfg, params, data, ckpt = spec["cfg"], spec["params"], spec["data"], spec["ckpt"]
    out = {}
    # (a) clean, one rank's failure at step 8 (first attempt), elastic restart onto another layout
    res, _ = _loop(cfg, params, world, data, os.path.join(ckpt, "clean"), steps=12)
    out["clean"] = _summary(res)
    fired = []

    def boom(step):
        if world.rank == spec["fault_rank"] and step == 8 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    res, model = _loop(cfg, params, world, data, os.path.join(ckpt, "fault"), steps=12, failure_hook=boom)
    out["fault"] = {**_summary(res), "fired": bool(fired), "state": _state(model)}
    other = regroup(world, spec["layout_b"])
    res, model = _loop(cfg, params, other, data, os.path.join(ckpt, "fault"), steps=15)
    out["elastic"] = {**_summary(res), "me": other.me, "data_index": other.data_index}

    # (b) the host runtime over scheduled dispatch: drift forces a re-plan, every swap's table kept
    scfg = with_dispatch(cfg, "scheduled")
    n_ep = world.n_model
    runtime = ScheduleRuntime(ControllerConfig(n_ranks=n_ep, n_experts=cfg.moe.n_experts, ema=1.0, cooldown=2,
                                               group_by="model"), cfg.n_moe_layers)
    tokens = data["global_batch"] * data["seq_len"] * cfg.moe.top_k
    runtime.prime(np.full((n_ep, n_ep), tokens / n_ep**2))
    tables = []
    observe = runtime.observe

    def observed(*args, **kw):
        decision = observe(*args, **kw)
        if decision.changed:
            t = runtime.table()
            tables.append({name: getattr(t, name).cpu().numpy().copy()
                           for name in ("perms", "caps", "valid", "offsets", "n_phases")} | {"envelope": t.envelope})
        return decision

    runtime.observe = observed
    scenario = DriftScenario("shift", cfg.moe.n_experts, shift_step=6, seed=0)
    res, _ = _loop(scfg, params, world, data, os.path.join(ckpt, "ctl"), steps=12, microbatches=1, log_every=2,
                   runtime=runtime, stats_hook=scenario.stats_hook)
    out["controller"] = {**_summary(res), "metrics": res["controller"], "tables": tables}

    # (c), (d) at a capacity where nothing drops: the reduced gradients of one step, the first losses of a loop
    if spec.get("nodrop") is not None:
        ncfg = spec["nodrop"]
        # the EP pipeline (a2a: the outputs all-gathered) and the dense fabric's EP form (an all-reduce combine)
        out["grads"] = {d: step_grads(with_dispatch(ncfg, d), params, world, data) for d in ("a2a", "dense")}
        res, _ = _loop(ncfg, params, world, data, os.path.join(ckpt, "nodrop"), steps=4)
        out["nodrop_loop"] = _summary(res)

    # (f) refused under the world, each before any collective
    out["refused"] = refusals(world, cfg, params, data, os.path.join(ckpt, "refused"))
    return out


def refusals(world, cfg, params, data, ckpt) -> dict:
    """The message of each NotImplementedError the world raises: ef8, the
    fused device-controller step, a fabric switch and ``expert_2d``."""
    from repro_torch.core import ControllerConfig, ScheduleRuntime
    from repro_torch.launch.train import plan_controller

    import numpy as np

    pcfg = with_dispatch(cfg, "phase_pipelined")
    out = {}
    _, ctrl, state = plan_controller(pcfg, batch=data["global_batch"], seq=data["seq_len"],
                                      virtual_ranks=world.n_model, device="cpu")
    chain_rt = ScheduleRuntime(ControllerConfig(n_ranks=world.n_model, n_experts=cfg.moe.n_experts,
                                                fallback_chain=("phase_pipelined", "a2a")), cfg.n_moe_layers)
    chain_rt.prime(np.full((world.n_model, world.n_model), 8.0))
    cases = {
        "ef8": lambda: _loop(cfg, params, world, data, ckpt, steps=1, grad_compress="ef8"),
        "device_controller": lambda: _loop(pcfg, params, world, data, ckpt, steps=1, device_controller=ctrl,
                                           device_ctrl_state=state),
        "fabric_switch": lambda: _loop(pcfg, params, world, data, ckpt, steps=1, runtime=chain_rt),
        "expert_2d": lambda: _loop(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, expert_2d=True)),
                                   params, world, data, ckpt, steps=1),
    }
    for name, run in cases.items():
        try:
            run()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def card_train_world(world, spec: dict) -> dict:
    """``train_loop`` on the card under ``world`` (``spec["cfg"]``, a seeded
    model holding this rank's experts, the launcher's lossless table over
    the model group): a clean run, the same run with a failure on rank
    ``spec["fault_rank"]`` only, and its checkpoint restored onto
    ``spec["layout_b"]``; each run's history, failures and K1/K2/K3
    launches, and the expert blocks a layer call launches (the table's
    live phase slots and the local block across EP ranks, one block on a
    model group of one)."""
    import os

    from repro_torch.data import DataConfig
    from repro_torch.launch.train import plan_table
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import regroup
    from repro_torch.train import TrainLoopConfig, train_loop

    cfg, data, steps = spec["cfg"], spec["data"], spec["steps"]

    def run(w, ckpt, n_steps, hook=None):
        model = Model(cfg, device=w.device, param_dtype=torch.float32, requires_grad=True, seed=0,
                      expert_shard=(w.me, w.n_model))
        table = plan_table(cfg, batch=data["global_batch"], seq=data["seq_len"], virtual_ranks=w.n_model,
                           n_data=w.n_data, device=w.device)
        for fn in K1_COUNTERS.values():
            fn.launches = 0
        loop_cfg = TrainLoopConfig(steps=n_steps, ckpt_dir=ckpt, ckpt_every=spec["ckpt_every"], peak_lr=3e-4,
                                   warmup=2, log_every=1)
        with ep_world(w):
            res = train_loop(model, DataConfig(**data), loop_cfg, schedule=table, failure_hook=hook)
        live = sum(1 for v in table.envelope_slots(cfg.moe.n_experts // w.n_model) if v)
        return {**_summary(res), "launches": {k: fn.launches for k, fn in K1_COUNTERS.items()},
                "per_call": live + 1 if w.n_model > 1 else 1}

    fired = []

    def boom(step):
        if world.rank == spec["fault_rank"] and step == spec["fault_at"] and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    out = {"clean": run(world, os.path.join(spec["ckpt"], "clean"), steps)}
    out["fault"] = {**run(world, os.path.join(spec["ckpt"], "fault"), steps, boom), "fired": bool(fired)}
    out["elastic"] = run(regroup(world, spec["layout_b"]), os.path.join(spec["ckpt"], "fault"),
                         steps + spec["more_steps"])
    return out

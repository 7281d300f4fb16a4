"""The EP fabrics across a 4-rank gloo world on the CPU, held against the
JAX package.

One world of 4 spawned ranks (``_torch_world.fabric_world``; the ranks
import ``repro_torch`` only) runs every case; this process computes the
JAX side.  Reference: JAX's no-mesh ``moe_apply(dispatch="dense")`` on
the smoke layer of ``tests/multidev_fabric.py`` (d 32, 8 experts, top-2,
capacity 8.0: nothing is dropped, so every fabric must agree with it),
in f32 (``layers.COMPUTE_DTYPE`` patched, as ``test_torch_moe.py`` does).

* values within 1e-5 (the same f32 products summed in another order);
* gradients within 2e-4 (each rank's loss is an unequal share of
  ``sum(y**2)``; the router's and the input's partial gradients summed over
  the ranks, each expert's whole on its rank);
* ``routing`` summed over source ranks, ``dropped`` and the stats keys;
* ``ragged_a2a`` equal to ``phase_pipelined`` bit for bit;
* each rank's ``pack`` at the smoke Mixtral's tight capacity (1.25)
  equal to JAX's ``fabric.pack`` called for that rank with a concrete
  ``me``;
* a BvN plan's multi-phase pairs through ``ppermute``, a re-planned row
  swapped into the same table between calls, the fault wrapper's pass
  and refusal, and the token slots each rank sent against
  ``dispatch_tokens``;
* the ``hierarchical`` fabric on the two-level plan of the same traffic
  (``tests/multidev_fabric.py``'s knobs) at pod sizes 2 and 4 in the
  matrix above, under fp8 (one pod over every rank bit for bit, two pods
  within JAX's 0.25 of the dense layer), its slots against its children's
  accounting, and an intra-only then an inter re-plan refilled into the
  same two-level table between calls.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.base import MoECfg as JaxMoECfg
from repro.core import ScheduleTable as JaxTable
from repro.core.schedule import A2ASchedule as JaxPlan
from repro.models import moe as jax_moe
from repro.parallel.fabric import get_fabric as jax_get_fabric
from repro.parallel.fabric.base import FabricContext as JaxContext

import _torch_world as tw
from repro_torch.core import FaultScenario, decompose, plan_schedule
from repro_torch.core.schedule import phase_envelope, plan_schedule_bvn
from repro_torch.models import moe as pmoe
from repro_torch.parallel.fabric import geometry as geom
from repro_torch.parallel.fabric import get_fabric
from repro_torch.parallel.sharding import spawn_world

N = tw.N_RANKS
VAL_TOL, GRAD_TOL = 1e-5, 2e-4
FABRIC_CASES = ("dense", "a2a", "ppermute", "ppermute_bvn", "scheduled_static", "phase_pipelined",
                "phase_pipelined_mono", "ragged_a2a", "hierarchical", "hierarchical_pod4")


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    return {
        "router": (rng.standard_normal((d, e)) * 0.5).astype(np.float32),
        "w_gate": (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
        "w_up": (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
        "w_down": (rng.standard_normal((e, f, d)) * f**-0.5).astype(np.float32),
    }


def _traffic(cfg, params, x):
    """[n, n] choices from EP rank i's sequence chunk to rank j."""
    p = tw.load_layer(cfg, params, _OneRank(), dtype=torch.float32)
    b, s, d = x.shape
    mat = np.zeros((N, N))
    for i in range(N):
        chunk = torch.from_numpy(x[:, i * s // N:(i + 1) * s // N].reshape(-1, d))
        idx, _ = pmoe._router(p, cfg, chunk)
        np.add.at(mat[i], idx.numpy().ravel() // (cfg.moe.n_experts // N), 1)
    return mat


class _OneRank:
    """Expert range of the whole layer (to route on the host)."""

    def expert_range(self, e):
        return 0, e


def _jax_plan(plan):
    return JaxPlan(perms=plan.perms, caps=plan.caps, valid=plan.valid, offsets=plan.offsets)


def _jax_row(plan, envelope):
    table = tw.build_table(plan, envelope)
    return JaxTable.from_schedules([_jax_plan(plan)], k_max=N, clip=True, envelope=table.envelope).row(0)


def _jcfg(cfg, dispatch="dense"):
    m = cfg.moe
    return JaxConfig(name=cfg.name, family="moe", n_layers=1, d_model=cfg.d_model, n_heads=cfg.n_heads,
                     n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
                     moe=JaxMoECfg(n_experts=m.n_experts, top_k=m.top_k, d_ff_expert=m.d_ff_expert,
                                   capacity_factor=m.capacity_factor, dispatch=dispatch))


def _jax_params(params):
    return {"router": {"w": jnp.asarray(params["router"])},
            **{k: jnp.asarray(params[k]) for k in ("w_gate", "w_up", "w_down")}}


def _jax_layer(cfg, params, x, row=None):
    """JAX's no-mesh dense layer: y, stats and the gradients of sum(y**2)."""
    jcfg, jp = _jcfg(cfg), _jax_params(params)

    def f(prm, v):
        return jax_moe.moe_apply(prm, jcfg, v, schedule=row, return_stats=True)

    y, st = f(jp, jnp.asarray(x))
    g, dx = jax.grad(lambda prm, v: (f(prm, v)[0] ** 2).sum(), argnums=(0, 1))(jp, jnp.asarray(x))
    return {"y": np.asarray(y), "routing": np.asarray(st["routing"]), "dropped": np.asarray(st["dropped"]),
            "keys": set(st), "dx": np.asarray(dx), "router": np.asarray(g["router"]["w"]),
            **{k: np.asarray(g[k]) for k in ("w_gate", "w_up", "w_down")}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The shared 4-rank run: spec, the ranks' results and the JAX side."""
    cfg = tw.layer_cfg()
    params = _params(cfg, 0)
    x = np.random.default_rng(1).standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    traffic = _traffic(cfg, params, x)
    plan = plan_schedule(decompose(traffic, "maxweight"), slack=1.5, quantum=8)
    bvn = plan_schedule_bvn(decompose(traffic, "bvn"))
    # a dead pair the max-weight plan routes: refused; the plan re-made under the mask avoids it
    routed = [(i, int(plan.perms[k, i])) for k in range(plan.num_phases) for i in range(N) if plan.valid[k, i]]
    seed = next(s for s in range(500) if FaultScenario("dead_link", n_ranks=N, onset=0, n_links=1, seed=s).dead_pairs
                == (routed[0],))
    scenario = FaultScenario("dead_link", n_ranks=N, onset=0, n_links=1, seed=seed)
    masked = plan_schedule(decompose(traffic, "maxweight", link_mask=scenario.link_mask(0)), slack=1.5, quantum=8)
    # the swap: a shift plan of the same traffic into the max-weight plan's table, both inside one envelope
    shift = plan_schedule(decompose(traffic, "shift"), slack=1.5, quantum=8)
    envelope = np.maximum(phase_envelope([plan], N), phase_envelope([shift], N))
    # the packs: the smoke Mixtral layer at its capacity 1.25, a plan at a quarter of the traffic (admission clips)
    mcfg = tw.mixtral_layer_cfg("dense")
    mparams = _params(mcfg, 2)
    xm = np.random.default_rng(3).standard_normal((4, 64, mcfg.d_model)).astype(np.float32)
    mtraffic = _traffic(mcfg, mparams, xm)
    tight = plan_schedule(decompose(np.maximum(mtraffic // 4, 1), "maxweight"), quantum=8, min_cap=1)
    spec = {
        "params": params, "x": x,
        "cases": {
            "dense": ("dense", None), "dense_row": ("dense", ("row", plan, "auto")), "a2a": ("a2a", None),
            "ppermute": ("ppermute", plan), "ppermute_bvn": ("ppermute", bvn), "scheduled_static": ("scheduled", plan),
            "phase_pipelined": ("phase_pipelined", ("row", plan, "auto")),
            "phase_pipelined_mono": ("phase_pipelined", ("row", plan, None)),
            "ragged_a2a": ("ragged_a2a", ("row", plan, "auto")),
            "masked_phase_pipelined": ("phase_pipelined", ("row", masked, "auto")),
            # the two-level fabric: two pods of two, one pod of four (every pair intra), each under fp8
            "hierarchical": ("hierarchical", ("hrow", traffic, 2), {"pod_size": 2}),
            "hierarchical_pod4": ("hierarchical", ("hrow", traffic, 4), {"pod_size": 4}),
            "hierarchical_fp8": ("hierarchical", ("hrow", traffic, 2), {"pod_size": 2, "wire_dtype": "fp8"}),
            "hierarchical_pod4_fp8": ("hierarchical", ("hrow", traffic, 4), {"pod_size": 4, "wire_dtype": "fp8"}),
        },
        "hier_traffic": traffic,
        "faulty": {"faulty_avoided": (scenario, ("row", masked, "auto")), "faulty_routed": (scenario, ("row", plan, "auto"))},
        "swap": (plan, shift, envelope),
        "pack_params": mparams, "pack_x": xm,
        "packs": {"dense": ("row", tight, "auto"), "a2a": None, "ppermute": tight,
                  "phase_pipelined": ("row", tight, "auto"), "ragged_a2a": ("row", tight, "auto")},
    }
    ranks = spawn_world(tw.fabric_world, N, args=(spec,), timeout_s=150)
    return {"spec": spec, "ranks": ranks, "cfg": cfg, "plan": plan, "bvn": bvn, "scenario": scenario,
            "routed": routed[0], "mcfg": mcfg, "tight": tight, "shift": shift, "traffic": traffic}


@pytest.fixture(scope="module")
def jax_side(world):
    jax_layers.COMPUTE_DTYPE, old = jnp.float32, jax_layers.COMPUTE_DTYPE
    try:
        cfg, spec = world["cfg"], world["spec"]
        return {"dense": _jax_layer(cfg, spec["params"], spec["x"]),
                "dense_row": _jax_layer(cfg, spec["params"], spec["x"], _jax_row(world["plan"], "auto"))}
    finally:
        jax_layers.COMPUTE_DTYPE = old


def _assert_layer(ranks, ref, case, *, ep=True):
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["y"], ref["y"], rtol=VAL_TOL, atol=VAL_TOL, err_msg=f"{case} rank {r} y")
        lo, hi = r * 2, (r + 1) * 2
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(rank[name], ref[name][lo:hi], rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"{case} rank {r} d{name}")
    for name in ("router", "dx"):
        np.testing.assert_allclose(sum(rank[name] for rank in ranks), ref[name], rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{case} d{name} summed over ranks")
    for rank in ranks:
        assert set(rank) >= ref["keys"] | {"admitted"}
        assert rank["routing"].shape == ((N if ep else 1), 8)
        np.testing.assert_array_equal(rank["routing"].sum(0), ref["routing"].sum(0))
        assert float(rank["dropped"].sum()) == float(ref["dropped"].sum()) == 0.0


@pytest.mark.parametrize("case", FABRIC_CASES)
def test_fabric_matches_jax_dense(world, jax_side, case):
    ranks = [r[case] for r in world["ranks"]]
    _assert_layer(ranks, jax_side["dense"], case, ep=case != "dense")
    path = "dense_ep" if case == "dense" else {"scheduled_static": "ppermute", "phase_pipelined_mono":
                                                "phase_pipelined", "ppermute_bvn": "ppermute",
                                                "hierarchical_pod4": "hierarchical"}.get(case, case)
    assert all(r["paths"] == {path: 1} for r in ranks), [r["paths"] for r in ranks]


def test_dense_ep_row_admits_as_the_virtual_fabric(world, jax_side):
    """The dense EP form under a row: the one-device virtual sources."""
    _assert_layer([r["dense_row"] for r in world["ranks"]], jax_side["dense_row"], "dense_row", ep=False)


def test_ragged_a2a_equals_phase_pipelined_bit_for_bit(world):
    for r in world["ranks"]:
        for key in ("y", "dx", "router", "w_gate", "w_up", "w_down", "routing", "dropped", "admitted"):
            np.testing.assert_array_equal(r["ragged_a2a"][key], r["phase_pipelined"][key], err_msg=key)
        for key in ("first", "second"):
            np.testing.assert_array_equal(r["swap_ragged_a2a"][key]["y"], r["swap_phase_pipelined"][key]["y"])


def test_bvn_plan_runs_multi_phase_pairs_through_ppermute(world):
    bvn = world["bvn"]
    assert bvn.offsets is not None
    pairs = [(i, int(bvn.perms[k, i])) for k in range(bvn.num_phases) for i in range(N) if bvn.valid[k, i]]
    assert len(pairs) > len(set(pairs)), "no pair recurs across phases"


def test_slots_sent_match_dispatch_tokens(world):
    """Each rank's dispatch-leg token slots against the fabric's model."""
    plan, ranks = world["plan"], world["ranks"]
    e_local, t_local = 2, 4 * 8 // N
    cap = geom.round8(-(-t_local * 2 * 8 // 8))  # the a2a bucket: ceil(t * k / E * 8.0)
    mean = lambda case: np.mean([r[case]["slots"] for r in ranks])
    assert mean("a2a") == get_fabric("a2a").dispatch_tokens(n=N, cap_uniform=e_local * cap)
    assert mean("dense") == get_fabric("dense").dispatch_tokens(n=N) == 0
    phase_caps = geom.round8(-(-plan.caps.astype(np.int64) // e_local))
    slot_plan = dataclasses.replace(plan, caps=e_local * phase_caps)
    assert mean("ppermute") == get_fabric("ppermute").dispatch_tokens(n=N, schedule=slot_plan)
    env = e_local * np.asarray(tw.build_table(plan, "auto").envelope_slots(e_local))
    pp = get_fabric("phase_pipelined")
    assert mean("phase_pipelined") == pp.dispatch_tokens_padded(n=N, envelope=env)
    assert mean("ragged_a2a") == get_fabric("ragged_a2a").dispatch_tokens(n=N, schedule=plan, envelope=env)
    assert mean("ragged_a2a") < mean("phase_pipelined")  # the emulation tax


def test_swapped_row_runs_without_a_rebuild(world, jax_side):
    for fabric in ("phase_pipelined", "ragged_a2a"):
        ranks = [r[f"swap_{fabric}"] for r in world["ranks"]]
        assert all(r["same_storage"] for r in ranks)
        shift = world["shift"]
        np.testing.assert_array_equal(ranks[0]["perms"][0, :shift.num_phases], shift.perms)
        assert not np.array_equal(shift.perms, world["plan"].perms[:shift.num_phases])
        _assert_layer([r["first"] for r in ranks], jax_side["dense"], f"{fabric} first")
        _assert_layer([r["second"] for r in ranks], jax_side["dense"], f"{fabric} swapped")
        # the swapped row's geometry is what packed: each rank's pack equals JAX's under the swapped plan
        jrow = JaxTable.from_schedules([_jax_plan(world["shift"])], k_max=N, clip=True,
                                       envelope=ranks[0]["envelope"]).row(0)
        for r, rank in enumerate(ranks):
            _assert_pack(rank["pack"], jax_get_fabric(fabric), world["cfg"], jrow, r)


def _assert_pack(got, jfabric, cfg, schedule, me):
    jctx = JaxContext(cfg=_jcfg(cfg, jfabric.name), n=N, e_local=cfg.moe.n_experts // N, axis=None, me=me,
                      schedule=schedule)
    ref = jfabric.pack(jctx, jnp.asarray(got["x_loc"]), jnp.asarray(got["idx"]), jnp.asarray(got["gates"]))
    for key in ("pos", "gate", "live", "admitted", "wire", "buf"):
        np.testing.assert_array_equal(got[key], np.asarray(getattr(ref, key)), err_msg=f"{jfabric.name} rank {me} {key}")


@pytest.mark.parametrize("fabric", ["dense", "a2a", "ppermute", "phase_pipelined", "ragged_a2a"])
def test_pack_per_rank_matches_jax_at_tight_capacity(world, fabric):
    tight = world["tight"]
    sched = {"a2a": None, "ppermute": _jax_plan(tight)}.get(fabric, _jax_row(tight, "auto"))
    for r, rank in enumerate(world["ranks"]):
        got = rank["packs"][fabric]
        _assert_pack(got, jax_get_fabric(fabric), world["mcfg"], sched, r)
    if fabric in ("dense", "phase_pipelined"):
        assert not all(rank["packs"][fabric]["admitted"].all() for rank in world["ranks"]), "nothing clipped"


def test_faulty_wrapper_passes_an_avoided_link_and_refuses_a_routed_one(world):
    for r in world["ranks"]:
        ok, plain = r["faulty_avoided"], r["masked_phase_pipelined"]
        for key in ("y", "dx", "router", "w_gate", "routing", "dropped", "admitted"):
            np.testing.assert_array_equal(ok[key], plain[key], err_msg=key)
        bad = r["faulty_routed"]
        assert bad["error"] == "FabricFaultError", bad
        assert bad["backend"] == "phase_pipelined" and bad["pair"] == world["routed"]
        assert bad["next_fabric"] == "a2a" and "'a2a'" in bad["message"]
        assert f"phase {bad['phase']}" in bad["message"]


def test_a_rank_holding_every_expert_is_refused(world):
    """Under a world a rank holds its expert slice only: a module with all
    E experts raises instead of running a view of them."""
    for me, rank in enumerate(world["ranks"]):
        assert rank["all_experts"] is not None, f"rank {me} ran a module holding every expert"
        assert f"EP rank {me} of {N} runs" in rank["all_experts"]


# ------------------------------------------------------------ the two-level fabric
def test_hierarchical_under_fp8_is_bit_exact_inside_a_pod_and_close_across(world, jax_side):
    """``tests/multidev_fabric.py``'s wire seam: one pod over every rank
    leaves the fp8 wire a bit-exact no-op; two pods quantize the inter
    slots, within JAX's 0.25 of the dense layer, the routing unchanged."""
    ref = jax_side["dense"]
    for r, rank in enumerate(world["ranks"]):
        for key in ("y", "dx", "router", "w_gate", "w_up", "w_down", "routing", "dropped"):
            np.testing.assert_array_equal(rank["hierarchical_pod4_fp8"][key], rank["hierarchical_pod4"][key],
                                          err_msg=f"rank {r} {key}")
        q = rank["hierarchical_fp8"]
        np.testing.assert_allclose(q["y"], ref["y"], atol=0.25, err_msg=f"rank {r}")
        assert np.abs(q["y"] - rank["hierarchical"]["y"]).max() > 0.0, "the inter slots were not quantized"
        np.testing.assert_array_equal(q["routing"].sum(0), ref["routing"].sum(0))
        assert float(q["dropped"].sum()) == 0.0


def test_hierarchical_slots_sent_match_its_accounting(world):
    """Each rank's dispatch-leg slots: the intra phases on the dense
    per-phase emulation (``phase_pipelined``'s padded count), the inter
    phases exactly their live envelope slots (``ragged_a2a``'s)."""
    e_local = 2
    for case, pod in (("hierarchical", 2), ("hierarchical_pod4", 4)):
        row = tw.build_hierarchical(world["traffic"], pod).row(0)
        env_i = e_local * np.asarray(row.intra.envelope_slots(e_local))
        env_e = e_local * np.asarray(row.inter.envelope_slots(e_local))
        on_e = (np.arange(row.inter.k_max) < int(row.inter.n_phases))[:, None] & row.inter.valid.numpy()
        want = (get_fabric("phase_pipelined").dispatch_tokens_padded(n=N, envelope=env_i)
                + get_fabric("ragged_a2a").dispatch_tokens(n=N, schedule=types.SimpleNamespace(valid=on_e),
                                                           envelope=env_e))
        got = np.mean([r[case]["slots"] for r in world["ranks"]])
        assert got == want, (case, got, want)
        split = get_fabric("hierarchical").dispatch_tokens_split(n=N, schedule=row)
        assert set(split) == {"intra", "inter"}


def test_hierarchical_table_swaps_run_without_a_rebuild(world, jax_side):
    """An intra-only re-plan, then an inter one, refilled into the same
    two-level table between calls: every call equals the dense layer."""
    for r, rank in enumerate(world["ranks"]):
        assert rank["hier_swaps"]["same_storage"], r
    for k in range(3):
        _assert_layer([rank["hier_swaps"]["calls"][k] for rank in world["ranks"]], jax_side["dense"],
                      f"hierarchical swap {k}")

"""Planner parity: the port's decomposition, schedule and ScheduleTable
against the JAX package's on the same seeded traffic.

Everything here is integer or exact float64 host arithmetic (the same
scipy LAP on the same matrices), so the comparisons are exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.core import ScheduleTable as JaxTable
from repro.core import decompose as jax_decompose
from repro.core import make_serving_controller
from repro.core import plan_schedule as jax_plan
from repro.core import routing_to_traffic as jax_routing_to_traffic

from repro_torch.configs import smoke_config
from repro_torch.core import ScheduleTable, decompose, plan_schedule, routing_to_traffic
from repro_torch.core import make_serving_controller as port_serving_controller


def _traffic(n: int, seed: int, density: float = 0.6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 200, size=(n, n)).astype(np.float64)
    m *= rng.random((n, n)) < density
    return m


def _assert_table_equal(port: ScheduleTable, ref) -> None:
    for name in ("perms", "caps", "valid", "offsets", "n_phases"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
        assert getattr(port, name).numpy().dtype == np.asarray(getattr(ref, name)).dtype, name
    assert port.envelope == ref.envelope


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_fill", [0.0, 0.1])
def test_maxweight_decomposition_bit_identical(n, seed, min_fill):
    m = _traffic(n, seed)
    port = decompose(m, "maxweight", min_fill=min_fill)
    ref = jax_decompose(m, "maxweight", min_fill=min_fill)
    ps, rs = port.stacked(), ref.stacked()
    for name in ("perms", "alloc", "sent"):
        a, b = getattr(ps, name), getattr(rs, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port.meta["n_greedy"] == ref.meta["n_greedy"]
    np.testing.assert_array_equal(port.meta["local_tokens"], ref.meta["local_tokens"])
    port.verify()


@pytest.mark.parametrize("n", [8, 16])
def test_shift_decomposition_bit_identical(n):
    m = _traffic(n, 7)
    ps, rs = decompose(m, "shift").stacked(), jax_decompose(m, "shift").stacked()
    for name in ("perms", "alloc", "sent"):
        np.testing.assert_array_equal(getattr(ps, name), getattr(rs, name))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("slack,min_cap", [(1.0, 8), (1.1, 8), (1.5, 32)])
def test_plan_schedule_bit_identical(n, slack, min_cap):
    m = _traffic(n, 3)
    port = plan_schedule(decompose(m, "maxweight", min_fill=0.1), slack=slack, min_cap=min_cap)
    ref = jax_plan(jax_decompose(m, "maxweight", min_fill=0.1), slack=slack, min_cap=min_cap)
    for name in ("perms", "caps", "valid"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("k_max,envelope", [(None, "auto"), (None, None), (4, "auto")])
def test_schedule_table_leaves_bit_identical(n, k_max, envelope):
    plans_np = [_traffic(n, 10 + l) for l in range(3)]
    port_plans = [plan_schedule(decompose(m, "maxweight")) for m in plans_np]
    ref_plans = [jax_plan(jax_decompose(m, "maxweight")) for m in plans_np]
    clip = k_max is not None
    port = ScheduleTable.from_schedules(port_plans, k_max=k_max, clip=clip, envelope=envelope)
    ref = JaxTable.from_schedules(ref_plans, k_max=k_max, clip=clip, envelope=envelope)
    _assert_table_equal(port, ref)
    e_local = 2
    for l in range(3):
        pr, rr = port.row(l), ref.row(l)
        _assert_table_equal(pr, rr)
        np.testing.assert_array_equal(pr.pair_caps(e_local).numpy(), np.asarray(rr.pair_caps(e_local)))
        np.testing.assert_array_equal(pr.pair_caps(1).numpy(), np.asarray(rr.pair_caps(1)))
        np.testing.assert_array_equal(
            pr.phase_slot_caps(e_local).numpy(), np.asarray(rr.phase_slot_caps(e_local))
        )
        if envelope is not None:
            assert pr.envelope_slots(e_local) == rr.envelope_slots(e_local)


def test_routing_to_traffic_matches():
    rng = np.random.default_rng(4)
    for n_src in (1, 2, 8, 16):
        stats = rng.integers(0, 50, size=(3, n_src, 16)).astype(np.float32)
        np.testing.assert_array_equal(
            routing_to_traffic(stats, n_ranks=8, n_experts=16),
            jax_routing_to_traffic(stats, n_ranks=8, n_experts=16),
        )


def _port_first_table(stats, n_layers: int) -> ScheduleTable:
    """The port's serving controller's table after one observation."""
    pcfg = dataclasses.replace(smoke_config("mixtral-8x7b"), n_layers=n_layers)
    runtime, _ = port_serving_controller(pcfg, n_ranks=8, drift="none", device="cpu")
    runtime.observe(stats)
    return runtime.table()


@pytest.mark.parametrize("n_slots,n_layers", [(4, 2), (16, 4), (32, 1)])
def test_serving_table_equals_jax_controller_first_table(n_slots, n_layers):
    """The port's serving controller builds the JAX serving controller's
    first table for the engine's uniform estimate stats0."""
    cfg = dataclasses.replace(jax_smoke("mixtral-8x7b"), n_layers=n_layers)
    runtime, _ = make_serving_controller(cfg, n_ranks=8, drift="none")
    stats0 = np.full(
        (runtime.n_layers, 1, cfg.moe.n_experts),
        float(n_slots * cfg.moe.top_k) / cfg.moe.n_experts,
        np.float32,
    )
    runtime.observe(stats0)
    ref = runtime.table()
    _assert_table_equal(_port_first_table(stats0, n_layers), ref)


def test_schedule_table_on_device_argument():
    plan = plan_schedule(decompose(_traffic(8, 0), "maxweight"))
    t = ScheduleTable.from_schedules([plan], envelope="auto", device="cpu")
    assert t.perms.device == torch.device("cpu") and t.perms.dtype == torch.int32
    with pytest.raises(ValueError, match="already a row"):
        t.row(0).row(0)
    with pytest.raises(ValueError, match="row slice"):
        t.pair_caps()


@pytest.mark.parametrize("kind", ["none", "shift", "hotspot", "skew"])
def test_drift_scenario_matches_jax(kind):
    from repro.core.drift import DriftScenario as JaxDrift

    from repro_torch.core.drift import DriftScenario

    port, ref = DriftScenario(kind, 8, shift_step=2, window=3, seed=4), JaxDrift(kind, 8, shift_step=2, window=3, seed=4)
    stats = np.random.default_rng(0).integers(0, 40, size=(2, 1, 8)).astype(np.float64)
    for step in range(7):
        np.testing.assert_array_equal(port.expert_probs(step), ref.expert_probs(step))
        np.testing.assert_array_equal(port.stats_hook(step, stats), ref.stats_hook(step, stats))
        np.testing.assert_array_equal(port.traffic(step, np.full(4, 100.0), n_ranks=4), ref.traffic(step, np.full(4, 100.0), n_ranks=4))


def test_serving_launcher_table_equals_jax_controller_under_drift_estimate():
    """The JAX serve launcher (--controller --drift none) feeds its
    controller tokens * DriftScenario("none").expert_probs(r); the port's
    launcher plans round 0 from the same estimate and gets the same table."""
    from repro_torch.core.drift import DriftScenario
    from repro_torch.launch.serve import demand_estimate, serve
    from repro_torch.models import Model

    batch, prompt, rounds = 2, 8, 1
    jcfg = dataclasses.replace(jax_smoke("mixtral-8x7b"), n_layers=2)
    runtime, scenario = make_serving_controller(jcfg, n_ranks=8, drift="none", rounds=rounds)
    tokens = float(batch * prompt * jcfg.moe.top_k)
    stats = np.broadcast_to(tokens * scenario.expert_probs(0)[None, None, :], (runtime.n_layers, 1, jcfg.moe.n_experts))
    runtime.observe(stats)
    ref = runtime.table()

    pcfg = smoke_config("mixtral-8x7b")
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="phase_pipelined"))
    est = demand_estimate(pcfg, tokens, DriftScenario("none", pcfg.moe.n_experts), 0)
    np.testing.assert_array_equal(est, stats)
    _assert_table_equal(_port_first_table(est, 2), ref)
    res = serve(Model(pcfg, device="cpu"), batch=batch, prompt_len=prompt, new_tokens=1, rounds=rounds)
    _assert_table_equal(res.table, ref)

"""Fabric-geometry parity: admission, packing and stats of the port's
virtual fabric against ``repro.parallel.fabric.geometry`` on the same
routing.  All integer/boolean results must be equal; the f32 combine
scatter-add may sum in another order (stated tolerance below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ScheduleTable as JaxTable
from repro.core import decompose as jax_decompose
from repro.core import plan_schedule as jax_plan
from repro.parallel.fabric import geometry as jg

from repro_torch.core import ScheduleTable, decompose, plan_schedule
from repro_torch.parallel.fabric import geometry as pg

N_EXPERTS, TOP_K = 8, 2


def _routing(t: int, seed: int):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, N_EXPERTS))
    idx = np.argsort(-logits, axis=1)[:, :TOP_K].astype(np.int32)
    gates = rng.random((t, TOP_K)).astype(np.float32)
    x = rng.standard_normal((t, 16)).astype(np.float32)
    return idx, gates, x


def _rows(n_ranks: int, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 60, size=(n_ranks, n_ranks)).astype(np.float64) * scale
    m *= rng.random((n_ranks, n_ranks)) < 0.6  # dark pairs: cap 0, every choice clipped
    port = ScheduleTable.from_schedules([plan_schedule(decompose(m, "maxweight", min_fill=0.1))], envelope="auto")
    ref = JaxTable.from_schedules([jax_plan(jax_decompose(m, "maxweight", min_fill=0.1))], envelope="auto")
    return port.row(0), ref.row(0)


@pytest.mark.parametrize("t,seed", [(64, 0), (256, 1), (40, 2)])
@pytest.mark.parametrize("n_ranks", [8, 4])
@pytest.mark.parametrize("scale", [0.05, 1.0])
def test_admission_mask_equal(t, seed, n_ranks, scale):
    idx, gates, _ = _routing(t, seed)
    prow, jrow = _rows(n_ranks, seed, scale)
    tok = np.arange(t * TOP_K) // TOP_K
    src = (tok * n_ranks) // t
    g_p, a_p = pg.admission_mask(torch.from_numpy(idx), torch.from_numpy(gates), prow, N_EXPERTS,
                                 src=torch.from_numpy(src))
    g_j, a_j = jg.admission_mask(jnp.asarray(idx), jnp.asarray(gates), jrow, N_EXPERTS,
                                 src=jnp.asarray(src, jnp.int32))
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(g_p.numpy(), np.asarray(g_j))
    assert not a_p.all(), "dark pairs must clip some choices"


@pytest.mark.parametrize("t,cap,seed", [(64, 24, 0), (64, 8, 1), (100, 32, 2)])
def test_group_tokens_and_stats_equal(t, cap, seed):
    idx, gates, x = _routing(t, seed)
    rng = np.random.default_rng(seed + 100)
    admitted = rng.random(t * TOP_K) < 0.8
    key = idx.reshape(-1)
    buf_p, pos_p, gate_p, live_p = pg.group_tokens(
        torch.from_numpy(x), torch.from_numpy(key), torch.from_numpy(gates.reshape(-1)), N_EXPERTS, cap,
        admitted=torch.from_numpy(admitted),
    )
    buf_j, pos_j, gate_j, live_j = jg.group_tokens(
        jnp.asarray(x), jnp.asarray(key), jnp.asarray(gates.reshape(-1)), N_EXPERTS, cap,
        admitted=jnp.asarray(admitted),
    )
    np.testing.assert_array_equal(pos_p.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(live_p.numpy(), np.asarray(live_j))
    np.testing.assert_array_equal(gate_p.numpy(), np.asarray(gate_j))
    np.testing.assert_array_equal(buf_p.numpy(), np.asarray(buf_j))

    counts_p = pg.routing_counts(torch.from_numpy(idx), N_EXPERTS)[None, :]
    counts_j = jg.routing_counts(jnp.asarray(idx), N_EXPERTS)[None, :]
    st_p = pg.stats_tree(counts_p, torch.from_numpy(admitted), live_p)
    st_j = jg.stats_tree(counts_j, jnp.asarray(admitted), live_j)
    for name in ("routing", "dropped"):
        np.testing.assert_array_equal(st_p[name].numpy(), np.asarray(st_j[name]), err_msg=name)
    assert float(st_p["admitted"]) == float(admitted.sum())

    # combine: f32 scatter-add; two choices per token summed in possibly
    # another order, so allow f32 rounding (1e-6 relative)
    y = rng.standard_normal((N_EXPERTS, cap, 16)).astype(np.float32)
    out_p = pg.ungroup(torch.from_numpy(y), pos_p, gate_p, t)
    out_j = jg.ungroup(jnp.asarray(y), pos_j, gate_j, t)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-6)


def test_rank_in_group_equal():
    key = np.random.default_rng(5).integers(0, 7, size=300).astype(np.int32)
    np.testing.assert_array_equal(
        pg.rank_in_group(torch.from_numpy(key)).numpy(), np.asarray(jg.rank_in_group(jnp.asarray(key)))
    )


def test_round8_equal():
    for v in (0, 1, 8, 9, 320, 321):
        assert pg.round8(v) == jg.round8(v)


@pytest.mark.parametrize("name", ["a2a", "dense", "ppermute", "phase_pipelined", "ragged_a2a", "hierarchical",
                                  "scheduled"])
def test_consumes_schedule_and_table_answer_as_the_jax_registry(name):
    """The training loop's fail-fast checks key on these two answers."""
    import repro.parallel.fabric as jax_fabric

    from repro_torch.parallel.fabric import consumes_schedule, consumes_table

    assert consumes_schedule(name) == jax_fabric.consumes_schedule(name)
    assert consumes_table(name) == jax_fabric.consumes_table(name)


def test_consumes_schedule_rejects_unknown_names_as_jax_does():
    import repro.parallel.fabric as jax_fabric

    from repro_torch.parallel.fabric import consumes_schedule, consumes_table

    for fn in (consumes_schedule, consumes_table, jax_fabric.consumes_schedule, jax_fabric.consumes_table):
        with pytest.raises(ValueError, match="unknown dispatch mode"):
            fn("carrier_pigeon")


# ------------------------------------------------------------ the registry
import repro.parallel.fabric as jfab  # noqa: E402
from repro.core import FaultScenario as JaxScenario  # noqa: E402
from repro.core.faults import FabricFaultError as JaxFaultError  # noqa: E402
from repro.core.schedule import A2ASchedule as JaxPlan  # noqa: E402

import repro_torch.parallel.fabric as pfab  # noqa: E402
from repro_torch.core import FabricFaultError, FaultScenario  # noqa: E402
from repro_torch.core.schedule import plan_schedule_bvn  # noqa: E402

N_REG = 4


def _reg_plans():
    """(port plan, JAX plan, port row, JAX row, port table, JAX table) of one traffic matrix."""
    m = np.random.default_rng(7).integers(20, 200, size=(N_REG, N_REG)).astype(np.float64)
    plan = plan_schedule(decompose(m, "maxweight"), slack=1.5)
    jplan = JaxPlan(perms=plan.perms, caps=plan.caps, valid=plan.valid, offsets=plan.offsets)
    table = ScheduleTable.from_schedules([plan], envelope="auto")
    jtable = JaxTable.from_schedules([jplan], envelope="auto")
    return plan, jplan, table.row(0), jtable.row(0), table, jtable


def test_fabric_names_are_the_jax_registry_but_the_unported_hierarchical():
    """The JAX registry's names, the hierarchical fabric among them since its port."""
    assert set(pfab.fabric_names()) == set(jfab.fabric_names())
    assert pfab.fabric_names() == tuple(sorted(pfab.fabric_names()))
    hier, jhier = pfab.get_fabric("hierarchical"), jfab.get_fabric("hierarchical")
    assert type(hier).__name__ == type(jhier).__name__ == "HierarchicalFabric"
    for attr in ("schedule_kind", "requires_envelope", "uses_mesh", "intra_backend", "inter_backend"):
        assert getattr(hier, attr) == getattr(jhier, attr), attr
    for fn in (pfab.get_fabric, jfab.get_fabric):
        with pytest.raises(ValueError, match="unknown dispatch mode 'warp'.*scheduled"):
            fn("warp")


def test_resolve_scheduled_alias_as_jax():
    plan, jplan, row, jrow, *_ = _reg_plans()
    assert pfab.resolve_fabric("scheduled", plan).name == jfab.resolve_fabric("scheduled", jplan).name == "ppermute"
    assert pfab.resolve_fabric("scheduled", row).name == jfab.resolve_fabric("scheduled", jrow).name == "phase_pipelined"
    for name in ("a2a", "dense", "ragged_a2a"):
        assert pfab.resolve_fabric(name).name == jfab.resolve_fabric(name).name == name
    for mod in (pfab, jfab):
        with pytest.raises(ValueError, match="scheduled dispatch needs"):
            mod.resolve_fabric("scheduled", None)


def _validate_cases(plan, row, table, row_no_env, row_n2):
    """(fabric, schedule, n) misuses: every validate_schedule error path."""
    return [
        ("ppermute", row, N_REG), ("ppermute", None, N_REG),
        ("phase_pipelined", plan, N_REG), ("phase_pipelined", None, N_REG), ("phase_pipelined", table, N_REG),
        ("phase_pipelined", row_n2, N_REG), ("ragged_a2a", row_no_env, N_REG), ("ragged_a2a", plan, N_REG),
        ("dense", table, 1), ("ppermute", "a plan", N_REG),
    ]


def test_validate_schedule_errors_name_the_backend_and_the_chain_as_jax():
    plan, jplan, row, jrow, table, jtable = _reg_plans()
    m2 = np.array([[0.0, 30.0], [40.0, 0.0]])
    p2, j2 = plan_schedule(decompose(m2, "maxweight")), jax_plan(jax_decompose(m2, "maxweight"))
    port = _validate_cases(plan, row, table, ScheduleTable.from_schedules([plan]).row(0),
                           ScheduleTable.from_schedules([p2], envelope="auto").row(0))
    ref = _validate_cases(jplan, jrow, jtable, JaxTable.from_schedules([jplan]).row(0),
                          JaxTable.from_schedules([j2], envelope="auto").row(0))
    for (name, sched, n), (_, jsched, _) in zip(port, ref):
        with pytest.raises(ValueError) as got:
            pfab.get_fabric(name).validate_schedule(sched, n=n)
        with pytest.raises(ValueError) as want:
            jfab.get_fabric(name).validate_schedule(jsched, n=n)
        assert str(got.value) == str(want.value), name
        assert str(got.value).startswith(f"{name}: ") and "degradation chain" in str(got.value)
    # what each backend accepts
    assert pfab.get_fabric("a2a").validate_schedule(row, n=N_REG) is None
    assert pfab.get_fabric("dense").validate_schedule(plan, n=N_REG) is None
    assert pfab.get_fabric("dense").validate_schedule(row, n=1) is row
    assert pfab.get_fabric("ppermute").validate_schedule(plan, n=N_REG) is plan


@pytest.mark.parametrize("name", ["dense", "a2a", "phase_pipelined", "ragged_a2a", "ppermute", "faulty:ragged_a2a",
                                  "warp_drive", "hierarchical"])
def test_next_fabric_and_chain_as_jax(name):
    assert pfab.next_fabric(name) == jfab.next_fabric(name)
    assert pfab.DEGRADATION_CHAIN == jfab.DEGRADATION_CHAIN


def test_as_fabric_schedule_as_jax():
    plan, jplan, *_ = _reg_plans()
    for name in ("phase_pipelined", "ragged_a2a", "ppermute", "dense", "scheduled", "a2a"):
        got, want = pfab.as_fabric_schedule(name, plan, 2), jfab.as_fabric_schedule(name, jplan, 2)
        assert type(got).__name__ == type(want).__name__, name
        if isinstance(got, ScheduleTable):
            assert got.num_layers == want.num_layers == 2 and got.envelope == tuple(want.envelope)
            np.testing.assert_array_equal(got.perms.numpy(), np.asarray(want.perms))


def test_wrap_faulty_refuses_a_routed_dark_pair_as_jax():
    plan, jplan, row, jrow, *_ = _reg_plans()
    i, j = next((i, int(plan.perms[k, i])) for k in range(plan.num_phases) for i in range(N_REG) if plan.valid[k, i])
    seed = next(s for s in range(500)
                if FaultScenario("dead_link", n_ranks=N_REG, onset=0, n_links=1, seed=s).dead_pairs == ((i, j),))
    sc, jsc = (cls("dead_link", n_ranks=N_REG, onset=0, n_links=1, seed=seed) for cls in (FaultScenario, JaxScenario))
    assert jsc.dead_pairs == ((i, j),)
    names = []
    try:
        for base in ("ppermute", "phase_pipelined"):
            name, jname = pfab.wrap_faulty(base, sc), jfab.wrap_faulty(base, jsc)
            names.append(name)
            assert name == jname == f"faulty:{base}"
            fab, jf = pfab.get_fabric(name), jfab.get_fabric(jname)
            assert (fab.uses_mesh, fab.schedule_kind, fab.requires_envelope) == (
                jf.uses_mesh, jf.schedule_kind, jf.requires_envelope)
            sched, jsched = (plan, jplan) if base == "ppermute" else (row, jrow)
            for f in (fab, jf):
                f.advance(5)
            with pytest.raises(FabricFaultError) as got:
                fab.validate_schedule(sched, n=N_REG)
            with pytest.raises(JaxFaultError) as want:
                jf.check_transfers(jsched if base == "ppermute" else jplan)
            assert str(got.value) == str(want.value)
            assert (got.value.backend, got.value.pair, got.value.next_fabric) == (base, (i, j), pfab.next_fabric(base))
            assert fab.faults_raised == 1
            fab.advance(-1)  # before the onset the same plan passes
            fab.check_transfers(sched)
            fab.advance(5)  # a plan made under the mask passes during the outage
            masked = plan_schedule(decompose(np.full((N_REG, N_REG), 50.0), "maxweight", link_mask=sc.link_mask(5)))
            fab.check_transfers(masked)
    finally:
        for name in names:
            pfab.FABRICS.pop(name, None)
            jfab.FABRICS.pop(name, None)
    assert "faulty:ppermute" not in pfab.fabric_names()


def test_dispatch_accounting_as_jax():
    plan, jplan, row, jrow, table, jtable = _reg_plans()
    bvn = plan_schedule_bvn(decompose(np.random.default_rng(8).integers(20, 200, (N_REG, N_REG)).astype(float), "bvn"))
    env = np.asarray(table.envelope)
    for name in ("dense", "a2a", "ppermute", "phase_pipelined", "ragged_a2a"):
        for sched in (plan, bvn):
            jsched = JaxPlan(perms=sched.perms, caps=sched.caps, valid=sched.valid, offsets=sched.offsets)
            kw = dict(n=N_REG, cap_uniform=96, envelope=env)
            got = pfab.get_fabric(name).dispatch_tokens(**kw, schedule=sched)
            assert got == jfab.get_fabric(name).dispatch_tokens(**kw, schedule=jsched), name
            for wire in ("bf16", "fp8", "int8"):
                kwb = dict(kw, d_model=4096, wire_dtype=wire)
                assert pfab.get_fabric(name).dispatch_bytes(**kwb, schedule=sched) == \
                    jfab.get_fabric(name).dispatch_bytes(**kwb, schedule=jsched), (name, wire)
    pp, jpp = pfab.get_fabric("phase_pipelined"), jfab.get_fabric("phase_pipelined")
    assert pp.dispatch_tokens_padded(n=N_REG, envelope=env) == jpp.dispatch_tokens_padded(n=N_REG, envelope=env)
    for name, kw in (("ppermute", {}), ("phase_pipelined", {"schedule": plan}), ("ragged_a2a", {"envelope": env})):
        with pytest.raises(ValueError, match=name):
            pfab.get_fabric(name).dispatch_tokens(n=N_REG, **kw)

"""Host-controller parity: the port's ``repro_torch.core`` against the JAX
package's ``repro.core`` on the same seeded numpy inputs.

Planning is float64 numpy/scipy on the host in both packages, with the
same operations in the same order and the same LAP calls, so every
comparison here is exact equality (arrays, dtypes, decisions, counters).
The time counters (``observe_s``, ``fetch_s``, ``score_s``,
``replan_s``) are excluded: they read the host clock.  The sinkhorn
output is held against the reference's output on seeded inputs, not
against a bistochastic property.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.models.attention as jax_attention
import repro.models.layers as jax_layers
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke
from repro.core.maxweight import maxweight_decompose_reference as jax_mw_reference
from repro.core.schedule import phase_offsets as jax_phase_offsets
from repro.core.schedule import plan_schedule_bvn as jax_plan_bvn
from repro.models import Model as JaxModel

import repro_torch.core as pc
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.maxweight import maxweight_decompose_reference
from repro_torch.core.schedule import TABLE_LEAVES, phase_offsets, plan_schedule_bvn
from repro_torch.launch.serve import demand_estimate, serve
from repro_torch.models.transplant import load_reference

SRC = Path(__file__).resolve().parent.parent / "src"
N_RANKS, ROUNDS = 8, 8
SERVE_B, SERVE_S = 4, 256  # the chip phase's serving estimate: 4 x 256 x top-2 routed choices a round


def _traffic(n: int, seed: int, density: float = 0.6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 200, size=(n, n)).astype(np.float64)
    m *= rng.random((n, n)) < density
    return m


def _assert_decomp_equal(port, ref) -> None:
    ps, rs = port.stacked(), ref.stacked()
    for name in ("perms", "alloc", "sent"):
        a, b = getattr(ps, name), getattr(rs, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port.strategy == ref.strategy
    for key in ("n_greedy", "warm_hit", "max_matchings", "min_fill", "link_masked", "unroutable_tokens",
                "frame_tokens", "coefficients", "num_bvn_matchings"):
        assert port.meta.get(key) == ref.meta.get(key), key
    for key in ("local_tokens", "sinkhorn"):
        if key in ref.meta:
            np.testing.assert_array_equal(port.meta[key], ref.meta[key])


def _assert_sched_equal(port, ref) -> None:
    for name in ("perms", "caps", "valid", "offsets"):
        a, b = getattr(port, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _assert_table_equal(port, ref) -> None:
    for name in TABLE_LEAVES:
        a, b = getattr(port, name).cpu().numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port.envelope == ref.envelope


def _decision(d) -> tuple:
    return (d.changed, d.replanned, d.key, d.actions)


# ----------------------------------------------------------- sinkhorn / bvn
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sinkhorn_equals_reference_output(n, seed):
    m = _traffic(n, seed)
    m[seed % n] = 0.0  # an empty row takes the uniform-mass branch
    out = pc.sinkhorn(m)
    ref = jc.sinkhorn(m)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)
    assert pc.is_doubly_stochastic(out) == jc.is_doubly_stochastic(ref)
    assert pc.is_doubly_stochastic(m) == jc.is_doubly_stochastic(m)


@pytest.mark.parametrize("strategy", ["bvn", "bvn-bottleneck"])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_bvn_decompose_equals_reference(strategy, n, seed):
    m = _traffic(n, 20 + seed)
    port, ref = pc.decompose(m, strategy), jc.decompose(m, strategy)
    _assert_decomp_equal(port, ref)
    port.verify()
    _assert_sched_equal(plan_schedule_bvn(port), jax_plan_bvn(ref))
    bottleneck = strategy == "bvn-bottleneck"
    coeffs, jcoeffs = pc.bvn_coefficients(pc.sinkhorn(m), bottleneck=bottleneck), jc.bvn_coefficients(
        jc.sinkhorn(m), bottleneck=bottleneck)
    assert [lam for lam, _ in coeffs] == [lam for lam, _ in jcoeffs]
    for (_, a), (_, b) in zip(coeffs, jcoeffs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bottleneck", [False, True])
def test_bvn_decompose_batch_equals_reference(bottleneck):
    stack = np.stack([_traffic(8, 30 + l) for l in range(3)])
    port = pc.bvn_decompose_batch(stack, bottleneck=bottleneck, max_matchings=12)
    ref = jc.bvn_decompose_batch(stack, bottleneck=bottleneck, max_matchings=12)
    assert len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        _assert_decomp_equal(a, b)
    with pytest.raises(ValueError, match="stack"):
        pc.bvn_decompose_batch(stack[0])


# ---------------------------------------------------------------- maxweight
@pytest.mark.parametrize("min_fill", [0.0, 0.1])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("case", ["cold", "warm_same_support", "warm_changed_support", "max_matchings", "link_mask"])
def test_maxweight_decompose_options_equal_reference(min_fill, n, case):
    m = _traffic(n, 40)
    kwargs, ref_kwargs = {"min_fill": min_fill}, {"min_fill": min_fill}
    if case.startswith("warm"):
        prev, jprev = pc.maxweight_decompose(m, min_fill=min_fill), jc.maxweight_decompose(m, min_fill=min_fill)
        m = m * np.random.default_rng(41).uniform(0.5, 1.5, size=m.shape)  # weight drift, support unchanged
        if case == "warm_changed_support":
            m[0, 1] = 0.0 if m[0, 1] > 0 else 17.0
        kwargs["warm_start"], ref_kwargs["warm_start"] = pc.warm_state_of(prev), jc.warm_state_of(jprev)
        assert dataclasses.astuple(kwargs["warm_start"])[2:] == dataclasses.astuple(ref_kwargs["warm_start"])[2:]
    elif case == "max_matchings":
        kwargs["max_matchings"] = ref_kwargs["max_matchings"] = 3
    elif case == "link_mask":
        mask = jc.FaultScenario("dead_link", n, onset=0, n_links=5, seed=3).link_mask(0)
        kwargs["link_mask"] = ref_kwargs["link_mask"] = mask
    port, ref = pc.maxweight_decompose(m, **kwargs), jc.maxweight_decompose(m, **ref_kwargs)
    _assert_decomp_equal(port, ref)
    port.verify()
    assert port.meta["warm_hit"] == (case == "warm_same_support")
    _assert_decomp_equal(maxweight_decompose_reference(m, min_fill=min_fill), jax_mw_reference(m, min_fill=min_fill))


@pytest.mark.parametrize("min_fill", [0.0, 0.1])
def test_maxweight_decompose_batch_equals_per_layer_calls(min_fill):
    stack = np.stack([_traffic(8, 50 + l) for l in range(4)])
    warm = [None, pc.warm_state_of(pc.maxweight_decompose(stack[1], min_fill=min_fill)), None,
            pc.warm_state_of(pc.maxweight_decompose(stack[0], min_fill=min_fill))]
    jwarm = [None, jc.warm_state_of(jc.maxweight_decompose(stack[1], min_fill=min_fill)), None,
             jc.warm_state_of(jc.maxweight_decompose(stack[0], min_fill=min_fill))]
    mask = np.ones((8, 8), bool)
    mask[2, 5] = False
    batch = pc.maxweight_decompose_batch(stack, min_fill=min_fill, warm_start=warm, link_mask=mask)
    jbatch = jc.maxweight_decompose_batch(stack, min_fill=min_fill, warm_start=jwarm, link_mask=mask)
    for l in range(4):
        _assert_decomp_equal(batch[l], pc.maxweight_decompose(stack[l], min_fill=min_fill, warm_start=warm[l],
                                                                link_mask=mask))
        _assert_decomp_equal(batch[l], jbatch[l])
    assert [d.meta["warm_hit"] for d in batch] == [False, True, False, False]
    # the batched auction (core/lap.py) gives the reference's matchings exactly
    auction = pc.maxweight_decompose_batch(stack, min_fill=min_fill, warm_start=warm, link_mask=mask, backend="jax")
    jauction = jc.maxweight_decompose_batch(stack, min_fill=min_fill, warm_start=jwarm, link_mask=mask, backend="jax")
    for a, b in zip(auction, jauction):
        _assert_decomp_equal(a, b)
        assert a.meta["lap_backend"] == b.meta["lap_backend"] == "jax"


@pytest.mark.parametrize("strategy", ["maxweight", "shift", "bvn", "bvn-bottleneck"])
@pytest.mark.parametrize("masked", [False, True])
def test_decompose_batch_equals_reference(strategy, masked):
    stack = np.stack([_traffic(8, 60 + l) for l in range(3)])
    mask = jc.FaultScenario("dead_link", 8, onset=0, n_links=3, seed=1).link_mask(0) if masked else None
    kwargs = {"min_fill": 0.1} if strategy == "maxweight" else {}
    port = pc.decompose_batch(stack, strategy, link_mask=mask, **kwargs)
    ref = jc.decompose_batch(stack, strategy, link_mask=mask, **kwargs)
    for a, b in zip(port, ref):
        _assert_decomp_equal(a, b)
        np.testing.assert_array_equal(a.meta["local_tokens"], b.meta["local_tokens"])
    if strategy != "maxweight":
        with pytest.raises(ValueError, match="warm_start"):
            pc.decompose_batch(stack, strategy, warm_start=[None] * 3)


# ------------------------------------------------------------------- faults
@pytest.mark.parametrize("kind", ["none", "dead_link", "link_flap", "slow_link", "dark_window"])
def test_fault_scenario_equals_reference(kind):
    port = pc.FaultScenario(kind, 8, onset=2, window=3, n_links=4, seed=5)
    ref = jc.FaultScenario(kind, 8, onset=2, window=3, n_links=4, seed=5)
    assert port.dead_pairs == ref.dead_pairs and port.dark_window_steps == ref.dark_window_steps
    for step in range(8):
        assert port.active(step) == ref.active(step)
        np.testing.assert_array_equal(port.link_mask(step), ref.link_mask(step))
        np.testing.assert_array_equal(port.slow_matrix(step), ref.slow_matrix(step))
    frac = pc.FaultScenario("dead_link", 8, outage_frac=0.2, seed=2)
    assert frac.dead_pairs == jc.FaultScenario("dead_link", 8, outage_frac=0.2, seed=2).dead_pairs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_link_mask_and_check_schedule_mask_equal_reference(seed):
    m = _traffic(8, 70 + seed)
    m[3] = 0.0
    m[3, 4] = 50.0  # a row whose only destination goes dark: unroutable
    mask = jc.FaultScenario("dead_link", 8, onset=0, n_links=6, seed=seed).link_mask(0)
    mask[3, :] = False
    meta, jmeta = {}, {}
    out, ref = pc.apply_link_mask(m, mask, meta=meta), jc.apply_link_mask(m, mask, meta=jmeta)
    assert out.dtype == ref.dtype and np.array_equal(out, ref) and meta == jmeta
    np.testing.assert_array_equal(pc.apply_link_mask(out, mask), out)  # idempotent
    plan = pc.plan_schedule(pc.decompose(m, "maxweight"))
    jplan = jc.plan_schedule(jc.decompose(m, "maxweight"))
    with pytest.raises(pc.FabricFaultError) as err:
        pc.check_schedule_mask([plan], mask, backend="phase_pipelined", next_fabric="a2a", step=4)
    with pytest.raises(jc.FabricFaultError) as jerr:
        jc.check_schedule_mask([jplan], mask, backend="phase_pipelined", next_fabric="a2a", step=4)
    assert str(err.value) == str(jerr.value)
    assert (err.value.pair, err.value.phase, err.value.next_fabric) == (jerr.value.pair, jerr.value.phase, "a2a")
    masked = pc.plan_schedule(pc.decompose(m, "maxweight", link_mask=mask))
    pc.check_schedule_mask(masked, mask)  # a plan made under the mask passes


# ----------------------------------------------------------------- selector
def _regimes(n: int) -> list[np.ndarray]:
    base = _traffic(n, 80, density=0.9) + 1.0
    hot = base.copy()
    hot[:, 2] *= 6.0
    shifted = np.roll(base, 3, axis=1)
    return [base, hot, shifted]


@pytest.mark.parametrize(
    "opts",
    [
        {},
        {"hysteresis": 0.3},
        {"cooldown": 2},
        {"replan_penalty": 0.05},
        {"max_library": 2},
        {"hysteresis": 0.1, "cooldown": 1, "replan_penalty": 0.02, "max_library": 3, "ema": 0.6},
    ],
)
def test_selector_propose_sequence_equals_reference(opts):
    evicted, jevicted = [], []
    port = pc.ScheduleSelector(8, on_evict=lambda e: evicted.append(e.name), **opts)
    ref = jc.ScheduleSelector(8, on_evict=lambda e: jevicted.append(e.name), **opts)
    regimes = _regimes(8)
    seq = [0, 0, 1, 1, 1, 2, 2, 0, 0, 1, 2, 2, 0, 1, 1, 0]
    actions = []
    for step, r in enumerate(seq):
        t = regimes[r] * (1.0 + 0.01 * step)
        outs = []
        for sel in (port, ref):
            p = sel.propose(t)
            entry = sel._plan(sel.smoothed, f"plan{sel.replans}") if p.action == "miss" else p.entry
            outs.append((p.action, None if p.entry is None else p.entry.name, p.drop, entry.name, sel.adopt(entry)))
        assert outs[0] == outs[1], step
        np.testing.assert_array_equal(port.smoothed, ref.smoothed)
        actions.append(outs[0][0])
    assert (port.replans, port.switches, port.evictions) == (ref.replans, ref.switches, ref.evictions)
    assert [e.name for e in port.library] == [e.name for e in ref.library]
    assert evicted == jevicted
    assert "miss" in actions and "keep" in actions
    if opts.get("max_library") == 2:
        assert evicted, "the LRU bound never evicted"
    entry, jentry = port.current, ref.current
    assert entry.drop_fraction(regimes[1]) == jentry.drop_fraction(regimes[1])
    assert entry.drop_fraction_reference(regimes[1]) == jentry.drop_fraction_reference(regimes[1])
    assert entry.mismatch(regimes[2]) == jentry.mismatch(regimes[2])


def test_selector_observe_equals_reference():
    port, ref = pc.ScheduleSelector(8, hysteresis=0.2, cooldown=1), jc.ScheduleSelector(8, hysteresis=0.2, cooldown=1)
    for step, r in enumerate([0, 1, 1, 2, 0, 1]):
        t = _regimes(8)[r]
        (e, ch), (je, jch) = port.observe(t), ref.observe(t)
        assert (e.name, ch) == (je.name, jch), step
        _assert_sched_equal(e.schedule, je.schedule)
    port.purge()
    assert port.current is None and not port.library and port.smoothed is None


# ----------------------------------------------------------------- schedule
@pytest.mark.parametrize("strategy", ["maxweight", "bvn"])
@pytest.mark.parametrize("how", ["asis", "lpt", "spt", "johnson3"])
def test_order_phases_equals_reference(strategy, how):
    m = _traffic(8, 90)
    port, ref = pc.order_phases(pc.decompose(m, strategy), how), jc.order_phases(jc.decompose(m, strategy), how)
    _assert_decomp_equal(port, ref)
    assert port.total_duration_tokens == ref.total_duration_tokens
    for a, b in zip(port.phases, ref.phases):
        assert (a.duration_tokens, a.tokens_sent) == (b.duration_tokens, b.tokens_sent)
        np.testing.assert_array_equal(a.recv_tokens(), b.recv_tokens())
        np.testing.assert_array_equal(a.sent_matrix(), b.sent_matrix())
    np.testing.assert_array_equal(port.stacked().durations(), ref.stacked().durations())
    np.testing.assert_array_equal(port.stacked().recv_tokens(), ref.stacked().recv_tokens())
    np.testing.assert_array_equal(port.sent_total(), ref.sent_total())
    with pytest.raises(ValueError, match="ordering"):
        pc.order_phases(pc.decompose(m, strategy), "random")


@pytest.mark.parametrize("n", [4, 8])
def test_ring_schedule_phase_offsets_and_bvn_table_equal_reference(n):
    port, ref = pc.ring_schedule(n, 24), jc.ring_schedule(n, 24)
    _assert_sched_equal(port, ref)
    bvn = [plan_schedule_bvn(pc.decompose(_traffic(n, 100 + l), "bvn")) for l in range(2)]
    jbvn = [jax_plan_bvn(jc.decompose(_traffic(n, 100 + l), "bvn")) for l in range(2)]
    for a, b in zip(bvn, jbvn):
        _assert_sched_equal(a, b)
        np.testing.assert_array_equal(phase_offsets(a.perms, a.valid, a.caps), jax_phase_offsets(b.perms, b.valid, b.caps))
        assert a.multi_phase and b.multi_phase
        assert (a.total_capacity, a.pair_capacity()) == (b.total_capacity, b.pair_capacity())
        np.testing.assert_array_equal(a.cap_matrix(), b.cap_matrix())
        np.testing.assert_array_equal(a.cap_matrix(a.caps // 2), b.cap_matrix(b.caps // 2))
    mw, jmw = pc.plan_schedule(pc.decompose(_traffic(n, 7), "maxweight")), jc.plan_schedule(jc.decompose(_traffic(n, 7), "maxweight"))
    assert not mw.multi_phase and (mw.total_capacity, mw.pair_capacity()) == (jmw.total_capacity, jmw.pair_capacity())
    np.testing.assert_array_equal(mw.cap_matrix(), jmw.cap_matrix())
    k_max = max(s.num_phases for s in bvn)
    _assert_table_equal(
        pc.ScheduleTable.from_schedules(bvn, k_max=k_max, envelope="auto"),
        jc.ScheduleTable.from_schedules(jbvn, k_max=k_max, envelope="auto"),
    )


def test_schedule_table_update_and_in_place_fill_equal_reference():
    first = [pc.plan_schedule(pc.decompose(_traffic(8, 110 + l), "maxweight")) for l in range(3)]
    jfirst = [jc.plan_schedule(jc.decompose(_traffic(8, 110 + l), "maxweight")) for l in range(3)]
    second = [pc.plan_schedule(pc.decompose(_traffic(8, 120 + l), "maxweight"), cap_quantile=0.9) for l in range(3)]
    jsecond = [jc.plan_schedule(jc.decompose(_traffic(8, 120 + l), "maxweight"), cap_quantile=0.9) for l in range(3)]
    for a, b in zip(second, jsecond):
        _assert_sched_equal(a, b)
    table = pc.ScheduleTable.from_schedules(first, k_max=6, clip=True, envelope="auto")
    jtable = jc.ScheduleTable.from_schedules(jfirst, k_max=6, clip=True, envelope="auto")
    updated, jupdated = table.update(second), jtable.update(jsecond)
    _assert_table_equal(updated, jupdated)
    assert updated.envelope == table.envelope and updated.perms.data_ptr() != table.perms.data_ptr()
    snapshot = table.clone()
    ptrs = {name: getattr(table, name).data_ptr() for name in TABLE_LEAVES}
    assert table.fill_(second) is table
    _assert_table_equal(table, jupdated)
    assert {name: getattr(table, name).data_ptr() for name in TABLE_LEAVES} == ptrs
    _assert_table_equal(snapshot, jtable)  # the clone kept the first plans
    with pytest.raises(ValueError, match="schedules for 3 layers"):
        table.fill_(second[:2])
    with pytest.raises(ValueError, match="full table"):
        table.row(0).update(second)


# ------------------------------------------------------ controller parity
def _mixtral(layers: int):
    return (dataclasses.replace(jax_get_config("mixtral-8x7b"), n_layers=layers),
            dataclasses.replace(get_config("mixtral-8x7b"), n_layers=layers))


def _assert_counts_equal(port, ref) -> None:
    keys = ("replan_events", "decompose_calls", "warm_hits", "cold_plans", "switches", "phase_clips",
            "library_sizes", "steps", "envelope_growths", "envelope_shrinks", "envelope", "admitted_dropped",
            "health_state", "active_fabric", "fallback_active", "quarantines", "probe_failures", "fabric_faults",
            "masked_replans", "dark_window_steps", "link_masked")
    pm, rm = port.metrics(), ref.metrics()
    assert {k: pm[k] for k in keys} == {k: rm[k] for k in keys}
    for key in ("observe_us_per_step", "fetch_us_per_step", "score_us_per_step", "replan_ms_per_event"):
        assert pm[key] >= 0.0
    assert pm["table_rebuilds"] == 1 + pm["envelope_growths"] + pm["envelope_shrinks"]


class _PtrWatch:
    """Holds the table tensors' addresses between rebuilds."""

    def __init__(self):
        self.rebuilds, self.ptrs = None, None

    def check(self, runtime, table) -> None:
        ptrs = tuple(getattr(table, name).data_ptr() for name in TABLE_LEAVES)
        if runtime.table_rebuilds == self.rebuilds:
            assert ptrs == self.ptrs, "a swap inside the envelope moved the table's storage"
        self.rebuilds, self.ptrs = runtime.table_rebuilds, ptrs


@pytest.mark.parametrize("kind", ["none", "shift", "hotspot", "skew"])
def test_serving_controller_round_by_round_equals_reference(kind):
    jcfg, pcfg = _mixtral(4)
    ref, jscen = jc.make_serving_controller(jcfg, n_ranks=N_RANKS, drift=kind, rounds=ROUNDS)
    port, scen = pc.make_serving_controller(pcfg, n_ranks=N_RANKS, drift=kind, rounds=ROUNDS, device="cpu")
    tokens = float(SERVE_B * SERVE_S * pcfg.moe.top_k)
    watch, replans_after_0 = _PtrWatch(), 0
    for r in range(ROUNDS):
        est = demand_estimate(pcfg, tokens, scen, r)
        jest = np.broadcast_to(tokens * jscen.expert_probs(r)[None, None, :], (ref.n_layers, 1, 8))
        np.testing.assert_array_equal(est, jest)
        d, jd = port.observe(est), ref.observe(jest)
        assert _decision(d) == _decision(jd), r
        replans_after_0 += r > 0 and d.replanned
        table = port.table()
        _assert_table_equal(table, ref.table())
        watch.check(port, table)
    _assert_counts_equal(port, ref)
    if kind in ("shift", "hotspot"):
        assert replans_after_0 >= 1
    if kind == "hotspot":
        assert port.envelope_growths >= 1 and port.table_rebuilds == 2


def test_layer_grouped_runtime_with_decay_faults_and_fallback_equals_reference():
    """group_by="layer", envelope decay, a link-flap episode (the envelope
    frozen while masked), a hard fault, drop spikes and a fallback chain."""
    chain = ("phase_pipelined", "a2a", "dense")
    kw = dict(n_ranks=8, n_experts=8, group_by="layer", envelope_decay=0.5, shrink_patience=1, cooldown=1, ema=0.7,
              fallback_chain=chain, probe_backoff=2, recover_after=1, quarantine_after=1, max_library=3)
    port = pc.ScheduleRuntime(pc.ControllerConfig(**kw), 3, device="cpu")
    ref = jc.ScheduleRuntime(jc.ControllerConfig(**kw), 3)
    faults, jfaults = pc.FaultScenario("link_flap", 8, onset=6, window=3, n_links=4, seed=1), \
        jc.FaultScenario("link_flap", 8, onset=6, window=3, n_links=4, seed=1)
    port.attach_faults(pc.FaultScenario("dark_window", 8))
    ref.attach_faults(jc.FaultScenario("dark_window", 8))
    rng = np.random.default_rng(7)
    base = rng.dirichlet(np.full(8, 0.3), size=(3, 8)) * 4000.0  # [L, n_src, E]
    watch, fabrics, jfabrics, frozen = _PtrWatch(), [], [], []
    primed = base.sum(axis=1)[:, None, :].repeat(8, 1) / 8.0  # [L, n, n]
    assert _decision(port.prime(primed)) == _decision(ref.prime(primed))
    for step in range(16):
        hot = base.copy()
        if 2 <= step < 5:
            hot[:, :, 1] *= 8.0  # a hot expert: the envelope grows, then decays back
        dropped = np.array([0.4 * hot.sum() if step in (3, 11) else 0.01 * hot.sum()])
        mask = faults.link_mask(step)
        np.testing.assert_array_equal(mask, jfaults.link_mask(step))
        for rt in (port, ref):
            rt.set_link_mask(None if mask.all() else mask)
        env_before = port.envelope()
        if step == 7:
            err = pc.FabricFaultError("link down", link_mask=mask)
            port.record_fault(err)
            ref.record_fault(jc.FabricFaultError("link down", link_mask=mask))
        d = port.observe({"routing": hot, "dropped": dropped})
        jd = ref.observe({"routing": hot, "dropped": dropped})
        assert _decision(d) == _decision(jd), step
        table = port.table()
        _assert_table_equal(table, ref.table())
        watch.check(port, table)
        if not mask.all():
            frozen.append(np.array_equal(port.envelope(), env_before))
        fabrics.append(port.active_fabric())
        jfabrics.append(ref.active_fabric())
        assert port.health_state == ref.health_state and port.next_fabric() == ref.next_fabric()
        np.testing.assert_array_equal(port.link_mask if port.link_mask is not None else 0,
                                      ref.link_mask if ref.link_mask is not None else 0)
    assert fabrics == jfabrics and len(set(fabrics)) > 1
    _assert_counts_equal(port, ref)
    assert frozen and all(frozen), "the envelope moved while a link mask was set"
    m = port.metrics()
    assert m["envelope_growths"] >= 1 and m["envelope_shrinks"] >= 1 and m["masked_replans"] >= 1
    assert m["quarantines"] >= 1 and m["dark_window_steps"] > 0


def test_controller_config_checks_and_hierarchical_dispatch():
    for bad in ({"n_experts": 9}, {"group_by": "pod"}, {"replan_penalty": -1.0}, {"envelope_decay": 1.0},
                {"shrink_patience": 0}, {"fallback_chain": ("a2a", "a2a")}, {"fallback_chain": ("",)},
                {"quarantine_after": 0}, {"drop_spike_frac": 0.0}, {"probe_backoff": 0}, {"recover_after": 0}):
        with pytest.raises(ValueError):
            pc.ControllerConfig(**{"n_ranks": 8, "n_experts": 8, **bad})
    assert pc.ControllerConfig(8, 8, fallback_chain=["a2a", "dense"]).fallback_chain == ("a2a", "dense")
    _, pcfg = _mixtral(2)
    hier = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="hierarchical"))
    with pytest.raises(NotImplementedError, match="M10"):
        pc.make_serving_controller(hier, n_ranks=8)
    assert pc.make_serving_controller(pcfg, n_ranks=3) == (None, None)
    runtime = pc.ScheduleRuntime(pc.ControllerConfig(8, 8), 2)
    with pytest.raises(ValueError, match="no schedules yet"):
        runtime.table()


def test_fault_hook_drives_the_runtime_as_the_reference():
    kw = dict(n_ranks=8, n_experts=8, group_by="model", fallback_chain=("phase_pipelined", "dense"))
    port, ref = pc.ScheduleRuntime(pc.ControllerConfig(**kw), 2), jc.ScheduleRuntime(jc.ControllerConfig(**kw), 2)
    stats = np.random.default_rng(3).dirichlet(np.full(8, 0.5), size=(2, 8)) * 3000.0
    hook = pc.fault_hook(pc.FaultScenario("link_flap", 8, onset=1, window=2, n_links=6, seed=0), port)
    jhook = jc.fault_hook(jc.FaultScenario("link_flap", 8, onset=1, window=2, n_links=6, seed=0), ref)
    for step in range(5):
        outcomes = []
        for rt, hk, exc in ((port, hook, pc.FabricFaultError), (ref, jhook, jc.FabricFaultError)):
            rt.observe(stats)
            rt.table()
            try:
                hk(step)
                outcomes.append(None)
            except exc as err:
                outcomes.append((str(err), err.pair, err.phase))
                rt.record_fault(err)
        assert outcomes[0] == outcomes[1], step
        _assert_table_equal(port.table(), ref.table())
    _assert_counts_equal(port, ref)


# --------------------------------------------------------------- end to end
def test_serve_under_shift_drift_equals_jax_controller_and_prefill(monkeypatch):
    """The port's launcher under --drift shift: each round's table equals
    the JAX runtime's for the same estimates, and a prefill under round
    3's (re-planned) table matches the JAX model's under the JAX table in
    f32, at the tolerance of tests/test_torch_model.py."""
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(jax_attention, "USE_PALLAS_FLASH", True)
    jcfg = jax_smoke("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch="phase_pipelined", use_pallas=True))
    pcfg = smoke_config("mixtral-8x7b")
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="phase_pipelined"))
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=torch.float32)
    rounds = 4
    res = serve(model, batch=SERVE_B, prompt_len=SERVE_S, new_tokens=1, rounds=rounds, drift="shift")
    ref, scen = jc.make_serving_controller(jcfg, n_ranks=N_RANKS, drift="shift", rounds=rounds)
    tokens = float(SERVE_B * SERVE_S * pcfg.moe.top_k)
    jtables = []
    for r in range(rounds):
        jd = ref.observe(np.broadcast_to(tokens * scen.expert_probs(r)[None, None, :], (ref.n_layers, 1, 8)))
        assert _decision(res.decisions[r]) == _decision(jd), r
        jtables.append(ref.table())
        _assert_table_equal(res.tables[r], jtables[-1])
    assert any(d.replanned for d in res.decisions[1:]), "shift never re-planned"
    assert not np.array_equal(res.tables[3].caps.numpy(), res.tables[0].caps.numpy())
    _assert_table_equal(res.table, jtables[-1])
    assert res.controller[-1]["table_rebuilds"] == 1 and res.controller[-1]["replan_events"] == ref.replan_events

    b, s = 2, 64
    prompts = np.random.default_rng(3).integers(0, pcfg.vocab_size, size=(b, s)).astype(np.int32)
    jmodel = JaxModel(jcfg)
    jlogits, _ = jax.jit(jmodel.prefill)(params, jnp.asarray(prompts), jmodel.init_cache(b, s, jnp.float32),
                                         schedule=jtables[3])
    plogits, _ = model.prefill(torch.from_numpy(prompts), model.init_cache(b, s, torch.float32), schedule=res.tables[3])
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits, np.float32), rtol=1e-4, atol=1e-4)


def test_serve_cli_runs_shift_drift_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--controller", "--drift", "shift",
           "--device", "cpu"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "controller:" in res.stderr and "table rebuilds" in res.stderr

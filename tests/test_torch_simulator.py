"""The paper's cost models, baselines, simulator and traces: the port's
numpy copies (``repro_torch.core``) against ``repro.core`` on the same
seeded inputs, bit for bit in float64 (the same numpy/scipy operations in
the same order), the reference's own simulator cases run on the port,
and ``repro_torch.launch.simulate`` against the JAX benchmark it mirrors.
"""

import dataclasses

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # fall back to the deterministic in-repo sweep
    from _hyp_compat import given, settings
    from _hyp_compat import strategies as st

import repro.core as jc
from benchmarks.fig3_small_batch import makespans as jax_makespans

import repro_torch.core as pc
from repro_torch.core.traffic import RouterConfig
from repro_torch.launch import simulate

COMM = pc.CommModel(tokens_per_us=100.0, reconf_us=0.01)
KNEE = pc.knee_model()
LINEAR = pc.linear_model()


def _skewed(rng, n=8, scale=4000):
    m = np.floor(rng.random((n, n)) ** 4 * scale)
    np.fill_diagonal(m, 0.0)
    return m


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


# --------------------------------------------------------------- bit for bit
@pytest.mark.parametrize("wire", ["bf16", "fp8", "int8"])
@pytest.mark.parametrize("d", [32, 4096, 6144])
def test_wire_pricing_equals_reference(wire, d):
    assert pc.WIRE_DTYPES == jc.WIRE_DTYPES
    for cb in (2, 4):
        assert pc.wire_bytes_per_token(d, wire, cb) == jc.wire_bytes_per_token(d, wire, cb)
    with pytest.raises(ValueError, match="bf16, fp8, int8"):
        pc.wire_bytes_per_token(d, "fp4")


def test_compute_models_equal_reference():
    b = np.array([0, 1, 7, 255, 256, 257, 4096, 1e6])
    for p, j in (
        (pc.knee_model(), jc.knee_model()),
        (pc.knee_model(floor_us=120.0, knee_tokens=300), jc.knee_model(floor_us=120.0, knee_tokens=300)),
        (pc.linear_model(), jc.linear_model()),
        (pc.linear_model(per_token_us=0.3), jc.linear_model(per_token_us=0.3)),
    ):
        assert _fields(p) == _fields(j)
        np.testing.assert_array_equal(p(b), j(b))
        assert p(3.0) == j(3.0) and isinstance(p(3.0), float)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_knee_equals_reference_on_a_noisy_profile(seed):
    rng = np.random.default_rng(seed)
    b = np.array([1, 4, 16, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384], np.float64)
    floor, slope = rng.uniform(50, 300), rng.uniform(0.1, 1.5)
    t = np.maximum(floor, slope * b) * (1 + 0.05 * rng.standard_normal(b.size))
    perm = rng.permutation(b.size)  # the fit sorts by batch itself
    p, j = pc.fit_knee(b[perm], t[perm]), jc.fit_knee(b[perm], t[perm])
    assert _fields(p) == _fields(j)
    assert p.per_token_us > 0


@pytest.mark.parametrize("wire", ["bf16", "fp8", "int8"])
def test_comm_model_equals_reference(wire):
    kw = dict(link_gbps=400.0, d_model=6144, reconf_us=0.01, wire_dtype=wire, replan_dark_us=3.5)
    p, j = pc.CommModel.from_hardware(**kw), jc.CommModel.from_hardware(**kw)
    assert _fields(p) == _fields(j)
    tokens = np.random.default_rng(3).random(17) * 1e4
    np.testing.assert_array_equal(p.comm_us(tokens), j.comm_us(tokens))
    assert p.comm_us(123.0) == j.comm_us(123.0)
    for step in (0.0, 1.0, 4096.0):
        assert p.replan_penalty(step) == j.replan_penalty(step)


def test_dispatch_accounting_equals_reference():
    rng = np.random.default_rng(4)
    for n, cap in ((8, 37), (16, 0), (4, 1024)):
        assert pc.a2a_dispatch_tokens(n, cap) == jc.a2a_dispatch_tokens(n, cap)
    valid, caps = rng.random((6, 8)) < 0.6, rng.integers(0, 300, 6)
    np.testing.assert_array_equal(pc.phase_dispatch_tokens(valid, caps), jc.phase_dispatch_tokens(valid, caps))
    d, c, b = rng.random(9) * 50, rng.random(9) * 80, rng.random(9) * 30
    assert pc.pipeline_makespan(d, c, b) == jc.pipeline_makespan(d, c, b)
    assert pc.pipeline_makespan(d, c) == jc.pipeline_makespan(d, c)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_baselines_equal_reference(seed):
    rng = np.random.default_rng(seed)
    m = _skewed(rng) if seed % 2 else rng.integers(0, 900, (6, 6)).astype(np.float64)
    assert pc.ideal_a2a_tokens(m) == jc.ideal_a2a_tokens(m)
    for norm in (True, False):
        assert pc.ring_a2a_tokens(m, normalize_nic=norm) == jc.ring_a2a_tokens(m, normalize_nic=norm)
    assert pc.ring_a2a_tokens(np.zeros((4, 4))) == jc.ring_a2a_tokens(np.zeros((4, 4))) == 0.0
    assert pc.ideal_a2a_tokens(np.zeros((0, 0))) == 0.0


@pytest.mark.parametrize("strat", ["bvn", "maxweight", "shift"])
@pytest.mark.parametrize("fabric", ["dual", "single"])
@pytest.mark.parametrize("overlap", [True, False])
def test_simulate_decomposition_equals_reference(strat, fabric, overlap):
    rng = np.random.default_rng(5)
    m = _skewed(rng)
    local = rng.random(8) * 500
    pd, jd = pc.decompose(m, strat), jc.decompose(m, strat)
    for compute in ((KNEE, jc.knee_model()), (LINEAR, jc.linear_model())):
        for loc in (None, local):
            p = pc.simulate_decomposition(pd, compute[0], COMM, overlap=overlap, fabric=fabric, local_tokens=loc)
            j = jc.simulate_decomposition(jd, compute[1], jc.CommModel(tokens_per_us=100.0, reconf_us=0.01),
                                          overlap=overlap, fabric=fabric, local_tokens=loc)
            assert _fields(p) == _fields(j)


def test_simulate_zero_phases_and_bad_fabric_as_reference():
    d = pc.decompose(np.zeros((4, 4)), "maxweight")
    local = np.array([0.0, 300.0, 0.0, 10.0])
    p = pc.simulate_decomposition(d, KNEE, COMM, local_tokens=local)
    j = jc.simulate_decomposition(jc.decompose(np.zeros((4, 4)), "maxweight"), jc.knee_model(),
                                  jc.CommModel(tokens_per_us=100.0, reconf_us=0.01), local_tokens=local)
    assert _fields(p) == _fields(j)
    with pytest.raises(ValueError, match="unknown fabric"):
        pc.simulate_decomposition(pc.decompose(_skewed(np.random.default_rng(0)), "bvn"), KNEE, COMM, fabric="triple")


@pytest.mark.parametrize("seed", [0, 6])
def test_sequential_and_ideal_equal_reference(seed):
    m = _skewed(np.random.default_rng(seed))
    jcomm = jc.CommModel(tokens_per_us=100.0, reconf_us=0.01)
    for pm, jm in ((KNEE, jc.knee_model()), (LINEAR, jc.linear_model())):
        assert _fields(pc.simulate_sequential(m, pm, COMM)) == _fields(jc.simulate_sequential(m, jm, jcomm))
        assert _fields(pc.simulate_ideal(m, pm, COMM)) == _fields(jc.simulate_ideal(m, jm, jcomm))


def test_routers_and_workloads_equal_reference():
    assert set(pc.ROUTERS) == set(jc.ROUTERS) and len(pc.ROUTERS) == 6
    for name, r in pc.ROUTERS.items():
        j = jc.ROUTERS[name]
        assert _fields(r) == _fields(j)
        assert r.expert_us_per_token() == j.expert_us_per_token()
        assert r.expert_us_per_token(eff_tflops=123.0) == j.expert_us_per_token(eff_tflops=123.0)
        assert r.token_bytes() == j.token_bytes() and r.token_bytes(4) == j.token_bytes(4)
    assert {k: _fields(w) for k, w in pc.WORKLOADS.items()} == {k: _fields(w) for k, w in jc.WORKLOADS.items()}


@pytest.mark.parametrize("router", sorted(jc.ROUTERS))
@pytest.mark.parametrize("workload", ["mmlu", "speed"])
def test_gen_trace_equals_reference(router, workload):
    kw = dict(iterations=3, seed=11)
    for p, j in zip(pc.gen_trace(router, workload, **kw), jc.gen_trace(router, workload, **kw)):
        np.testing.assert_array_equal(p, j)
    p = pc.gen_trace(router, workload, n_ranks=4, iterations=2, seed=1, skew_alpha=1.5)
    j = jc.gen_trace(router, workload, n_ranks=4, iterations=2, seed=1, skew_alpha=1.5)
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a, b)


def test_core_exports_what_the_reference_exports():
    names = ("WIRE_DTYPES", "CommModel", "ComputeModel", "a2a_dispatch_tokens", "fit_knee", "knee_model",
             "linear_model", "phase_dispatch_tokens", "pipeline_makespan", "wire_bytes_per_token", "ideal_a2a_tokens",
             "ring_a2a_tokens", "SimResult", "simulate_decomposition", "simulate_ideal", "simulate_sequential",
             "ROUTERS", "WORKLOADS", "gen_trace", "traffic_matrix")
    for name in names:
        assert name in pc.__all__ and name in jc.__all__
        assert hasattr(pc, name)


# ------------------------------------------- the reference's cases, on the port
class TestSimulatorInvariants:
    def test_zero_matrix(self):
        d = pc.decompose(np.zeros((8, 8)), "maxweight")
        assert pc.simulate_decomposition(d, KNEE, COMM).makespan_us == 0.0

    def test_makespan_at_least_compute(self):
        rng = np.random.default_rng(0)
        for strat in ("bvn", "maxweight", "shift"):
            r = pc.simulate_decomposition(pc.decompose(_skewed(rng), strat), KNEE, COMM)
            assert r.makespan_us >= r.compute_us - 1e-9

    def test_makespan_at_least_network_lower_bound(self):
        d = pc.decompose(_skewed(np.random.default_rng(1)), "maxweight")
        r = pc.simulate_decomposition(d, KNEE, COMM)
        assert r.makespan_us >= r.dispatch_us - 1e-9

    def test_single_fabric_slower_or_equal_dual(self):
        rng = np.random.default_rng(2)
        for _ in range(5):
            d = pc.decompose(_skewed(rng), "maxweight")
            dual = pc.simulate_decomposition(d, KNEE, COMM, fabric="dual")
            single = pc.simulate_decomposition(d, KNEE, COMM, fabric="single")
            assert single.makespan_us >= dual.makespan_us - 1e-6

    def test_ideal_lower_bounds_ring(self):
        rng = np.random.default_rng(3)
        for _ in range(5):
            m = _skewed(rng)
            assert pc.simulate_ideal(m, LINEAR, COMM).makespan_us <= pc.simulate_sequential(m, LINEAR, COMM).makespan_us + 1e-6

    def test_local_tokens_extend_compute(self):
        m = np.zeros((4, 4))
        m[0, 1] = 1000.0
        d = pc.decompose(m, "maxweight")
        base = pc.simulate_decomposition(d, LINEAR, COMM)
        heavy = pc.simulate_decomposition(d, LINEAR, COMM, local_tokens=np.array([0.0, 1e6, 0.0, 0.0]))
        assert heavy.makespan_us > base.makespan_us

    @given(st.integers(min_value=0, max_value=2**31 - 1))
    @settings(max_examples=20, deadline=None)
    def test_property_overlap_never_hurts_with_linear_compute(self, seed):
        d = pc.decompose(_skewed(np.random.default_rng(seed), n=6), "maxweight")
        ovl = pc.simulate_decomposition(d, LINEAR, COMM, overlap=True)
        seq = pc.simulate_decomposition(d, LINEAR, COMM, overlap=False)
        assert ovl.makespan_us <= seq.makespan_us + 1e-6


class TestPaperClaims:
    def _mean_makespan(self, mats, strat, compute, overlap=True):
        out = []
        for m in mats:
            d = pc.decompose(m, strat)
            out.append(pc.simulate_decomposition(d, compute, COMM, overlap=overlap,
                                                 local_tokens=d.meta["local_tokens"]).makespan_us)
        return float(np.mean(out))

    def test_bvn_more_phases_than_maxweight(self):
        for m in pc.gen_trace("mixtral-8x22b", "speed", iterations=8, seed=0):
            assert pc.decompose(m, "bvn").num_phases > pc.decompose(m, "maxweight").num_phases

    def test_small_batch_overlapped_bvn_worse_than_nonoverlapped(self):
        mats = pc.gen_trace("mixtral-8x22b", "mmlu", iterations=12, seed=1)
        assert self._mean_makespan(mats, "bvn", KNEE, overlap=True) > self._mean_makespan(mats, "bvn", KNEE, overlap=False)

    def test_large_batch_maxweight_beats_bvn(self):
        mats = pc.gen_trace("mixtral-8x22b", "speed", iterations=12, seed=2)
        assert self._mean_makespan(mats, "maxweight", KNEE) < self._mean_makespan(mats, "bvn", KNEE)

    def test_large_batch_maxweight_approaches_ideal(self):
        mats = pc.gen_trace("mixtral-8x22b", "speed", iterations=12, seed=3)
        ideal = float(np.mean([pc.simulate_ideal(m, KNEE, COMM).makespan_us for m in mats]))
        assert self._mean_makespan(mats, "maxweight", KNEE) <= 1.25 * ideal

    def test_small_batch_static_ring_competitive(self):
        mats = pc.gen_trace("mixtral-8x22b", "mmlu", iterations=12, seed=4)
        ring = float(np.mean([pc.simulate_sequential(m, KNEE, COMM).makespan_us for m in mats]))
        assert ring < self._mean_makespan(mats, "bvn", KNEE, overlap=True)


# --------------------------------------------------- launch/simulate.py
@pytest.mark.parametrize("workload", ["mmlu", "speed"])
def test_paper_tables_equal_the_fig3_benchmark(workload):
    """Under the paper's knee model and comm model, ``paper_tables`` is
    ``benchmarks/fig3_small_batch.py``'s ``makespans`` on the same trace."""
    router = "mixtral-8x7b"
    jcomm = jc.CommModel.from_hardware(link_gbps=400.0, d_model=jc.ROUTERS[router].d_model, reconf_us=0.01)
    ref = jax_makespans(router, workload, jc.knee_model(), jcomm, iterations=4, seed=simulate.TRACE_SEED)
    got = simulate.paper_tables(router, pc.knee_model(), workload=workload, iterations=4)
    assert got == ref
    ratios = simulate.headline(got)
    assert ratios == {"mw_vs_ideal": ref["maxweight+ovl"] / ref["ideal"],
                      "bvn_ovl_vs_ring": ref["bvn+ovl"] / ref["ring-seq"]}


def test_rank_batch_spreads_rows_round_robin_in_whole_tiles():
    import torch

    router = pc.ROUTERS["qwen3-moe"]
    x, rv = simulate.rank_batch(dataclasses.replace(router, d_model=64), 37, device="cpu")
    assert x.shape == (16, 64, 64) and x.dtype == torch.bfloat16
    assert rv.sum(1).tolist() == [3] * 5 + [2] * 11
    x, rv = simulate.rank_batch(dataclasses.replace(pc.ROUTERS["mixtral-8x7b"], d_model=64), 129, device="cpu")
    assert x.shape == (1, 192, 64) and int(rv.sum()) == 129


def test_profile_knee_on_the_cpu_returns_fits():
    """On a CPU tensor K1's wrapper runs its plain version: the profile
    still has one positive time per batch size, and both fits."""
    router = RouterConfig("tiny", n_experts=16, top_k=2, d_model=64, d_ff=64)
    batches = (1, 4, 16, 64, 128, 256)
    prof = simulate.profile_knee(router, batches, device="cpu", reps=2)
    assert prof.batches == list(batches) and prof.experts == 2 and prof.device == "cpu"
    assert len(prof.device_us) == len(prof.call_us) == len(batches)
    assert all(np.isfinite(t) and t > 0 for t in prof.device_us + prof.call_us)
    for fit in (prof.device_fit, prof.call_fit):
        assert isinstance(fit, pc.ComputeModel) and fit.per_token_us > 0 and fit.floor_us > 0
        assert _fields(fit) == _fields(pc.fit_knee(np.array(batches), np.array(
            prof.device_us if fit is prof.device_fit else prof.call_us)))
    lines = simulate.knee_lines(prof)
    assert len(lines) == len(batches) + 2 and "paper: floor 250 us" in lines[-1]


def test_simulate_main_on_the_cpu():
    (prof,) = simulate.main(["--routers", "dbrx", "--device", "cpu", "--smoke"])
    assert prof.router == "dbrx" and prof.experts == 2 and len(prof.batches) == 6

"""The two-level (pod-aware) path of the port against ``repro.core``'s and
``repro.parallel.fabric``'s own functions on the same seeded numpy inputs:
every check of ``tests/test_hierarchical.py``, run on the port and held
against the reference, plus the hierarchical cases of
``tests/test_fabric.py`` and ``tests/test_decompose.py`` on the
one-device virtual fabric.

Exact where the arithmetic is the same: the traffic split, the host and
traced planners' leaves (integer-valued greedy phases, the reference's
tie-breaks), the merged row and the pair caps, the runtimes' decisions
and metrics.  The device controller's f32 leaves are held within 1e-6
relative (``tests/test_torch_device_controller.py``'s rule: the order of
the f32 sums behind ``drop``); the MoE layer's outputs within 1e-5 in
f32 (the expert GEMMs sum in another order), its stats exactly.  One
difference of the port's idiom: a runtime refills its table's tensors in
place (``ScheduleRuntime.table``), so a test keeping a table across a
re-plan takes ``clone()``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.models.layers as jax_layers
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoECfg as JaxMoECfg
from repro.models import moe as jax_moe
from repro.parallel import fabric as jfab

import repro_torch.core as pc
from repro_torch.configs import ModelConfig, MoECfg
from repro_torch.models import moe as pmoe
from repro_torch.parallel import fabric as pfab

N = 4
E = 8
LEAVES = ("perms", "caps", "valid", "offsets", "n_phases")


def _traffic(seed: int = 0, n: int = N, scale: float = 300.0):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) * scale
    np.fill_diagonal(m, 0)
    return m


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _table_equal(port, ref):
    """A port ``ScheduleTable`` (or row) equal to a JAX one, leaf for leaf."""
    for name in LEAVES:
        np.testing.assert_array_equal(_np(getattr(port, name)), _np(getattr(ref, name)), err_msg=name)
    assert port.envelope == (None if ref.envelope is None else tuple(ref.envelope))


def _htable_equal(port, ref):
    assert isinstance(port, pc.HierarchicalTable) and port.pod_size == ref.pod_size
    _table_equal(port.intra, ref.intra)
    _table_equal(port.inter, ref.inter)


def _decomp_equal(port, ref):
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    ps, rs = port.stacked(), ref.stacked()
    for name in ("perms", "alloc", "sent"):
        np.testing.assert_array_equal(getattr(ps, name), getattr(rs, name), err_msg=name)
    assert port.strategy == ref.strategy


class TestPodSizeValidation:
    def test_error_names_n_pod_size_and_divisors(self):
        with pytest.raises(ValueError) as got:
            pc.check_pod_size(8, 3)
        with pytest.raises(ValueError) as want:
            jc.check_pod_size(8, 3)
        assert str(got.value) == str(want.value)
        assert "pod_size=3" in str(got.value) and "n=8" in str(got.value)

    def test_valid_pod_size_returns_it(self):
        for p in (1, 2, 4, 8):
            assert pc.check_pod_size(8, p) == jc.check_pod_size(8, p) == p

    @pytest.mark.parametrize("bad", (0, -2))
    def test_nonpositive_pod_size_rejected(self, bad):
        with pytest.raises(ValueError, match=f"pod_size={bad}"):
            pc.check_pod_size(8, bad)

    def test_split_traffic_propagates(self):
        with pytest.raises(ValueError, match="pod_size=3"):
            pc.split_traffic(np.zeros((8, 8)), 3)
        with pytest.raises(ValueError, match="pod_size=3"):
            pc.split_traffic_traced(torch.zeros((8, 8)), 3)

    def test_fabric_validate_propagates(self):
        """The hierarchical and dense fabrics reject a mis-sized row with the
        reference's messages."""
        prow = dataclasses.replace(pc.hierarchical_plan(_traffic(), 2, n_layers=1).row(0), pod_size=3)
        jrow = dataclasses.replace(jc.hierarchical_plan(_traffic(), 2, n_layers=1).row(0), pod_size=3)
        for name in ("hierarchical", "dense"):
            with pytest.raises(ValueError) as got:
                pfab.get_fabric(name).validate_schedule(prow, n=N)
            with pytest.raises(ValueError) as want:
                jfab.get_fabric(name).validate_schedule(jrow, n=N)
            assert str(got.value) == str(want.value) and "pod_size=3" in str(got.value), name


class TestSplitTraffic:
    def test_partition_is_exact_and_equal(self):
        m = _traffic()
        (pi, pe), (ji, je) = pc.split_traffic(m, 2), jc.split_traffic(m, 2)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pe, je)
        np.testing.assert_array_equal(pi + pe, m)
        same = pc.same_pod_mask(N, 2)
        np.testing.assert_array_equal(same, jc.same_pod_mask(N, 2))
        assert (pi[~same] == 0).all() and (pe[same] == 0).all()

    def test_batched_leading_dims(self):
        m = np.stack([_traffic(s) for s in range(6)]).reshape(2, 3, N, N)
        (pi, pe), (ji, je) = pc.split_traffic(m, 2), jc.split_traffic(m, 2)
        assert pi.shape == pe.shape == (2, 3, N, N)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pe, je)

    def test_traced_twin_matches_host_and_jax(self):
        m = _traffic(3)
        ti, te = pc.split_traffic_traced(torch.from_numpy(m), 2)
        ji, je = jax.jit(lambda a: jc.split_traffic_traced(a, 2))(jnp.asarray(m))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        intra, inter = pc.split_traffic(m, 2)
        np.testing.assert_allclose(ti.numpy(), intra, rtol=1e-6)
        np.testing.assert_allclose(te.numpy(), inter, rtol=1e-6)


class TestDiagonalExclusionInvariant:
    def setup_method(self):
        self.m = _traffic(1)
        np.fill_diagonal(self.m, 50.0)  # local tokens the phases must not carry
        self.intra_d, self.inter_d = pc.hierarchical_decompose(self.m, 2)

    def test_equal_to_the_reference(self):
        ji, je = jc.hierarchical_decompose(self.m, 2)
        _decomp_equal(self.intra_d, ji)
        _decomp_equal(self.inter_d, je)

    def test_union_matrix_has_zero_diagonal(self):
        np.testing.assert_array_equal(np.diag(self.intra_d.matrix), 0.0)
        np.testing.assert_array_equal(np.diag(self.inter_d.matrix), 0.0)

    def test_partition_conserves_demand(self):
        np.testing.assert_allclose(self.intra_d.matrix + self.inter_d.matrix + np.diag(np.diag(self.m)), self.m)

    def test_no_phase_carries_local_tokens(self):
        src = np.arange(N)
        for d, within_pod in ((self.intra_d, True), (self.inter_d, False)):
            st = d.stacked()
            active = st.sent > 0
            assert not (active & (st.perms == src)).any(), d.strategy
            crosses = (src // 2)[None, :] != (st.perms // 2)
            assert not (active & crosses).any() if within_pod else (crosses | ~active).all()

    def test_phase_tokens_equal_offdiagonal_intra_mass(self):
        intra, _ = pc.split_traffic(self.m, 2)
        off = intra.copy()
        np.fill_diagonal(off, 0.0)
        assert self.intra_d.stacked().sent.sum() == pytest.approx(off.sum())

    def test_simulate_hierarchical_equal(self):
        got = pc.simulate_hierarchical(self.m, 2, pc.ComputeModel(5.0, 0.01), pc.CommModel(100.0, reconf_us=0.05),
                                       pc.CommModel(25.0, reconf_us=15.0))
        want = jc.simulate_hierarchical(self.m, 2, jc.ComputeModel(5.0, 0.01), jc.CommModel(100.0, reconf_us=0.05),
                                        jc.CommModel(25.0, reconf_us=15.0))
        assert got == want
        assert got["hier_us"] > 0 and got["flat_us"] > 0 and np.isfinite(got["speedup"])
        assert got["intra_phases"] > 0 and got["inter_phases"] > 0


class TestHierarchicalTable:
    def setup_method(self):
        self.m = np.stack([_traffic(s) for s in (0, 7)])
        self.tab = pc.hierarchical_plan(self.m, 2)
        self.jtab = jc.hierarchical_plan(self.m, 2)

    def test_plan_equal_and_shapes(self):
        _htable_equal(self.tab, self.jtab)
        assert not self.tab.is_row and self.tab.num_layers == 2 and self.tab.n == N
        assert self.tab.k_max == self.tab.intra.k_max + self.tab.inter.k_max == self.jtab.k_max
        row = self.tab.row(1)
        assert row.is_row and row.pod_size == 2
        _htable_equal(row, self.jtab.row(1))

    @pytest.mark.parametrize("plan_kw", [{}, dict(decompose_kwargs={"min_fill": 0.1}, slack=1.1, cap_quantile=0.9),
                                         dict(k_max_intra=1, k_max_inter=2, slack=1.3)])
    def test_plan_knobs_equal(self, plan_kw):
        _htable_equal(pc.hierarchical_plan(self.m, 2, **plan_kw), jc.hierarchical_plan(self.m, 2, **plan_kw))

    def test_merged_folds_served_prefixes(self):
        row, jrow = self.tab.row(0), self.jtab.row(0)
        mr = row.merged()
        _table_equal(mr, jrow.merged())
        ki, ke = row.intra.k_max, row.inter.k_max
        assert mr.k_max == ki + ke and int(mr.n_phases) == ki + ke
        caps = mr.caps.numpy()
        assert (caps[int(row.intra.n_phases):ki] == 0).all()
        assert (caps[ki + int(row.inter.n_phases):] == 0).all()
        np.testing.assert_array_equal(caps[:int(row.intra.n_phases)],
                                      row.intra.caps.numpy()[:int(row.intra.n_phases)])
        np.testing.assert_array_equal(mr.envelope_t.numpy(), np.asarray(mr.envelope))
        _table_equal(self.tab.merged(), self.jtab.merged())  # the full table too

    def test_pair_caps_additive_over_levels(self):
        row, jrow = self.tab.row(0), self.jtab.row(0)
        total = row.pair_caps(2).numpy()
        np.testing.assert_array_equal(total, np.asarray(jrow.pair_caps(2)))
        np.testing.assert_array_equal(total, row.intra.pair_caps(2).numpy() + row.inter.pair_caps(2).numpy())
        np.testing.assert_array_equal(total, row.merged().pair_caps(2).numpy())
        same = pc.same_pod_mask(N, 2)
        assert (row.intra.pair_caps(2).numpy()[~same] == 0).all()
        assert (row.inter.pair_caps(2).numpy()[same] == 0).all()
        assert row.envelope_slots(2) == jrow.envelope_slots(2)

    def test_update_swaps_one_level(self):
        i_d, _ = pc.hierarchical_decompose(self.m[0] * 0.5, 2)
        ji_d, _ = jc.hierarchical_decompose(self.m[0] * 0.5, 2)
        alt = self.tab.update(intra=self.tab.intra.update([pc.plan_schedule(i_d)] * 2))
        jalt = self.jtab.update(intra=self.jtab.intra.update([jc.plan_schedule(ji_d)] * 2))
        assert alt.inter is self.tab.inter and alt.pod_size == self.tab.pod_size
        assert alt.intra.k_max == self.tab.intra.k_max
        _htable_equal(alt, jalt)

    def test_clone_keeps_pod_size_and_leaves(self):
        """The port's counterpart of the pytree round trip: a copy with storage of its own."""
        back = self.tab.clone()
        assert isinstance(back, pc.HierarchicalTable) and back.pod_size == self.tab.pod_size
        _htable_equal(back, self.jtab)
        assert back.intra.perms.data_ptr() != self.tab.intra.perms.data_ptr()


def _traced(m, **kw):
    port = pc.hierarchical_plan_traced(torch.from_numpy(np.asarray(m, np.float32)), 2, **kw)
    ref = jax.jit(lambda a: jc.hierarchical_plan_traced(a, 2, **kw))(jnp.asarray(m, jnp.float32))
    for level in ("intra", "inter"):
        for name in ("perms", "caps", "valid", "n_phases"):
            np.testing.assert_array_equal(port[level][name].numpy(), np.asarray(ref[level][name]),
                                          err_msg=f"{level} {name}")
    return port


class TestTracedPlanner:
    def test_union_perms_are_pod_local_permutations(self):
        out = _traced(_traffic(5)[None], k_max_intra=2, k_max_inter=N)
        pod, src = np.arange(N) // 2, np.arange(N)
        for level, kmax in (("intra", 2), ("inter", N)):
            perms = out[level]["perms"].numpy()[0]
            assert perms.shape == (kmax, N)
            for k, p in enumerate(perms):
                np.testing.assert_array_equal(np.sort(p), src, err_msg=f"{level} phase {k}")
            assert int(out[level]["n_phases"][0]) <= kmax
        ip, iv = out["intra"]["perms"].numpy()[0], out["intra"]["valid"].numpy()[0]
        assert (pod[ip] == pod[None, :]).all() and not (iv & (ip == src[None, :])).any()
        ep, ev = out["inter"]["perms"].numpy()[0], out["inter"]["valid"].numpy()[0]
        assert ((pod[ep] != pod[None, :]) | ~ev).all()

    def test_enough_phases_serve_the_whole_split(self):
        m = _traffic(9)
        out = _traced(m[None], k_max_intra=2, k_max_inter=N, quantum=1, min_cap=1)
        intra, inter = pc.split_traffic(m, 2)
        src = np.arange(N)
        for level, demand in (("intra", intra), ("inter", inter)):
            perms, valid = out[level]["perms"].numpy()[0], out[level]["valid"].numpy()[0]
            caps = out[level]["caps"].numpy()[0].astype(float)
            served = np.zeros((N, N))
            for k in range(perms.shape[0]):
                on = valid[k]
                served[src[on], perms[k][on]] += caps[k]
            assert (served + 1e-6 >= demand).all(), level

    def test_layers_and_a_link_mask_equal(self):
        """Several layers, 8 ranks in pods of 2, a dead cross-pod and a dead same-pod pair."""
        m = np.stack([_traffic(s, n=8) for s in (11, 12, 13)])
        mask = np.ones((8, 8), bool)
        mask[0, 5] = mask[2, 3] = False
        out = _traced(m, k_max_intra=2, k_max_inter=5, slack=1.1, mask=mask)
        v = out["inter"]["valid"].numpy()
        p = out["inter"]["perms"].numpy()
        assert not (v & (p == 5) & (np.arange(8) == 0)[None, None, :]).any()


def _rt_pair(**kw):
    cfg = dict(n_ranks=N, n_experts=E, **kw)
    return (pc.HierarchicalRuntime(pc.ControllerConfig(**cfg), 1, pod_size=2),
            jc.HierarchicalRuntime(jc.ControllerConfig(**cfg), 1, pod_size=2))


# the runtime metrics both packages report (tests/test_torch_controller.py's list; the host-time keys differ)
COUNTS = ("replan_events", "decompose_calls", "warm_hits", "cold_plans", "switches", "phase_clips", "library_sizes",
          "steps", "envelope_growths", "envelope_shrinks", "envelope", "admitted_dropped", "health_state",
          "active_fabric", "fallback_active", "quarantines", "probe_failures", "fabric_faults", "masked_replans",
          "dark_window_steps", "link_masked")


def _metrics_equal(port, ref):
    for p, r in ((port, ref), (port["intra"], ref["intra"])):
        assert {k: p[k] for k in COUNTS} == {k: r[k] for k in COUNTS}
    assert port["pod_size"] == ref["pod_size"]


class TestRuntimeIndependence:
    def setup_method(self):
        self.m = _traffic(0)
        self.rt, self.jrt = _rt_pair()
        self.rt.prime(self.m)
        self.jrt.prime(self.m)

    def test_pod_size_validated_at_init(self):
        with pytest.raises(ValueError, match="pod_size=3"):
            pc.HierarchicalRuntime(pc.ControllerConfig(n_ranks=N, n_experts=8), 1, pod_size=3)

    def test_table_pairs_both_levels(self):
        tab = self.rt.table()
        assert isinstance(tab, pc.HierarchicalTable) and tab.pod_size == 2 and tab.num_layers == 1
        _htable_equal(tab, self.jrt.table())

    def test_intra_drift_leaves_inter_plan_untouched(self):
        inter0 = self.rt.inter_table()
        inter0_copy, intra0 = inter0.clone(), self.rt.intra.table().clone()
        self.jrt.inter_table(), self.jrt.intra.table()  # the same calls on the reference (tables fix envelopes)
        inter_replans0 = self.rt.metrics()["replan_events"]
        intra, inter = pc.split_traffic(self.m, 2)
        drift = np.where(pc.same_pod_mask(N, 2), intra[::-1, ::-1].T * 4.0, inter)
        np.fill_diagonal(drift, 0)
        replanned = False
        for _ in range(8):
            d = self.rt.observe_traffic(drift[None])
            jd = self.jrt.observe_traffic(drift[None])
            assert (d.changed, d.replanned, d.key, d.actions) == (jd.changed, jd.replanned, jd.key, jd.actions)
            replanned |= d.replanned
        assert replanned
        met = self.rt.metrics()
        assert met["replan_events"] == inter_replans0 and met["intra"]["replan_events"] > 1
        _metrics_equal(met, self.jrt.metrics())
        _table_equal(self.rt.inter_table(), inter0_copy)
        assert self.rt.inter_table() is inter0  # the inter level's tensors were not even refilled
        assert not all(torch.equal(getattr(self.rt.intra.table(), k), getattr(intra0, k)) for k in LEAVES)
        _htable_equal(self.rt.table(), self.jrt.table())

    def test_link_masks_apply_per_level(self):
        for a, b, intra_n, inter_n in ((0, 1, 1, 0), (0, 2, 1, 1)):
            mask = np.ones((N, N), bool)
            mask[a, b] = mask[b, a] = False
            for rt in (self.rt, self.jrt):
                rt.set_link_mask(None) if (a, b) == (0, 2) else None
                rt.set_link_mask(mask)
            met = self.rt.metrics()
            assert met["intra"]["masked_replans"] == intra_n and met["masked_replans"] == inter_n
            _metrics_equal(met, self.jrt.metrics())
            _htable_equal(self.rt.table(), self.jrt.table())

    def test_metrics_nest_the_intra_level(self):
        met = self.rt.metrics()
        assert met["pod_size"] == 2 and "replan_events" in met["intra"]
        _metrics_equal(met, self.jrt.metrics())

    def test_observe_routing_counts_equal(self):
        """``observe`` (routing counts folded to traffic, dropped counts) drives both levels as JAX's."""
        rng = np.random.default_rng(4)
        for _ in range(5):
            stats = rng.integers(0, 200, (1, N, E)).astype(np.float64)
            d, jd = self.rt.observe(stats, dropped=np.ones((1, N))), self.jrt.observe(stats, dropped=np.ones((1, N)))
            assert (d.changed, d.replanned, d.key) == (jd.changed, jd.replanned, jd.key)
        _metrics_equal(self.rt.metrics(), self.jrt.metrics())
        _htable_equal(self.rt.table(), self.jrt.table())


# ----------------------------------------------------- the device controller
def _stats_of(traffic):
    """[L, n, n] rank traffic -> [L, n, E] routing counts folding back to it."""
    t = np.asarray(traffic, dtype=np.float64)
    return np.repeat(t / (E // t.shape[1]), E // t.shape[1], axis=2)


class _CtrlPair:
    """The JAX two-level controller and the port's, lifted from twin
    runtimes and stepped together; ``check`` compares every leaf of both
    levels."""

    def __init__(self, **rt_kw):
        self.prt, self.jrt = _rt_pair(ema=1.0, cooldown=0, **rt_kw)
        m = _traffic(0) + 20.0
        np.fill_diagonal(m, 0.0)
        self.prt.prime(m)
        self.jrt.prime(m)
        self.pctrl, self.ps = pc.HierarchicalDeviceController.from_runtime(self.prt)
        self.jctrl, self.js = jc.HierarchicalDeviceController.from_runtime(self.jrt)
        self._jstep = jax.jit(self.jctrl.step)
        self.check()

    def step(self, stats, n=1, dropped=None):
        for _ in range(n):
            self.js = self._jstep(self.js, jnp.asarray(stats), None if dropped is None else jnp.asarray(dropped))
            self.pctrl.step(self.ps, stats, dropped)
            self.check()
        return self.pctrl.metrics(self.ps)

    def check(self):
        for level in ("intra", "inter"):
            jleaves = jax.tree.leaves(getattr(self.js, level))
            pleaves = getattr(self.ps, level).leaves()
            assert len(jleaves) == len(pleaves)
            for (name, p), j in zip(pleaves.items(), jleaves):
                p, j = p.numpy(), np.asarray(j)
                assert p.dtype == j.dtype and p.shape == j.shape, (level, name)
                if p.dtype.kind == "f":
                    np.testing.assert_allclose(p, j, rtol=1e-6, atol=0, err_msg=f"{level} {name}")
                else:
                    np.testing.assert_array_equal(p, j, err_msg=f"{level} {name}")
        pm, jm = self.pctrl.metrics(self.ps), self.jctrl.metrics(self.js)
        assert pm.keys() == jm.keys()
        for key in ("steps", "device_replans", "drop_spikes", "regime_warm_swaps"):
            assert pm[key] == jm[key], key


class TestDeviceController:
    def test_from_runtime_adopts_both_levels(self):
        pair = _CtrlPair()
        dev, tbl = pair.pctrl.table_of(pair.ps), pair.prt.table()
        _htable_equal(dev, pair.jctrl.table_of(pair.js))
        for level in ("intra", "inter"):
            for name in ("perms", "caps", "valid", "n_phases"):
                np.testing.assert_array_equal(getattr(getattr(dev, level), name).numpy(),
                                              getattr(getattr(tbl, level), name).numpy())
        assert pair.pctrl.pod_size == 2 and pair.pctrl.cfg is pair.pctrl.inter.cfg

    def test_intra_drift_fires_only_the_intra_level(self):
        pair = _CtrlPair()
        intra, inter = pc.split_traffic(_traffic(0) + 20.0, 2)
        hot = np.where(pc.same_pod_mask(N, 2), intra * 40.0, inter)
        np.fill_diagonal(hot, 0.0)
        inter_perms = pair.ps.inter.perms.clone()
        m = pair.step(_stats_of(hot[None]), n=4)
        assert m["intra"]["device_replans"] >= 1 and m["inter"]["device_replans"] == 0
        assert torch.equal(pair.ps.inter.perms, inter_perms)

    def test_inter_drift_and_dropped_counts(self):
        pair = _CtrlPair()
        intra, inter = pc.split_traffic(_traffic(0) + 20.0, 2)
        hot = np.where(pc.same_pod_mask(N, 2), intra, inter * 40.0)
        np.fill_diagonal(hot, 0.0)
        m = pair.step(_stats_of(hot[None]), n=4, dropped=np.full((1, N), 1e5))
        assert m["inter"]["device_replans"] >= 1 and m["drop_spikes"] >= 1

    def test_step_device_and_replan_are_the_step(self):
        """The engine's split: ``step_device`` (no host read) then ``replan``
        when ``fire`` is set equals ``step``, leaf for leaf."""
        pair = _CtrlPair()
        hot = np.where(pc.same_pod_mask(N, 2), 0.0, 900.0)
        stats = _stats_of(hot[None])
        twin = pair.ps.clone()
        fired = False
        for _ in range(3):
            out = pair.pctrl.step_device(twin, torch.from_numpy(stats))
            if bool(out.fire):
                fired = True
                pair.pctrl.replan(twin, out.routable, warm=bool(out.warm), best=int(out.best))
            pair.step(stats)
            for level in ("intra", "inter"):
                for name, leaf in getattr(twin, level).leaves().items():
                    assert torch.equal(leaf, getattr(getattr(pair.ps, level), name)), (level, name)
        assert fired

    def test_set_link_mask_per_level(self):
        pair = _CtrlPair()
        mask = np.ones((N, N), bool)
        mask[0, 2] = mask[2, 0] = False
        pair.js = pair.jctrl.set_link_mask(pair.js, mask)
        pair.pctrl.set_link_mask(pair.ps, mask)
        pair.check()
        m = pair.pctrl.metrics(pair.ps)
        assert m["inter"]["link_masked"] and not m["intra"]["link_masked"]

    def test_init_state_from_a_table_equal(self):
        pair = _CtrlPair()
        m = _traffic(3)
        mask = np.ones((N, N), bool)
        mask[1, 0] = False
        ps = pair.pctrl.init_state(pair.prt.table(), traffic=m[None], link_mask=mask)
        js = pair.jctrl.init_state(pair.jrt.table(), traffic=m[None], link_mask=mask)
        for level in ("intra", "inter"):
            for (name, p), j in zip(getattr(ps, level).leaves().items(), jax.tree.leaves(getattr(js, level))):
                np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=f"{level} {name}")


# ------------------------------------------------ the MoE layer on one device
def _moe_kw(dispatch, **kw):
    out = dict(n_experts=E, top_k=2, d_ff_expert=32, dispatch=dispatch, capacity_factor=8.0)
    out.update(kw)
    return out


def _jcfg(dispatch="dense", **kw):
    return JaxModelConfig(name="fabric-test", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                          d_ff=64, vocab_size=128, moe=JaxMoECfg(**_moe_kw(dispatch, **kw)), remat="none")


def _pcfg(dispatch="dense", **kw):
    return ModelConfig(name="fabric-test", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       vocab_size=128, moe=MoECfg(**_moe_kw(dispatch, **kw)), remat="none")


def _hrows(pod_size=2, seed=2, **plan_kw):
    m = _traffic(seed, scale=400.0)
    return (pc.hierarchical_plan(m, pod_size, n_layers=1, **plan_kw).row(0),
            jc.hierarchical_plan(m, pod_size, n_layers=1, **plan_kw).row(0))


class TestHierarchicalSingleDevice:
    """``tests/test_fabric.py``'s one-device leg of the composed fabric:
    the port's layer against JAX's (values, stats, gradients) and against
    its own dense oracle handed the same row."""

    @pytest.fixture(autouse=True)
    def _f32(self, monkeypatch):
        """The reference computes in f32 here, as the port's f32 layer does."""
        monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)

    def _jax(self, cfg, row, stats=False):
        return jax.jit(lambda prm, v: jax_moe.moe_apply(prm, cfg, v, schedule=row, return_stats=stats))(
            self.jparams, jnp.asarray(self.x))

    def setup_method(self):
        params = jax.tree.map(np.asarray, jax_moe.moe_init(jax.random.PRNGKey(0), _jcfg()))
        self.jparams = params
        self.p = pmoe.moe_init(_pcfg(), gen=None, device="cpu", dtype=torch.float32)
        self.p.router.data.copy_(torch.from_numpy(np.array(params["router"]["w"])))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(self.p, name).data.copy_(torch.from_numpy(np.array(params[name])))
        for prm in self.p.parameters():
            prm.requires_grad_()
        self.x = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 32, 32), jnp.float32))

    @torch.no_grad()
    def _port(self, cfg, row, x=None, stats=True):
        return pmoe.moe_apply(self.p, cfg, torch.from_numpy(self.x if x is None else x), schedule=row,
                              return_stats=stats)

    @pytest.mark.parametrize("pod_size", (2, 4))
    def test_values_grads_stats_match_jax_and_the_dense_oracle(self, pod_size):
        prow, jrow = _hrows(pod_size)
        y, st = self._port(_pcfg("hierarchical", pod_size=pod_size), prow)
        jy, jst = self._jax(_jcfg("hierarchical", pod_size=pod_size), jrow, stats=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        for key in ("routing", "dropped"):
            np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]), err_msg=key)
        assert st["routing"].shape == (1, E) and st["dropped"].shape == (1,)
        y_ref, st_ref = self._port(_pcfg(), prow)  # the dense oracle with the same composed row
        np.testing.assert_array_equal(y.numpy(), y_ref.numpy())
        for key in st:
            np.testing.assert_array_equal(st[key].numpy(), st_ref[key].numpy())
        # gradients against JAX's
        x = torch.from_numpy(self.x).requires_grad_()
        (pmoe.moe_apply(self.p, _pcfg("hierarchical", pod_size=pod_size), x, schedule=prow) ** 2).sum().backward()
        jg = jax.jit(jax.grad(lambda p, xx: (jax_moe.moe_apply(p, _jcfg("hierarchical", pod_size=pod_size), xx,
                                                               schedule=jrow) ** 2).sum(), argnums=(0, 1)))(
            self.jparams, jnp.asarray(self.x))
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg[1]), rtol=1e-4, atol=1e-4)
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(getattr(self.p, name).grad.numpy(), np.asarray(jg[0][name]), rtol=1e-4,
                                       atol=1e-4, err_msg=name)

    def test_admission_binds_like_a_flat_row(self):
        tiny = np.full((N, N), 1.0)
        np.fill_diagonal(tiny, 0)
        prow = pc.hierarchical_plan(tiny, 2, n_layers=1, min_cap=1, quantum=1).row(0)
        jrow = jc.hierarchical_plan(tiny, 2, n_layers=1, min_cap=1, quantum=1).row(0)
        y_row, st = self._port(_pcfg("hierarchical"), prow)
        y_free, _ = self._port(_pcfg(), None)
        assert not np.allclose(y_row.numpy(), y_free.numpy(), atol=1e-6)
        jy, jst = self._jax(_jcfg("hierarchical"), jrow, stats=True)
        np.testing.assert_allclose(y_row.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(st["dropped"].numpy(), np.asarray(jst["dropped"]))

    def test_wire_crosses_only_the_pod_seam(self):
        """fp8 quantizes only pod-crossing slots: one pod over every rank
        leaves the output bit for bit, two pods engage it (within the
        reference's fp8 tolerance of the bf16 wire, and equal to JAX's
        fp8 output to the codec's step), the stats unchanged either way."""
        prow4, _ = _hrows(4)
        y4, _ = self._port(_pcfg("hierarchical", pod_size=4), prow4)
        y4q, _ = self._port(_pcfg("hierarchical", pod_size=4, wire_dtype="fp8"), prow4)
        np.testing.assert_array_equal(y4q.numpy(), y4.numpy())
        prow2, jrow2 = _hrows(2)
        y2, st2 = self._port(_pcfg("hierarchical"), prow2)
        y2q, st2q = self._port(_pcfg("hierarchical", wire_dtype="fp8"), prow2)
        err = float((y2q - y2).abs().max())
        assert 0.0 < err <= 0.15, err  # tests/test_fabric.py's TestWireDtypeParity.VALUE_TOL["fp8"]
        for key in st2:
            np.testing.assert_array_equal(st2q[key].numpy(), st2[key].numpy())
        jy2q = self._jax(_jcfg("hierarchical", wire_dtype="fp8"), jrow2)
        # one e4m3 step (amax / 14) of the largest expert output, as tests/test_torch_codec.py holds it
        assert float(np.abs(y2q.numpy() - np.asarray(jy2q)).max()) <= float(np.abs(np.asarray(jy2q)).max()) / 14 + 1e-5

    @torch.no_grad()
    def test_the_wire_mask_is_the_pod_seam(self):
        """The dense fabric's packed ``wire`` under a hierarchical row marks
        exactly the live slots whose virtual source and rank lie in two pods."""
        prow, _ = _hrows(2)
        cfg = _pcfg("hierarchical")
        fab = pfab.get_fabric("dense")
        ctx = pfab.FabricContext(cfg=cfg, schedule=prow)
        x = torch.from_numpy(self.x.reshape(-1, 32))
        idx, gates = pmoe._router(self.p, cfg, x)
        packed = fab.pack(ctx, x, idx, gates)
        t = x.shape[0]
        src = (packed.pos * N) // t
        dst = (torch.arange(E) // (E // N))[:, None]
        np.testing.assert_array_equal(packed.wire.numpy(), (packed.live & (src // 2 != dst // 2)).numpy())


class TestAccountingAndRegistry:
    def test_dispatch_tokens_and_bytes_as_jax(self):
        prow, jrow = _hrows(2, seed=4)
        pf, jf = pfab.get_fabric("hierarchical"), jfab.get_fabric("hierarchical")
        assert pf.dispatch_tokens_split(n=N, schedule=prow) == {
            k: float(v) for k, v in jf.dispatch_tokens_split(n=N, schedule=jrow).items()}
        assert pf.dispatch_tokens(n=N, schedule=prow) == float(jf.dispatch_tokens(n=N, schedule=jrow))
        for wire in ("bf16", "fp8", "int8"):
            kw = dict(d_model=4096, wire_dtype=wire, n=N)
            assert pf.dispatch_bytes(**kw, schedule=prow) == float(jf.dispatch_bytes(**kw, schedule=jrow)), wire
        with pytest.raises(ValueError, match="hierarchical accounting"):
            pf.dispatch_tokens(n=N)

    def test_registry_and_validation_as_jax(self):
        assert pfab.get_fabric("hierarchical").name == jfab.get_fabric("hierarchical").name == "hierarchical"
        prow, jrow = _hrows(2)
        assert pfab.get_fabric("hierarchical").validate_schedule(prow, n=N) is prow
        plain = pc.ScheduleTable.from_schedules([pc.plan_schedule(pc.decompose(_traffic(), "maxweight"))],
                                                envelope="auto").row(0)
        jplain = jc.ScheduleTable.from_schedules([jc.plan_schedule(jc.decompose(_traffic(), "maxweight"))],
                                                 envelope="auto").row(0)
        noenv = dataclasses.replace(prow, inter=dataclasses.replace(prow.inter, envelope=None, envelope_t=None))
        jnoenv = dataclasses.replace(jrow, inter=dataclasses.replace(jrow.inter, envelope=None))
        for sched, jsched, n in ((plain, jplain, N), (noenv, jnoenv, N), (prow, jrow, 8)):
            with pytest.raises(ValueError) as got:
                pfab.get_fabric("hierarchical").validate_schedule(sched, n=n)
            with pytest.raises(ValueError) as want:
                jfab.get_fabric("hierarchical").validate_schedule(jsched, n=n)
            assert str(got.value) == str(want.value)
        full, jfull = pc.hierarchical_plan(_traffic(), 2), jc.hierarchical_plan(_traffic(), 2)
        with pytest.raises(ValueError) as got:
            pfab.get_fabric("dense").validate_schedule(full, n=1)
        with pytest.raises(ValueError) as want:
            jfab.get_fabric("dense").validate_schedule(jfull, n=1)
        assert str(got.value) == str(want.value)


# ------------------------------------------- tests/test_decompose.py's cases
def _two_pod_traffic(seed=0, n=16, pod=8, locality=0.8):
    rng = np.random.default_rng(seed)
    m = np.floor(rng.random((n, n)) * 200)
    cross = (np.arange(n)[:, None] // pod) != (np.arange(n)[None, :] // pod)
    m = np.where(cross, np.floor(m * (1 - locality)), m)
    np.fill_diagonal(m, 0.0)
    return m


class TestHierarchicalDecompose:
    def test_split_partitions_traffic(self):
        m = _two_pod_traffic()
        intra, inter = pc.split_traffic(m, 8)
        np.testing.assert_allclose(intra + inter, m)
        assert inter[:8, :8].sum() == 0 and intra[:8, 8:].sum() == 0

    def test_hierarchical_delivers_everything(self):
        m = _two_pod_traffic(seed=1)
        intra_d, inter_d = pc.hierarchical_decompose(m, 8)
        ji, je = jc.hierarchical_decompose(m, 8)
        _decomp_equal(intra_d, ji)
        _decomp_equal(inter_d, je)
        intra_d.verify()
        inter_d.verify()
        np.testing.assert_allclose(intra_d.sent_total() + inter_d.sent_total(), m, atol=1e-6)

    def test_hierarchical_beats_flat_on_local_traffic(self):
        m = _two_pod_traffic(seed=2, locality=0.9)
        got = pc.simulate_hierarchical(m, 8, pc.ComputeModel(20.0, 0.05), pc.CommModel(100.0, reconf_us=0.05),
                                       pc.CommModel(12.5, reconf_us=10.0))
        want = jc.simulate_hierarchical(m, 8, jc.ComputeModel(20.0, 0.05), jc.CommModel(100.0, reconf_us=0.05),
                                        jc.CommModel(12.5, reconf_us=10.0))
        assert got == want
        assert got["speedup"] > 1.0

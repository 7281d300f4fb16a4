"""Device-controller parity: the port's auction LAP (``core/lap.py``) and
``DeviceController`` against the JAX package's ``repro.core`` on the same
seeded numpy inputs, case by case as ``tests/test_lap_jax.py`` holds the
reference (seeded parametrized cases in place of its hypothesis
properties).

The auction's arithmetic is integer-valued f32 with the reference's
tie-breaks, so permutations and plans are compared for equality, not
only their weight.  Controller sequences: after every step each integer
and bool leaf of the state is exactly equal, each f32 leaf within 1e-6
relative (the order of the f32 sums behind ``drop`` differs between XLA
and PyTorch), and the decisions follow from the leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import repro.core as jc

import repro_torch.core as pc
from repro_torch.core import lap

N = 4  # fabric size of the controller cases (virtual ranks)
E = 8  # experts


def _int_matrix(rng, n, hi=1000):
    return rng.integers(0, hi, size=(n, n)).astype(np.float64)


def _scipy_weight(a, maximize=True):
    r, c = linear_sum_assignment(a, maximize=maximize)
    return float(np.asarray(a)[r, c].sum())


def _is_permutation(perm, n):
    return sorted(int(v) for v in np.asarray(perm)) == list(range(n))


def _same(port, ref):
    """Port tensor == JAX array: values and dtype."""
    a, b = port.numpy(), np.asarray(ref)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- auction LAP
class TestAuctionLap:
    @pytest.mark.parametrize("seed", range(8))
    def test_permutation_equal_to_jax_and_weight_to_scipy(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 17))
        a = _int_matrix(rng, n)
        perm = lap.auction_lap(a)
        _same(perm, jc.auction_lap(a))
        assert _is_permutation(perm, n)
        assert float(a[np.arange(n), perm.numpy()].sum()) == _scipy_weight(a)

    def test_ties_stay_weight_optimal_and_break_as_jax(self):
        rng = np.random.default_rng(7)
        for _ in range(10):
            n = int(rng.integers(2, 10))
            a = rng.choice([0.0, 10.0, 20.0], size=(n, n))
            perm = lap.auction_lap(a)
            _same(perm, jc.auction_lap(a))
            assert float(a[np.arange(n), perm.numpy()].sum()) == _scipy_weight(a)

    def test_minimize_matches_scipy(self):
        a = _int_matrix(np.random.default_rng(11), 8)
        perm = lap.auction_lap(a, maximize=False)
        _same(perm, jc.auction_lap(a, maximize=False))
        assert float(a[np.arange(8), perm.numpy()].sum()) == _scipy_weight(a, maximize=False)

    def test_float_matrices_within_subtoken_gap(self):
        rng = np.random.default_rng(13)
        for _ in range(5):
            a = rng.random((10, 10)) * 500.0
            perm = lap.auction_lap(a)
            _same(perm, jc.auction_lap(a))
            got, opt = float(a[np.arange(10), perm.numpy()].sum()), _scipy_weight(a)
            assert opt - 1.0 <= got <= opt + 1e-3

    def test_link_mask_matches_scipy_on_penalized_matrix(self):
        rng = np.random.default_rng(17)
        for _ in range(8):
            n = int(rng.integers(3, 10))
            a = _int_matrix(rng, n, hi=300)
            mask = rng.random((n, n)) < 0.7
            mask[np.arange(n), rng.permutation(n)] = True  # darks stay avoidable
            perm = lap.auction_lap(a, mask)
            _same(perm, jc.auction_lap(a, mask))
            p = perm.numpy()
            assert mask[np.arange(n), p].all()
            big = (np.abs(a).max() + 1.0) * (n + 1)
            pen = np.where(mask, a, -big)
            assert float(pen[np.arange(n), p].sum()) == _scipy_weight(pen)

    def test_rejects_non_square(self):
        with pytest.raises(ValueError, match="square"):
            lap.auction_lap(np.zeros((3, 4)))


class TestAuctionLapBatch:
    @pytest.mark.parametrize("seed", range(6))
    def test_every_layer_equal_to_jax_and_scipy(self, seed):
        rng = np.random.default_rng(100 + seed)
        n = int(rng.integers(2, 9))
        stack = np.stack([_int_matrix(rng, n) for _ in range(4)])
        perms = lap.auction_lap_batch(stack)
        _same(perms, jc.auction_lap_batch(stack))
        assert perms.shape == (4, n)
        for l in range(4):
            assert _is_permutation(perms[l], n)
            assert float(stack[l][np.arange(n), perms[l].numpy()].sum()) == _scipy_weight(stack[l])

    def test_shared_mask_applies_to_every_layer(self):
        rng = np.random.default_rng(23)
        n = 6
        stack = np.stack([_int_matrix(rng, n, hi=200) for _ in range(3)])
        mask = np.ones((n, n), bool)
        mask[0, 1] = mask[3, 4] = False
        mask[np.arange(n), rng.permutation(n)] = True
        perms = lap.auction_lap_batch(stack, mask)
        _same(perms, jc.auction_lap_batch(stack, mask))
        big = (np.abs(stack).max() + 1.0) * (n + 1)
        for l in range(3):
            p = perms[l].numpy()
            assert mask[np.arange(n), p].all()
            pen = np.where(mask, stack[l], -big)
            assert float(pen[np.arange(n), p].sum()) == _scipy_weight(pen)

    def test_rejects_wrong_rank(self):
        with pytest.raises(ValueError, match=r"\[L, n, n\]"):
            lap.auction_lap_batch(np.zeros((4, 4)))


class TestMatchingWeight:
    def test_known_value_and_batching(self):
        a = np.arange(9, dtype=np.float64).reshape(3, 3)
        perm = np.array([2, 0, 1])
        assert float(lap.matching_weight(a, perm)) == a[0, 2] + a[1, 0] + a[2, 1]
        stack, perms = np.stack([a, 2 * a]), np.stack([perm, perm])
        w = lap.matching_weight(stack, perms)
        np.testing.assert_allclose(w.numpy(), [12.0, 24.0])
        np.testing.assert_array_equal(w.numpy(), np.asarray(jc.matching_weight(stack, perms)))


# --------------------------------------------------------- greedy planner
def _traffic(rng, L=3, n=6, hi=400):
    a = rng.integers(0, hi, size=(L, n, n)).astype(np.float64)
    for l in range(L):
        np.fill_diagonal(a[l], 0.0)
    return a


GREEDY_CASES = ("integer", "integer_masked", "smoothed_floats", "fine_caps", "k_max_clip")


@pytest.mark.parametrize("case", GREEDY_CASES)
def test_greedy_phases_equals_jax_leaf_for_leaf(case):
    rng = np.random.default_rng(GREEDY_CASES.index(case))
    a = _traffic(rng, L=3, n=8)
    kw = dict(k_max=8, quantum=8, min_cap=8, slack=1.1)
    mask = None
    if case == "integer_masked":
        mask = np.ones((8, 8), bool)
        mask[0, 1] = mask[2, 5] = mask[4, 0] = False
    if case == "smoothed_floats":  # an EMA'd traffic: non-integer values
        a = 0.8 * a + 0.2 * _traffic(rng, L=3, n=8)
    if case == "fine_caps":
        kw.update(quantum=1, min_cap=1, slack=1.0)
    if case == "k_max_clip":
        kw.update(k_max=2)
    got = lap.greedy_phases(a, mask=mask, **kw)
    want = jc.greedy_phases_jax(a, mask=mask, **kw)
    assert set(got) == set(want)
    for key in want:
        _same(got[key], want[key])
    if case == "k_max_clip":
        assert got["residual"].sum() > 0 and int(got["n_phases"].max()) == 2


def test_greedy_phases_each_phase_lap_optimal_and_conserving():
    a = _traffic(np.random.default_rng(5))
    L, n = a.shape[0], a.shape[1]
    plan = lap.greedy_phases(a, k_max=n)
    perms, valid, sent = plan["perms"].numpy(), plan["valid"].numpy(), plan["sent"].numpy()
    for l in range(L):
        resid = a[l].copy()
        for k in range(n):
            assert float(resid[np.arange(n), perms[l, k]].sum()) == _scipy_weight(resid), (l, k)
            resid[np.arange(n)[valid[l, k]], perms[l, k][valid[l, k]]] = 0.0
    np.testing.assert_allclose(sent.sum() + plan["residual"].numpy().sum(), a.sum())
    np.testing.assert_allclose(plan["residual"].numpy(), 0.0)


class TestDecomposeBatchAuctionBackend:
    def _unique_stack(self, rng, L=3, n=6):
        vals = rng.choice(100_000, size=L * n * n, replace=False)
        a = vals.reshape(L, n, n).astype(np.float64)
        for l in range(L):
            np.fill_diagonal(a[l], 0.0)
        return a

    @pytest.mark.parametrize("masked", [False, True])
    def test_backend_jax_equals_reference(self, masked):
        a = self._unique_stack(np.random.default_rng(31 + masked))
        mask = None
        if masked:
            mask = np.ones((6, 6), bool)
            mask[0, 1] = mask[3, 2] = False
        got = pc.maxweight_decompose_batch(a, backend="jax", link_mask=mask)
        want = jc.maxweight_decompose_batch(a, backend="jax", link_mask=mask)
        ref = pc.decompose_batch(a, "maxweight", link_mask=mask)
        for d_got, d_want, d_ref in zip(got, want, ref):
            assert d_got.meta["lap_backend"] == "jax" and bool(d_got.meta.get("link_masked")) == masked
            sg, sw, sr = d_got.stacked(), d_want.stacked(), d_ref.stacked()
            for name in ("perms", "alloc", "sent"):
                np.testing.assert_array_equal(getattr(sg, name), getattr(sw, name))
            np.testing.assert_allclose(sg.sent, sr.sent)  # the scipy path's phases, where tokens move

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError, match="backend"):
            pc.maxweight_decompose_batch(np.zeros((1, 4, 4)), backend="tpu")


# ------------------------------------------------------------ traced twins
class TestTracedTwins:
    @pytest.mark.parametrize("seed", range(5))
    def test_link_mask_parity_with_jax_and_host(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(3, 9))
        a = rng.random((n, n)) * 300.0
        np.fill_diagonal(a, rng.random(n) * 50.0)
        mask = rng.random((n, n)) < 0.6
        np.fill_diagonal(mask, True)
        got = pc.apply_link_mask_traced(torch.from_numpy(a), torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, np.asarray(jc.apply_link_mask_traced(a, mask)), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got, pc.apply_link_mask(a, mask), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("n_src", [1, N, 2 * N])
    def test_routing_fold_parity(self, n_src):
        stats = np.random.default_rng(43).integers(0, 50, size=(3, n_src, E)).astype(np.float64)
        got = pc.routing_to_traffic_traced(torch.from_numpy(stats), n_ranks=N, n_experts=E).numpy()
        np.testing.assert_array_equal(got, np.asarray(jc.routing_to_traffic_traced(stats, n_ranks=N, n_experts=E)))
        np.testing.assert_allclose(got, pc.routing_to_traffic(stats, n_ranks=N, n_experts=E), rtol=1e-6)


# -------------------------------------------------------- device controller
def _runtimes(L=2, **cfg_kw):
    kw = dict(n_ranks=N, n_experts=E, ema=1.0, cooldown=0)
    kw.update(cfg_kw)
    jrt = jc.ScheduleRuntime(jc.ControllerConfig(**kw), L)
    prt = pc.ScheduleRuntime(pc.ControllerConfig(**kw), L)
    return jrt, prt


def _stats_of(traffic):
    """[L, n, n] rank traffic -> [L, n, E] routing counts folding back to it."""
    t = np.asarray(traffic, dtype=np.float64)
    return np.repeat(t / (E // t.shape[1]), E // t.shape[1], axis=2)


def _hot_traffic(L=2, hot=3, scale=600.0):
    t = np.full((L, N, N), 4.0)
    t[:, :, hot] = scale
    for l in range(L):
        np.fill_diagonal(t[l], 0.0)
    return t


def _flat_traffic(L=2, scale=100.0):
    t = np.full((L, N, N), scale)
    for l in range(L):
        np.fill_diagonal(t[l], 0.0)
    return t


class _Pair:
    """The JAX controller and the port's, built from twin runtimes, stepped
    together; ``check`` compares every leaf."""

    def __init__(self, prime=True, runtime_kw=None, **overrides):
        jrt, prt = _runtimes(**(runtime_kw or {}))
        if prime:
            jrt.prime(_flat_traffic()[0])
            prt.prime(_flat_traffic()[0])
        self.jrt, self.prt = jrt, prt
        self.jctrl, self.js = jc.DeviceController.from_runtime(jrt, **overrides)
        self.pctrl, self.ps = pc.DeviceController.from_runtime(prt, **overrides)
        self._jstep = jax.jit(self.jctrl.step)
        self.check()

    def step(self, stats, n=1):
        for _ in range(n):
            self.js = self._jstep(self.js, jnp.asarray(stats))
            self.pctrl.step(self.ps, stats)
            self.check()
        return self.pctrl.metrics(self.ps)

    def check(self):
        jleaves = jax.tree.leaves(self.js)
        pleaves = self.ps.leaves()
        assert len(jleaves) == len(pleaves)
        for (name, p), j in zip(pleaves.items(), jleaves):
            p, j = p.numpy(), np.asarray(j)
            assert p.dtype == j.dtype and p.shape == j.shape, name
            if p.dtype.kind == "f":
                np.testing.assert_allclose(p, j, rtol=1e-6, atol=0, err_msg=name)
            else:
                np.testing.assert_array_equal(p, j, err_msg=name)
        assert self.pctrl.metrics(self.ps).keys() == self.jctrl.metrics(self.js).keys()


class TestDeviceController:
    def test_from_runtime_adopts_table_and_policy(self):
        pair = _Pair()
        tbl, dev = pair.prt.table(), pair.pctrl.table_of(pair.ps)
        for name in ("perms", "caps", "valid", "n_phases"):
            np.testing.assert_array_equal(getattr(dev, name).numpy(), getattr(tbl, name).numpy())
        assert dev.envelope == tbl.envelope == pair.jctrl.cfg.envelope
        assert pair.pctrl.cfg == pc.DeviceControllerConfig(**vars(pair.jctrl.cfg))
        assert int(pair.ps.steps) == 1  # primed EMA counts as an observation
        # the state owns its storage: the runtime's in-place table refills never reach it
        assert dev.perms.data_ptr() != tbl.perms.data_ptr()

    def test_cold_start_and_steady_state_never_replans(self):
        pair = _Pair(prime=True)
        m = pair.step(_stats_of(_flat_traffic()), n=8)
        assert m["device_replans"] == 0 and m["drop_fraction"] <= pair.pctrl.cfg.drop_tolerance

    @pytest.mark.parametrize("ema", [1.0, 0.8, 0.3])
    def test_drift_fires_replan_and_absorbs_it(self, ema):
        pair = _Pair(runtime_kw=dict(ema=ema), hysteresis_steps=2)
        m = pair.step(_stats_of(_hot_traffic()), n=6)
        assert m["device_replans"] >= 1

    def test_hysteresis_counts_consecutive_steps(self):
        pair = _Pair(hysteresis_steps=3)
        hot = _stats_of(_hot_traffic())
        assert pair.step(hot)["device_replans"] == 0
        assert pair.step(hot)["device_replans"] == 0
        assert pair.step(hot)["device_replans"] == 1

    def test_cooldown_blocks_refire(self):
        pair = _Pair(hysteresis_steps=1, cooldown=50)
        a, b = _stats_of(_hot_traffic(hot=3)), _stats_of(_hot_traffic(hot=0))
        assert pair.step(a)["device_replans"] == 1
        for i in range(6):
            m = pair.step(b if i % 2 == 0 else a)
        assert m["device_replans"] == 1

    def test_set_link_mask_replans_off_dark_pairs(self):
        pair = _Pair()
        mask = np.ones((N, N), bool)
        mask[0, 2] = mask[2, 0] = False
        pair.js = pair.jctrl.set_link_mask(pair.js, mask)
        pair.pctrl.set_link_mask(pair.ps, mask)
        pair.check()
        m = pair.pctrl.metrics(pair.ps)
        assert m["device_replans"] == 1 and m["link_masked"]
        m = pair.step(_stats_of(_flat_traffic()))
        assert m["drop_fraction"] <= pair.pctrl.cfg.drop_tolerance

    def test_dropped_counts_and_spikes(self):
        pair = _Pair()
        flat = _stats_of(_flat_traffic())
        pair.js = pair._jstep(pair.js, jnp.asarray(flat))  # no dropped: the plain step
        pair.pctrl.step(pair.ps, flat)
        for dropped in (np.array([[3.0], [1.0]]), np.array([[900.0], [900.0]])):
            pair.js = jax.jit(pair.jctrl.step)(pair.js, jnp.asarray(flat), jnp.asarray(dropped))
            pair.pctrl.step(pair.ps, flat, dropped)
            pair.check()
        m = pair.pctrl.metrics(pair.ps)
        assert m["admitted_dropped"] == 1804.0 and m["drop_spikes"] == 1


def _regime_pair(**kw):
    """Flat-primed pair with an (empty) 2-slot regime library."""
    cfg = dict(hysteresis_steps=1, cooldown=0, regime_slots=2, regime_threshold=0.25)
    cfg.update(kw)
    return _Pair(**cfg)


def _hot_regime_entry(pair):
    """Cold-solve the hotspot regime once in both controllers and snapshot
    (table, reference), the capture pattern of the serving engine."""
    hot = _stats_of(_hot_traffic())
    js, ps = pair.js, pair.ps.clone()
    step = jax.jit(pair.jctrl.step)
    for _ in range(3):
        js = step(js, jnp.asarray(hot))
        pair.pctrl.step(ps, hot)
    assert pair.pctrl.metrics(ps)["device_replans"] >= 1
    jtab = jax.tree.map(np.asarray, pair.jctrl.table_of(js))
    ptab = pair.pctrl.table_of(ps).clone()
    np.testing.assert_array_equal(ptab.perms.numpy(), jtab.perms)
    return (jtab, np.asarray(js.smoothed).mean(axis=0)), (ptab, ps.smoothed.numpy().mean(axis=0)), hot


def _load(pair, jentries, pentries):
    pair.js = pair.jctrl.load_regimes(pair.js, [t for t, _ in jentries], [r for _, r in jentries])
    out = pair.pctrl.load_regimes(pair.ps, [t for t, _ in pentries], [r for _, r in pentries])
    assert out is pair.ps  # in place: a captured step keeps reading the same tensors
    pair.check()


class TestRegimeLibrary:
    def test_load_regimes_validation(self):
        plain = _Pair()
        tab = plain.pctrl.table_of(plain.ps)
        ref = _flat_traffic()[0]
        with pytest.raises(ValueError, match="regime_slots"):
            plain.pctrl.load_regimes(plain.ps, [tab], [ref])
        pair = _regime_pair()
        with pytest.raises(ValueError, match="tables vs"):
            pair.pctrl.load_regimes(pair.ps, [tab], [ref, ref])
        with pytest.raises(ValueError, match="exceed regime_slots"):
            pair.pctrl.load_regimes(pair.ps, [tab] * 3, [ref] * 3)
        with pytest.raises(ValueError, match="reference shape"):
            pair.pctrl.load_regimes(pair.ps, [tab], [np.ones((N + 1, N + 1))])
        _load(pair, [(jax.tree.map(np.asarray, pair.jctrl.table_of(pair.js)), ref)], [(tab.clone(), ref)])
        assert pair.pctrl.metrics(pair.ps)["regime_library_size"] == 1

    def test_warm_swap_replays_stored_plan_bit_identical(self):
        pair = _regime_pair()
        jentry, pentry, hot = _hot_regime_entry(pair)
        _load(pair, [jentry], [pentry])
        m = pair.step(hot, n=3)
        assert m["regime_warm_swaps"] >= 1
        for name in ("perms", "caps", "valid", "n_phases"):
            np.testing.assert_array_equal(getattr(pair.ps, name).numpy(), getattr(pentry[0], name).numpy())
        assert m["drop_fraction"] <= pair.pctrl.cfg.drop_tolerance

    def test_unrecognized_regime_cold_solves(self):
        pair = _regime_pair(regime_threshold=0.05)
        flat = _flat_traffic()[0]
        _load(pair, [(jax.tree.map(np.asarray, pair.jctrl.table_of(pair.js)), flat)],
              [(pair.pctrl.table_of(pair.ps).clone(), flat)])
        m = pair.step(_stats_of(_hot_traffic()), n=3)
        assert m["device_replans"] >= 1 and m["regime_warm_swaps"] == 0
        assert m["drop_fraction"] <= pair.pctrl.cfg.drop_tolerance

    def test_degraded_link_mask_disables_warm_matching(self):
        pair = _regime_pair()
        jentry, pentry, hot = _hot_regime_entry(pair)
        _load(pair, [jentry], [pentry])
        mask = np.ones((N, N), bool)
        mask[0, 1] = mask[1, 0] = False
        pair.js = pair.jctrl.set_link_mask(pair.js, mask)
        pair.pctrl.set_link_mask(pair.ps, mask)
        pair.check()
        replans0 = pair.pctrl.metrics(pair.ps)["device_replans"]
        m = pair.step(hot, n=3)
        assert m["device_replans"] > replans0 and m["regime_warm_swaps"] == 0

    def test_replan_penalty_blocks_cold_but_not_warm(self):
        hot = _stats_of(_hot_traffic())
        pair = _regime_pair(replan_penalty=0.99)
        m = pair.step(hot, n=4)
        assert m["device_replans"] == 0 and m["drop_fraction"] > pair.pctrl.cfg.drop_tolerance
        pair2 = _regime_pair(replan_penalty=0.99)
        jentry, pentry, _ = _hot_regime_entry(_regime_pair())
        _load(pair2, [jentry], [pentry])
        m2 = pair2.step(hot, n=4)
        assert m2["regime_warm_swaps"] >= 1 and m2["device_replans"] >= 1


def test_step_device_reads_nothing_on_the_host_and_replan_writes_in_place():
    """The split transition: ``step_device`` leaves the plan alone and
    returns ``fire`` as a tensor; ``replan`` writes the same storage."""
    pair = _Pair(hysteresis_steps=1)
    ps, ctrl = pair.ps, pair.pctrl
    ptrs = {name: getattr(ps, name).data_ptr() for name in ("perms", "caps", "valid", "n_phases", "capmat")}
    before = ps.perms.clone()
    out = ctrl.step_device(ps, _stats_of(_hot_traffic()))
    assert isinstance(out.fire, torch.Tensor) and bool(out.fire)
    assert torch.equal(ps.perms, before)  # the plan waits for the host
    ctrl.replan(ps, out.routable, warm=bool(out.warm), best=int(out.best))
    pair.js = pair._jstep(pair.js, jnp.asarray(_stats_of(_hot_traffic())))
    pair.check()
    assert {name: getattr(ps, name).data_ptr() for name in ptrs} == ptrs

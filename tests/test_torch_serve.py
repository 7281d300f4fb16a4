"""The port's serving engine (``repro_torch.serve``) against the JAX
package's (``repro.serve``) on the same weights and requests.

* host-side units: ``RequestQueue``, ``ContinuousBatcher`` and
  ``ServeMetrics`` (the port's copies) on the reference's cases;
* per-slot decode: the port's ``[B]``-step decode against JAX's and
  against the port's own per-row scalar decode, on smoke Mixtral and
  RWKV6 in f32 with weights transplanted from the JAX init;
* the engine: tokens request by request, the device controller's
  snapshots on the reference's drift trace and its final plan, the
  ``controller="off"`` admission and baseline cases, and RWKV with the
  reference's padded-prefill behaviour.

Everything runs in f32 (``COMPUTE_DTYPE`` patched on the JAX side), where
the two packages' logits agree to ~1e-6, so greedy tokens, routing counts
and the controller's decisions are compared for equality.  Logits: 1e-4
against JAX (f32 sums in another order); per-slot vs per-row decode
within the reference test's 2e-2 + 2e-2 |ref| and equal argmax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.configs import smoke_config as jax_smoke
from repro.core import make_serving_controller as jax_serving_controller
from repro.models import Model as JaxModel
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine

from repro_torch.configs import smoke_config
from repro_torch.core import make_serving_controller
from repro_torch.models.transplant import load_reference
from repro_torch.serve import ContinuousBatcher, Request, RequestQueue, ServeEngine, ServeMetrics, percentiles

# the reference drift run's token pools, probed on the PRNGKey(0) smoke
# Mixtral router: pool A routes top-2 into experts {6, 7}, pool B avoids them
POOL_A = np.array([5, 7, 8, 17, 21, 23, 33, 36, 42, 43, 44, 53])
POOL_B = np.array([1, 11, 22, 27, 29, 37, 41, 56, 67, 72, 75, 78])
DRIFT_KW = dict(
    decode_slots=32, max_len=64, buckets=(16,), n_ranks=8, regime_slots=4, regime_threshold=0.3,
    drop_tolerance=0.01, hysteresis_steps=1, cooldown=2, ema=0.8, host_observe_every=14,
    plan_overrides=dict(quantum=1, min_cap=1, slack=1.0), seed=0,
)


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)


def _cfgs(arch="mixtral-8x7b", dispatch="scheduled"):
    jcfg, pcfg = jax_smoke(arch), smoke_config(arch)
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch=dispatch))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch=dispatch))
    return jcfg, pcfg


_PARAMS: dict = {}


def _models(arch="mixtral-8x7b", dispatch="scheduled"):
    """(jax cfg, params, port cfg, port f32 model) from the PRNGKey(0) init."""
    jcfg, pcfg = _cfgs(arch, dispatch)
    if arch not in _PARAMS:
        _PARAMS[arch] = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    params = _PARAMS[arch]
    return jcfg, params, pcfg, load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=torch.float32)


def _engines(arch="mixtral-8x7b", dispatch="scheduled", **kw):
    jcfg, params, pcfg, model = _models(arch, dispatch)
    jeng = JaxEngine(jcfg, params=params, cache_dtype=jnp.float32, **kw)
    peng = ServeEngine(pcfg, model, cache_dtype=torch.float32, device="cpu", **kw)
    return jeng, peng


def _specs(rng, vocab, specs, pool=None):
    """The same prompts as one request list per package."""
    prompts = [(rng.choice(pool, p) if pool is not None else rng.integers(0, vocab, p), m) for p, m in specs]
    return (
        [JaxRequest(prompt=p, max_new_tokens=m, arrival=0.0) for p, m in prompts],
        [Request(prompt=p, max_new_tokens=m, arrival=0.0) for p, m in prompts],
    )


# ------------------------------------------------------------------- queue
class TestRequestQueue:
    def test_bucket_of_picks_smallest_fit(self):
        q = RequestQueue(buckets=(8, 16, 32))
        assert q.bucket_of(0) == 8 and q.bucket_of(8) == 8 and q.bucket_of(9) == 16 and q.bucket_of(33) is None

    def test_add_rejects_over_largest_bucket(self):
        q = RequestQueue(buckets=(4,))
        assert q.add(Request(prompt=np.arange(5), max_new_tokens=1))
        assert not q.add(Request(prompt=np.arange(6), max_new_tokens=1))
        assert len(q) == 1

    def test_pop_is_global_fifo_across_buckets(self):
        q = RequestQueue(buckets=(4, 16))
        long = Request(prompt=np.arange(10), max_new_tokens=1, arrival=0.0)
        short = Request(prompt=np.arange(3), max_new_tokens=1, arrival=1.0)
        q.add(short)
        q.add(long)
        assert q.pop() == (long, 16)
        assert q.pop() == (short, 4)
        assert q.pop() is None

    def test_push_front_retries_first(self):
        q = RequestQueue(buckets=(8,))
        a = Request(prompt=np.arange(3), max_new_tokens=1, arrival=0.0)
        q.add(a)
        q.add(Request(prompt=np.arange(3), max_new_tokens=1, arrival=1.0))
        got, _ = q.pop()
        q.push_front(got)
        assert q.pop()[0] is a

    def test_validation(self):
        with pytest.raises(ValueError):
            RequestQueue(buckets=())
        with pytest.raises(ValueError):
            RequestQueue(buckets=(8, 8))
        with pytest.raises(ValueError):
            Request(prompt=np.array([], np.int32), max_new_tokens=1)
        with pytest.raises(ValueError):
            Request(prompt=np.arange(3), max_new_tokens=0)

    def test_kv_accounting(self):
        r = Request(prompt=np.arange(5), max_new_tokens=3)
        assert r.prefill_len == 4 and r.kv_tokens == 7


# ----------------------------------------------------------------- batcher
class TestContinuousBatcher:
    def test_admit_and_finish_vacates_slot(self):
        b = ContinuousBatcher(n_slots=2, max_len=16)
        r = Request(prompt=np.array([3, 1, 4]), max_new_tokens=2)
        b.admit(0, r)
        assert b.n_live == 1 and int(b.step[0]) == 2 and int(b.token[0]) == 4
        assert b.advance(np.array([7, 0]), wall=1.0) == [] and r.tokens == [7]
        assert b.advance(np.array([9, 0]), wall=2.0) == [r] and r.tokens == [7, 9]
        assert b.n_live == 0 and b.free_slot() == 0
        assert r.first_token_wall == 1.0 and r.finish_wall == 2.0

    def test_slot_reuse_and_occupied_guard(self):
        b = ContinuousBatcher(n_slots=1, max_len=16)
        b.admit(0, Request(prompt=np.array([1]), max_new_tokens=1))
        with pytest.raises(AssertionError):
            b.admit(0, Request(prompt=np.array([2]), max_new_tokens=1))
        b.advance(np.array([5]), wall=0.0)
        r2 = Request(prompt=np.array([2, 3]), max_new_tokens=1)
        b.admit(0, r2)
        assert b.requests[0] is r2

    def test_fits_is_kv_aware(self):
        b = ContinuousBatcher(n_slots=1, max_len=8)
        assert b.fits(Request(prompt=np.arange(4), max_new_tokens=5))
        assert not b.fits(Request(prompt=np.arange(4), max_new_tokens=6))


# ----------------------------------------------------------------- metrics
class TestServeMetrics:
    def test_percentiles_empty_is_zero(self):
        assert percentiles([]) == {"p50": 0.0, "p99": 0.0, "mean": 0.0}

    def test_summary_counts(self):
        m = ServeMetrics()
        m.n_slots = 2
        m.record_offered(3)
        m.record_rejected(Request(prompt=np.arange(2), max_new_tokens=1), "x")
        m.record_decode_step(2)
        m.record_decode_step(1)
        m.wall_s = 1.0
        s = m.summary()
        assert s["requests"] == {"offered": 3, "admitted": 0, "rejected": 1, "completed": 0}
        assert s["occupancy"] == pytest.approx(0.75) and s["decode_steps"] == 2


# ------------------------------------------------------------ per-slot decode
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-7b"])
def test_vector_steps_match_jax_and_scalar_rows(f32, arch):
    """[B]-step decode at ragged depths: the port against JAX's [B]-step
    decode, and against its own per-row scalar decode."""
    jcfg, params, pcfg, model = _models(arch, dispatch="dense")
    jmodel = JaxModel(jcfg)
    rng = np.random.default_rng(1)
    depths, max_len = [1, 4, 7], 16
    jstep = jax.jit(lambda tok, caches, step: jmodel.decode_step(params, tok, caches, step))
    jrows, prows, want, last = [], [], [], []
    for d in depths:
        toks = rng.integers(0, pcfg.vocab_size, d + 1)
        jc, pcache = jmodel.init_cache(1, max_len, jnp.float32), model.init_cache(1, max_len, torch.float32)
        for s in range(d):  # per-row history through scalar steps
            _, jc = jstep(jnp.asarray(toks[s : s + 1], jnp.int32), jc, jnp.int32(s))
            model.decode_step(torch.tensor(toks[s : s + 1]), pcache, s)
        jrows.append(jc)
        prows.append([{k: v.clone() for k, v in c.items()} for c in pcache])
        logits, _ = model.decode_step(torch.tensor(toks[d : d + 1]), pcache, d)
        want.append(logits[0].numpy())
        last.append(toks[d])
    jbatched = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1), *jrows)
    pbatched = [{k: torch.cat([r[l][k] for r in prows]) for k in prows[0][l]} for l in range(len(prows[0]))]
    jlogits, _ = jstep(jnp.asarray(last, jnp.int32), jbatched, jnp.asarray(depths, jnp.int32))
    plogits, _ = model.decode_step(torch.tensor(last), pbatched, torch.tensor(depths, dtype=torch.int32))
    got, want = plogits.numpy(), np.stack(want)
    np.testing.assert_allclose(got, np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if arch == "mixtral-8x7b":  # the per-row writes landed at each row's own depth
        for l, cache in enumerate(pbatched):
            for row, d in enumerate(depths):
                assert cache["pos"][row, d] == d and (cache["pos"][row, d + 1 :] == -1).all()


def test_live_mask_weights_routing_counts_like_jax(f32):
    """``live`` zeroes vacated slots' routing counts and nothing else, as
    the reference's ``token_weight``."""
    jcfg, params, pcfg, model = _models()
    jmodel = JaxModel(jcfg)
    stats0 = np.full((pcfg.n_moe_layers, 1, 8), 1.0, np.float32)
    jrt, _ = jax_serving_controller(jcfg, n_ranks=8, drift="none")
    prt, _ = make_serving_controller(pcfg, n_ranks=8, drift="none", device="cpu")
    jrt.observe(stats0)
    prt.observe(stats0)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, pcfg.vocab_size, 4).astype(np.int32)
    steps = np.array([0, 3, 0, 5], np.int32)
    live = np.array([True, False, True, False])
    jlog, _, jst = jmodel.decode_step(
        params, jnp.asarray(tok), jmodel.init_cache(4, 8, jnp.float32), jnp.asarray(steps), schedule=jrt.table(),
        collect_stats=True, live=jnp.asarray(live),
    )
    outs = {}
    for name, mask in (("live", torch.from_numpy(live)), ("all", None)):
        outs[name] = model.decode_step(
            torch.from_numpy(tok), model.init_cache(4, 8, torch.float32), torch.from_numpy(steps),
            schedule=prt.table(), collect_stats=True, live=mask,
        )
    plog, _, pst = outs["live"]
    np.testing.assert_array_equal(pst["routing"].numpy(), np.asarray(jst["routing"]))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    assert pst["routing"].sum(-1).flatten().tolist() == [live.sum() * pcfg.moe.top_k] * pcfg.n_moe_layers
    torch.testing.assert_close(outs["all"][0], plog, rtol=0, atol=0)  # forward values untouched
    assert torch.equal(outs["all"][2]["admitted"], pst["admitted"])  # vacated slots still routed and admitted


# ----------------------------------------------------------------- engine
PARITY_SPECS = [(3, 5), (5, 4), (9, 6), (2, 5), (1, 4), (6, 3)]
PARITY_KW = dict(decode_slots=2, max_len=32, buckets=(4, 8), n_ranks=8, drop_tolerance=1.0,
                 host_observe_every=10**9, seed=0)


def test_engine_tokens_equal_jax_request_by_request(f32):
    jeng, peng = _engines(**PARITY_KW)
    jreqs, preqs = _specs(np.random.default_rng(0), 256, PARITY_SPECS)
    jout, pout = jeng.run(jreqs), peng.run(preqs)
    assert pout["serve"]["requests"] == jout["serve"]["requests"]
    assert pout["serve"]["requests"]["completed"] == len(preqs)
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    # on the CPU the step runs eagerly: no decode graph; two bucket shapes prefilled
    assert pout["compile"] == {"decode_executables": 0, "prefill_executables": 2, "admit_executables": 1}
    for key in ("device_replans", "steps", "regime_warm_swaps", "host_replans"):
        assert pout["controller"][key] == jout["controller"][key], key


def test_engine_tokens_equal_its_unbatched_reference(f32):
    """Slot recycling, bucket padding and admit masking are invisible: each
    request's tokens equal an unpadded prefill + scalar decode under the
    same tables."""
    _, peng = _engines(**PARITY_KW)
    _, preqs = _specs(np.random.default_rng(0), 256, PARITY_SPECS)
    peng.run(preqs)
    model = peng.model
    for req in preqs:
        caches = model.init_cache(1, peng.max_len, torch.float32)
        if req.prefill_len > 0:
            model.prefill(torch.from_numpy(req.prompt[None, :-1]), caches, schedule=peng._prefill_table)
        tok, got = int(req.prompt[-1]), []
        for s in range(req.prefill_len, req.prefill_len + req.max_new_tokens):
            logits, _ = model.decode_step(torch.tensor([tok]), caches, s, schedule=peng._table)
            tok = int(torch.argmax(logits, dim=-1)[0])
            got.append(tok)
        assert got == req.tokens, f"request {req.rid} diverged"


_DRIFT: dict = {}


def _drift_run():
    """The reference's A -> capture -> B -> A2 run through both engines
    (shared by the drift cases: one run each)."""
    if _DRIFT:
        return _DRIFT
    jeng, peng = _engines(**DRIFT_KW)
    rng = np.random.default_rng(3)
    snaps = {"jax": {}, "port": {}}
    for name, pool in [("A", POOL_A), ("B", POOL_B), ("A2", POOL_A)]:
        jreqs, preqs = _specs(rng, 256, [(12, 14)] * 64, pool=pool)
        for key, eng, reqs in (("jax", jeng, jreqs), ("port", peng, preqs)):
            eng.run(reqs)
            m = eng.metrics()
            snaps[key][name] = {
                "replans": m["controller"]["device_replans"], "warm": m["controller"]["regime_warm_swaps"],
                "lib": m["controller"]["regime_library_size"], "completed": m["serve"]["requests"]["completed"],
                "host_replans": m["controller"]["host_replans"], "tokens": [r.tokens for r in reqs],
            }
            if name == "A":
                eng.capture_regime()
    _DRIFT.update(snaps=snaps, jax=jeng, port=peng)
    return _DRIFT


def test_drift_run_snapshots_equal_jax(f32):
    run = _drift_run()
    assert run["port"]._graph is None  # CPU: eager
    for name in ("A", "B", "A2"):
        assert run["snaps"]["port"][name] == run["snaps"]["jax"][name], name
    port = run["snaps"]["port"]
    assert port["A"]["replans"] >= 1 and port["A2"]["warm"] >= 1 and port["A2"]["completed"] == 3 * 64
    assert [e["kind"] for e in run["port"].replan_log].count("warm") == port["A2"]["warm"]


def test_drift_run_final_plan_equals_jax(f32):
    run = _drift_run()
    jst, pst = run["jax"]._state, run["port"]._state
    for name, leaf in pst.leaves().items():
        j = np.asarray(getattr(jst, name))
        if leaf.dtype.is_floating_point:
            np.testing.assert_allclose(leaf.numpy(), j, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(leaf.numpy(), j, err_msg=name)
    # every A2 re-plan was a warm swap: the live plan IS the captured entry
    bank = run["port"]._bank_tables[0]
    for name in ("perms", "caps", "valid", "n_phases"):
        assert torch.equal(getattr(pst, name), getattr(bank, name)), name


def test_kv_overflow_rejected_and_queue_waits_counted(f32):
    jeng, peng = _engines(controller="off", decode_slots=1, max_len=16, buckets=(4,))
    assert not peng.has_controller
    rng = np.random.default_rng(2)
    parts = [_specs(rng, 256, [(3, 4), (3, 4), (3, 4)]), _specs(rng, 256, [(9, 1)]), _specs(rng, 256, [(4, 14)])]
    jreqs, preqs = (sum((p[i] for p in parts), []) for i in (0, 1))
    jout, pout = jeng.run(jreqs), peng.run(preqs)
    r = pout["serve"]["requests"]
    assert r == {"offered": 5, "admitted": 3, "rejected": 2, "completed": 3} == jout["serve"]["requests"]
    assert pout["serve"]["queue_wait_steps"]["p99"] > 0
    assert pout["serve"]["queue_wait_steps"] == jout["serve"]["queue_wait_steps"]
    assert [q.tokens for q in preqs] == [q.tokens for q in jreqs]
    assert "controller" not in pout


def test_fixed_round_baseline_still_completes(f32):
    jeng, peng = _engines(controller="off", decode_slots=2, max_len=16, buckets=(4,))
    jreqs, preqs = _specs(np.random.default_rng(3), 256, [(3, 2), (3, 6), (3, 2), (3, 6)])
    jout, pout = jeng.run(jreqs, continuous=False), peng.run(preqs, continuous=False)
    assert pout["serve"]["requests"]["completed"] == 4
    # drain barrier: more decode steps than the continuous lower bound
    assert pout["serve"]["decode_steps"] > 8
    assert pout["serve"]["decode_steps"] == jout["serve"]["decode_steps"]
    assert [q.tokens for q in preqs] == [q.tokens for q in jreqs]


def test_rwkv_engine_equals_jax_with_the_padded_prefill(f32):
    """RWKV (no MoE: no controller).  The reference prefills each prompt
    padded to its bucket and masks only the integer ``pos`` leaves, so the
    recurrent state absorbs the padding; the port keeps that behaviour
    (ROADMAP §3): its tokens equal JAX's.  A prompt whose prefill length
    equals its bucket matches the unbatched path; a padded one does not."""
    jeng, peng = _engines("rwkv6-7b", decode_slots=2, max_len=16, buckets=(8,))
    assert not peng.has_controller
    jreqs, preqs = _specs(np.random.default_rng(5), 256, [(3, 4), (9, 4), (5, 4)])
    jeng.run(jreqs)
    peng.run(preqs)
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    model = peng.model
    unbatched = []
    for req in preqs:
        caches = model.init_cache(1, peng.max_len, torch.float32)
        model.prefill(torch.from_numpy(req.prompt[None, :-1]), caches)
        tok, got = int(req.prompt[-1]), []
        for s in range(req.prefill_len, req.prefill_len + req.max_new_tokens):
            logits, _ = model.decode_step(torch.tensor([tok]), caches, s)
            tok = int(torch.argmax(logits, dim=-1)[0])
            got.append(tok)
        unbatched.append(got)
    assert preqs[1].prefill_len == 8 and preqs[1].tokens == unbatched[1]  # exactly its bucket
    assert preqs[0].tokens != unbatched[0] and preqs[2].tokens != unbatched[2]  # padded: the reference fault


class TestRegimeLibraryAPI:
    def test_requires_regime_slots(self):
        _, _, pcfg, model = _models()
        eng = ServeEngine(pcfg, model, decode_slots=2, max_len=16, buckets=(4,), device="cpu")
        with pytest.raises(ValueError, match="regime"):
            eng.capture_regime()
        with pytest.raises(ValueError, match="regime"):
            eng.load_regimes([np.ones((8, 8))])

    def test_load_regimes_plans_like_jax_and_fills_library(self, f32):
        jeng, peng = _engines(decode_slots=2, max_len=16, buckets=(4,), regime_slots=2)
        ref = np.ones((8, 8), np.float32)
        np.fill_diagonal(ref, 0.0)
        jeng.load_regimes([ref])
        peng.load_regimes([ref])
        m = peng.metrics()["controller"]
        assert m["regime_library_size"] == 1 and m["regime_warm_swaps"] == 0
        for name in ("perms", "caps", "valid", "n_phases"):
            np.testing.assert_array_equal(getattr(peng._bank_tables[0], name).numpy(),
                                          np.asarray(getattr(jeng._bank_tables[0], name)))
        for name in ("lib_ref", "lib_perms", "lib_caps", "lib_valid", "lib_n_phases"):
            np.testing.assert_array_equal(getattr(peng._state, name).numpy(), np.asarray(getattr(jeng._state, name)))
        with pytest.raises(ValueError, match="shape"):
            peng.load_regimes([np.ones((4, 4))])


def test_hierarchical_dispatch_names_m10():
    _, _, pcfg, model = _models(dispatch="hierarchical")
    with pytest.raises(NotImplementedError, match="M10"):
        ServeEngine(pcfg, model, decode_slots=2, max_len=16, buckets=(4,), device="cpu")

"""The serving engine and the device controller on the card: the batched
auction against the CPU, the captured decode step against the eager step
function, and the engine's tokens and warm swaps with the graph.  Skips
without a CUDA device; imports no JAX.  Run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_cuda.py

Exact equality throughout: the graph replays the kernels the eager step
launches, on the same inputs, and the auction's arithmetic is
integer-valued f32 with first-index tie-breaks on both devices.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import lap
from repro_torch.models.layers import rmsnorm
from repro_torch.serve import Request, ServeEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def _traffic(rng, L=4, n=8, hi=400):
    a = rng.integers(0, hi, size=(L, n, n)).astype(np.float64)
    for l in range(L):
        np.fill_diagonal(a[l], 0.0)
    return a


@pytest.mark.cuda
def test_greedy_phases_on_the_card_equals_the_cpu(cuda_device):
    rng = np.random.default_rng(3)
    for case in range(4):
        a = _traffic(rng)
        if case % 2:  # an EMA'd traffic: non-integer values
            a = 0.8 * a + 0.2 * _traffic(rng)
        kw = dict(k_max=8, quantum=1, min_cap=1, slack=1.0) if case < 2 else dict(k_max=6)
        cpu = lap.greedy_phases(torch.from_numpy(a), **kw)
        card = lap.greedy_phases(torch.from_numpy(a).to(cuda_device), **kw)
        for key in cpu:
            assert torch.equal(card[key].cpu(), cpu[key]), (case, key)


def _mixtral():
    cfg = smoke_config("mixtral-8x7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="scheduled"))


def _requests(seed, specs, vocab=256, pool=None):
    rng = np.random.default_rng(seed)
    return [
        Request(prompt=rng.choice(pool, p) if pool is not None else rng.integers(0, vocab, p), max_new_tokens=m,
                arrival=float(i // 3))
        for i, (p, m) in enumerate(specs)
    ]


SPECS = [(3, 5), (5, 4), (9, 6), (2, 5), (1, 4), (6, 3), (7, 7), (4, 2)]
ENGINE_KW = dict(decode_slots=4, max_len=32, buckets=(4, 8), n_ranks=8, drop_tolerance=0.01,
                 plan_overrides=dict(quantum=1, min_cap=1, slack=1.0), host_observe_every=5, seed=0)


@pytest.mark.cuda
def test_decode_graph_replay_equals_the_eager_step_bit_for_bit(cuda_device):
    eng = ServeEngine(_mixtral(), device=cuda_device, **ENGINE_KW)
    real, held = eng._decode_once, []

    def checked():
        ref = eng.step_on_copies()
        nxt = real()
        live = np.flatnonzero(eng.batcher.live)
        np.testing.assert_array_equal(eng.last_outputs, ref["outputs"])
        for mine, theirs in zip(eng._caches, ref["caches"]):
            for key in mine:
                assert torch.equal(mine[key][live], theirs[key][live]), key
        for name, leaf in eng._state.leaves().items():
            assert torch.equal(leaf, ref["state"].leaves()[name]), name
        held.append(ref["fire"])
        return nxt

    eng._decode_once = checked
    out = eng.run(_requests(0, SPECS))
    assert out["serve"]["requests"]["completed"] == len(SPECS)
    assert out["compile"]["decode_executables"] == 1 and eng.graph_replays == out["serve"]["decode_steps"]
    assert any(held)  # a step that re-planned was held too


def _same_tokens_graph_and_eager(cfg, device, **kw):
    runs = []
    for graph in (True, False):
        eng = ServeEngine(cfg, device=device, **kw)
        eng._use_graph = graph
        reqs = _requests(1, SPECS)
        out = eng.run(reqs)
        runs.append(([r.tokens for r in reqs], out))
    (graph_tokens, graph_out), (eager_tokens, eager_out) = runs
    assert graph_tokens == eager_tokens
    assert graph_out["compile"]["decode_executables"] == 1 and eager_out["compile"]["decode_executables"] == 0
    return graph_out, eager_out


@pytest.mark.cuda
def test_mixtral_engine_with_the_controller_same_tokens_graph_and_eager(cuda_device):
    graph_out, eager_out = _same_tokens_graph_and_eager(_mixtral(), cuda_device, **ENGINE_KW)
    assert graph_out["controller"] == eager_out["controller"]


@pytest.mark.cuda
def test_rwkv_engine_without_the_controller_same_tokens_graph_and_eager(cuda_device):
    # the smoke width with K5's head size (the kernel is built for D = 64)
    cfg = dataclasses.replace(smoke_config("rwkv6-7b"), d_model=128, n_heads=2, n_kv_heads=2, rwkv_head_dim=64)
    graph_out, _ = _same_tokens_graph_and_eager(cfg, cuda_device, **dict(ENGINE_KW, controller="off"))
    assert "controller" not in graph_out


def _pools(model, hot=(6, 7), size=12):
    """Token pools probed on layer 0's router (its input taken as the normed
    embedding): pool A's tokens route top-2 into ``hot``, pool B's avoid it."""
    blk = model.layers[0]
    h = rmsnorm(model.embed.float(), blk.ln2, eps=model.cfg.norm_eps)
    top = torch.topk(h @ blk.ffn.router.float(), model.cfg.moe.top_k, dim=-1).indices
    in_hot = torch.isin(top, torch.tensor(hot, device=top.device))
    a, b = torch.nonzero(in_hot.all(-1)).flatten(), torch.nonzero(~in_hot.any(-1)).flatten()
    return a[:size].cpu().numpy(), b[:size].cpu().numpy()


@pytest.mark.cuda
def test_warm_swap_fires_on_the_card_after_load_regimes(cuda_device):
    eng = ServeEngine(
        _mixtral(), device=cuda_device, decode_slots=32, max_len=64, buckets=(16,), n_ranks=8, regime_slots=4,
        regime_threshold=0.3, drop_tolerance=0.01, hysteresis_steps=1, cooldown=2, ema=0.8, host_observe_every=14,
        plan_overrides=dict(quantum=1, min_cap=1, slack=1.0), seed=0,
    )
    pool_a, pool_b = _pools(eng.model)
    assert len(pool_a) >= 4 and len(pool_b) >= 4
    eng.run(_requests(3, [(12, 14)] * 64, pool=pool_a))
    eng.load_regimes([eng._state.smoothed.mean(dim=0).cpu().numpy()])  # A's realized shape, pre-planned
    for seed, pool in ((4, pool_b), (5, pool_a)):
        eng.run(_requests(seed, [(12, 14)] * 64, pool=pool))
    m = eng.metrics()
    assert m["controller"]["regime_library_size"] == 1 and m["controller"]["regime_warm_swaps"] >= 1
    assert [e["kind"] for e in eng.replan_log].count("warm") == m["controller"]["regime_warm_swaps"]
    assert m["compile"]["decode_executables"] == 1


@pytest.mark.cuda
def test_hierarchical_engine_on_the_card_replay_eager_and_a_cpu_twin(cuda_device):
    """``dispatch="hierarchical"``: the two-level controller's step inside the
    decode graph equals the eager step on copies bit for bit at every step, a
    CPU twin of both levels fed the routing the engine copied out ends in the
    card's state, and the graph and eager runs give the same tokens."""
    from repro_torch.core import DeviceController, HierarchicalDeviceController

    cfg = dataclasses.replace(_mixtral(), moe=dataclasses.replace(_mixtral().moe, dispatch="hierarchical"))
    eng = ServeEngine(cfg, device=cuda_device, **ENGINE_KW)
    ctrl = eng._ctrl
    assert isinstance(ctrl, HierarchicalDeviceController)
    twin = HierarchicalDeviceController(DeviceController(ctrl.intra.cfg, device="cpu"),
                                        DeviceController(ctrl.inter.cfg, device="cpu"), ctrl.pod_size)
    twin_state, real, fired = eng._state.clone("cpu"), eng._decode_once, []

    def checked():
        ref = eng.step_on_copies()
        nxt = real()
        np.testing.assert_array_equal(eng.last_outputs, ref["outputs"])
        for name, leaf in eng._state.leaves().items():
            assert torch.equal(leaf, ref["state"].leaves()[name]), name
        out = eng.split_outputs(eng.last_outputs)
        twin.step(twin_state, out["routing"], out["dropped"])
        fired.append(out["fire"])
        return nxt

    eng._decode_once = checked
    reqs = _requests(0, SPECS)
    out = eng.run(reqs)
    assert out["serve"]["requests"]["completed"] == len(SPECS) and eng.graph_replays == out["serve"]["decode_steps"]
    for name, leaf in eng._state.leaves().items():
        mine, theirs = leaf.cpu(), twin_state.leaves()[name]
        if mine.is_floating_point():
            torch.testing.assert_close(mine, theirs, rtol=1e-6, atol=0, msg=name)
        else:
            assert torch.equal(mine, theirs), name
    assert any(fired) and out["controller"]["device_replans"] >= 1
    eager = ServeEngine(cfg, device=cuda_device, **ENGINE_KW)
    eager._use_graph = False
    ereqs = _requests(0, SPECS)
    eager.run(ereqs)
    assert [r.tokens for r in ereqs] == [r.tokens for r in reqs]

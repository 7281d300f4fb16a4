"""The serving launcher across a 4-rank gloo world on the CPU, held
against the JAX package's one-device serving run.

``repro_torch.launch.serve.serve`` runs on 4 spawned ranks
(``_torch_world.serve_world``; the ranks import ``repro_torch`` only):
the smoke Mixtral with JAX's parameters transplanted in f32, each rank
holding 2 of the 8 experts, ``phase_pipelined`` with the controller
(drift ``shift``), 2 rounds of B = 4 prompts of 8 tokens.  Prefill
(S = 8 splits over the 4 ranks) takes the fabric, decode (S = 1) the
dense fabric's EP form.

The reference is what ``repro.launch.serve`` does on one device with a
controller over 4 ranks (``--virtual-ranks 4``, the model axis a 4-rank
mesh plans for): the same estimates into ``make_serving_controller``,
then ``prefill`` and greedy ``decode_step`` under its table, on the
prompts the ranks served, with ``COMPUTE_DTYPE`` f32 and the Pallas
kernels in interpret mode.  The EP fabric admits by the real source
rank, the one-device virtual fabric by contiguous virtual sources, and
each bounds its buckets by its own capacity rule; the two agree when
nothing is clipped or cut.  So the layer runs at capacity factor 8.0 (as
JAX's parity matrix), and at 8 tokens a rank no (source, expert) pair
outgrows the plan's smallest per-expert slot count (8); the test checks
that nothing was clipped before it compares.
Tokens equal, the first prefill's logits within 1e-4 (as
``test_torch_model.py``), every rank's table equal to the JAX runtime's.
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

import repro.models.attention as jax_attention
import repro.models.layers as jax_layers
from repro.configs import smoke_config as jax_smoke
from repro.core import make_serving_controller
from repro.models import Model as JaxModel

import _torch_world as tw
from repro_torch.configs import smoke_config
from repro_torch.parallel.sharding import spawn_world

SRC = Path(__file__).resolve().parent.parent / "src"
B, S, NEW, ROUNDS, DRIFT = 4, 8, 4, 2, "shift"
CAPACITY = 8.0  # as JAX's cross-fabric parity matrix: no capacity-factor drop on either side


@pytest.fixture(scope="module")
def served():
    jcfg = jax_smoke("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch="phase_pipelined", use_pallas=True,
                                                             capacity_factor=CAPACITY))
    pcfg = smoke_config("mixtral-8x7b")
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="phase_pipelined",
                                                             capacity_factor=CAPACITY))
    params = jax.tree.map(np.array, JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    spec = {"cfg": pcfg, "params": params, "serve": dict(batch=B, prompt_len=S, new_tokens=NEW, rounds=ROUNDS,
                                                          controller=True, drift=DRIFT)}
    ranks = spawn_world(tw.serve_world, tw.N_RANKS, args=(spec,), timeout_s=150)
    return jcfg, params, ranks


def _jax_run(jcfg, params, prompts, table):
    model = JaxModel(jcfg)
    caches = model.init_cache(B, S + NEW, jnp.float32)
    logits, caches = jax.jit(model.prefill)(params, jnp.asarray(prompts), caches, schedule=table)
    first, tokens = np.asarray(logits), []
    token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    decode = jax.jit(model.decode_step)
    for i in range(NEW):
        logits, caches = decode(params, token, caches, jnp.int32(S + i), schedule=table)
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        tokens.append(np.asarray(token))
    return first, np.stack(tokens, 1)


def test_world_serve_equals_jax_one_device_serve(served, monkeypatch):
    jcfg, params, ranks = served
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(jax_attention, "USE_PALLAS_FLASH", True)
    runtime, scen = make_serving_controller(jcfg, n_ranks=tw.N_RANKS, drift=DRIFT, rounds=ROUNDS)
    tokens = float(B * S * jcfg.moe.top_k)
    r0 = ranks[0]
    for r in range(ROUNDS):
        for rank in ranks:  # every rank served the same prompts and produced the same tokens
            np.testing.assert_array_equal(rank["prompts"][r], r0["prompts"][r])
            np.testing.assert_array_equal(rank["tokens"][r], r0["tokens"][r])
        admitted, dropped, routed = r0["moe_by_round"][r]
        assert dropped == 0 and admitted == routed, r0["moe_by_round"]  # the plan clipped nothing
        decision = runtime.observe(np.broadcast_to(tokens * scen.expert_probs(r)[None, None, :],
                                                   (runtime.n_layers, 1, jcfg.moe.n_experts)))
        jtable = runtime.table()
        for rank in ranks:
            assert rank["decisions"][r] == (decision.changed, decision.replanned)
            for name, got in rank["tables"][r].items():
                want = jtable.envelope if name == "envelope" else np.asarray(getattr(jtable, name))
                np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=f"round {r} {name}")
        first, jtokens = _jax_run(jcfg, params, r0["prompts"][r], jtable)
        np.testing.assert_array_equal(r0["tokens"][r], jtokens, err_msg=f"round {r} tokens")
        if r == 0:
            for rank in ranks:
                np.testing.assert_allclose(rank["first_logits"], first, rtol=1e-4, atol=1e-4)
    # prefill on the fabric (one call a layer a round), every decode step on the dense EP form
    layers = jcfg.n_layers
    assert r0["paths"] == {"phase_pipelined": ROUNDS * layers, "dense_ep": ROUNDS * NEW * layers}, r0["paths"]


def test_world_serve_ppermute_bakes_a_static_plan(served, monkeypatch):
    """``ppermute`` cannot take the controller's rows: the launcher bakes one
    uniform plan, nothing is cut, and the run equals JAX's one-device run
    (where ``ppermute`` runs the dense fabric, plan-free)."""
    jcfg, params, ranks = served
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(jax_attention, "USE_PALLAS_FLASH", True)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch="ppermute"))
    for r in range(ROUNDS):
        first, jtokens = _jax_run(jcfg, params, ranks[0]["prompts"][r], None)
        for rank in ranks:
            st = rank["static"]
            admitted, dropped, routed = st["moe_by_round"][r]
            assert dropped == 0 and admitted == routed, st["moe_by_round"]
            np.testing.assert_array_equal(st["tokens"][r], jtokens, err_msg=f"round {r}")
            if r == 0:
                np.testing.assert_allclose(st["first_logits"], first, rtol=1e-4, atol=1e-4)
    layers = jcfg.n_layers
    assert ranks[0]["static"]["paths"] == {"ppermute": ROUNDS * layers, "dense_ep": ROUNDS * NEW * layers}


def test_to_reference_gathers_the_expert_slices(served):
    _, params, ranks = served
    for rank in ranks:
        for path, want in _leaves(params):
            np.testing.assert_array_equal(_get(rank["gathered"], path), np.asarray(want, np.float32),
                                          err_msg="/".join(path))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_two_data_groups_serve_their_batch_halves_as_one_process(served):
    """8 ranks form JAX's (2, 4) serving mesh: each data group serves half
    the batch on its own model group, and the launcher joins the halves
    back: the same tokens, logits and tables as the 4-rank world."""
    jcfg, params, ranks4 = served
    pcfg = dataclasses.replace(smoke_config("mixtral-8x7b"), moe=dataclasses.replace(
        smoke_config("mixtral-8x7b").moe, dispatch="phase_pipelined", capacity_factor=CAPACITY))
    spec = {"cfg": pcfg, "params": params, "serve": dict(batch=B, prompt_len=S, new_tokens=NEW, rounds=ROUNDS,
                                                          controller=True, drift=DRIFT)}
    ranks8 = spawn_world(tw.serve_world, 2 * tw.N_RANKS, args=(spec,), timeout_s=200)
    for rank in ranks8:
        np.testing.assert_array_equal(rank["tokens"], ranks4[0]["tokens"])
        np.testing.assert_allclose(rank["first_logits"], ranks4[0]["first_logits"], rtol=1e-5, atol=1e-5)
        for got, want in zip(rank["tables"], ranks4[0]["tables"]):
            for name in got:
                np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]), err_msg=name)
        # the stats are summed over the data groups: the whole batch's demand, as on 4 ranks
        assert rank["moe_by_round"] == ranks4[0]["moe_by_round"]


def test_world_launcher_refuses_the_engine(served):
    """The engine's decode is one CUDA graph: it runs on one rank only."""
    _, _, ranks = served
    assert all(rank["engine_refused"] for rank in ranks)


def test_torchrun_serves_a_world_on_the_cpu():
    """The documented command: ``torchrun --nproc-per-node 4 -m
    repro_torch.launch.serve --smoke --controller --device cpu``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4", "-m",
           "repro_torch.launch.serve", "--smoke", "--controller", "--device", "cpu", "--batch", "4",
           "--prompt-len", "8", "--new-tokens", "2", "--rounds", "2"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stderr.count("round 1: plan") == 1, res.stderr[-3000:]  # rank 0 logs the run
    assert "controller:" in res.stderr

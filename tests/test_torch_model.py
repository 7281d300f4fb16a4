"""Whole-slice parity: prefill + greedy decode with a schedule table on the
smoke Mixtral, Qwen3-MoE and DBRX, JAX weights transplanted into the port;
one MoE layer at Qwen3's 128 experts top-8; Qwen3's explicit head_dim
through prefill and decode attention.

The JAX side runs as its own tests run it on the CPU: ``use_pallas=True``
(grouped MoE kernel) and ``USE_PALLAS_FLASH=True`` (flash kernel), both
in interpret mode.  The port's kernel path is always on; on CPU tensors
its wrappers run the plain versions.

Tolerances: f32 (``COMPUTE_DTYPE`` patched to f32 on the JAX side):
logits within 1e-4, since whole-stack f32 runs of the JAX package itself
differ by up to 2.3e-4 between scan and unroll, and greedy tokens equal.
bf16: logits within 0.1 (logits are O(1); a few bf16 roundings per layer,
each up to 2^-9 relative, can differ by an ulp between the frameworks;
observed up to 0.037 over prompt seeds 1-4).  The bf16 run uses prompt
seed 2: with seed 1 the JAX logits at the last decode step have a top-2
margin of 0.0156 (one bf16 ulp at that magnitude) and the two packages
pick different greedy tokens there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attention
import repro.models.layers as jax_layers
from repro.configs import smoke_config as jax_smoke
from repro.core import make_serving_controller
from repro.models import Model as JaxModel

from repro_torch.configs import smoke_config
from repro_torch.launch.serve import uniform_estimate
from repro_torch.core import make_serving_controller as port_serving_controller
from repro_torch.models.transplant import load_reference

B, S, NEW = 2, 16, 4


def _cfgs(arch: str = "mixtral-8x7b"):
    jcfg = jax_smoke(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch="phase_pipelined", use_pallas=True))
    pcfg = smoke_config(arch)
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="phase_pipelined"))
    return jcfg, pcfg


def _run_jax(jcfg, params, prompts, table, cache_dtype):
    model = JaxModel(jcfg)
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step)
    caches = model.init_cache(B, S + NEW, cache_dtype)
    logits, caches = prefill(params, jnp.asarray(prompts), caches, schedule=table)
    out_logits, tokens = [np.asarray(logits)], []
    token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for i in range(NEW):
        logits, caches = decode(params, token, caches, jnp.int32(S + i), schedule=table)
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out_logits.append(np.asarray(logits))
        tokens.append(np.asarray(token))
    return out_logits, np.stack(tokens, 1)


def _run_port(model, prompts, table, cache_dtype):
    caches = model.init_cache(B, S + NEW, cache_dtype)
    logits, caches = model.prefill(torch.from_numpy(prompts), caches, schedule=table)
    out_logits, tokens = [logits.numpy()], []
    token = torch.argmax(logits, dim=-1)
    for i in range(NEW):
        logits, caches = model.decode_step(token, caches, S + i, schedule=table)
        token = torch.argmax(logits, dim=-1)
        out_logits.append(logits.numpy())
        tokens.append(token.numpy())
    return out_logits, np.stack(tokens, 1)


@pytest.mark.parametrize(
    "dtype,tol,seed",
    [(torch.float32, 1e-4, 1), (torch.bfloat16, 1e-1, 2)],
)
def test_prefill_decode_matches_jax(monkeypatch, dtype, tol, seed):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jdtype)
    monkeypatch.setattr(jax_attention, "USE_PALLAS_FLASH", True)
    jcfg, pcfg = _cfgs()
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=dtype)
    prompts = np.random.default_rng(seed).integers(0, pcfg.vocab_size, size=(B, S)).astype(np.int32)

    # the serving table: the JAX controller's first table == the port controller's
    stats0 = uniform_estimate(pcfg, float(B * S * pcfg.moe.top_k))
    runtime, _ = make_serving_controller(jcfg, n_ranks=8, drift="none")
    runtime.observe(stats0)
    jtable = runtime.table()
    pruntime, _ = port_serving_controller(pcfg, n_ranks=8, drift="none", device="cpu")
    pruntime.observe(stats0)
    ptable = pruntime.table()

    jl, jt = _run_jax(jcfg, params, prompts, jtable, jdtype)
    pl, pt = _run_port(model, prompts, ptable, dtype)
    for step, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol, atol=tol, err_msg=f"step {step}")
    np.testing.assert_array_equal(pt, jt)


def test_transplant_rejects_leftover_and_mismatch():
    jcfg, pcfg = _cfgs()
    params = jax.tree.map(np.array, JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    params["extra"] = {"w": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        load_reference(pcfg, params, device="cpu")
    del params["extra"]
    params["head"]["w"] = params["head"]["w"][:, :10]
    with pytest.raises(ValueError, match="head/w"):
        load_reference(pcfg, params, device="cpu")


def test_transplant_dtypes():
    jcfg, pcfg = _cfgs()
    params = jax.tree.map(np.array, JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    model = load_reference(pcfg, params, device="cpu", dtype=torch.bfloat16)
    assert model.layers[0].ffn.router.dtype == torch.float32
    assert model.layers[1].ln2.dtype == torch.float32 and model.ln_f.dtype == torch.float32
    for t in (model.embed, model.head, model.layers[0].mixer.q, model.layers[1].ffn.w_down):
        assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.layers[1].ffn.w_gate.float().numpy(),
        torch.from_numpy(params["stack"]["pos0"]["ffn"]["w_gate"][1]).to(torch.bfloat16).float().numpy(),
    )


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
@pytest.mark.parametrize("dtype,tol,seed", [(torch.float32, 1e-4, 1), (torch.bfloat16, 1e-1, 2)])
def test_moe_configs_prefill_decode_match_jax(monkeypatch, arch, dtype, tol, seed):
    """Qwen3-MoE-235B-A22B and DBRX-132B at smoke width (8 experts top-2,
    as ``smoke_config`` caps them), transplanted, under the serving table:
    the tolerances of the Mixtral test above; greedy tokens equal."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jdtype)
    monkeypatch.setattr(jax_attention, "USE_PALLAS_FLASH", True)
    jcfg, pcfg = _cfgs(arch)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=dtype)
    prompts = np.random.default_rng(seed).integers(0, pcfg.vocab_size, size=(B, S)).astype(np.int32)
    stats0 = uniform_estimate(pcfg, float(B * S * pcfg.moe.top_k))
    runtime, _ = make_serving_controller(jcfg, n_ranks=8, drift="none")
    runtime.observe(stats0)
    pruntime, _ = port_serving_controller(pcfg, n_ranks=8, drift="none", device="cpu")
    pruntime.observe(stats0)
    jl, jt = _run_jax(jcfg, params, prompts, runtime.table(), jdtype)
    pl, pt = _run_port(model, prompts, pruntime.table(), dtype)
    for step, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol, atol=tol, err_msg=f"{arch} step {step}")
    np.testing.assert_array_equal(pt, jt)


def test_qwen3_width_moe_layer_matches_jax(monkeypatch):
    """One MoE layer at Qwen3's 128 experts top-8 (``smoke_config`` caps
    experts at 8 and top-k at 2) at d 64, F 32, under a planned row at 16
    experts a virtual rank: f32 output within 1e-5 (the expert GEMMs sum
    in another order) and the stats equal."""
    from repro.configs import get_config as jax_get_config
    from repro.core import ScheduleTable as JaxTable
    from repro.core import decompose as jax_decompose
    from repro.core import plan_schedule as jax_plan
    from repro.models.moe import moe_apply as jax_moe_apply
    from repro.models.moe import moe_init as jax_moe_init

    from repro_torch.configs import get_config
    from repro_torch.core import ScheduleTable, decompose, plan_schedule
    from repro_torch.models.moe import moe_apply, moe_init

    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    arch = "qwen3-moe-235b-a22b"

    def narrow(cfg):
        return dataclasses.replace(cfg, d_model=64, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=32, dispatch="phase_pipelined", use_pallas=True))

    jcfg, pcfg = narrow(jax_get_config(arch)), narrow(get_config(arch))
    assert (pcfg.moe.n_experts, pcfg.moe.top_k) == (128, 8)
    params = jax.tree.map(np.array, jax_moe_init(jax.random.PRNGKey(3), jcfg))
    p = moe_init(pcfg, gen=None, device="cpu", dtype=torch.float32)
    p.router.data.copy_(torch.from_numpy(params["router"]["w"]))
    for name in ("w_gate", "w_up", "w_down"):
        getattr(p, name).data.copy_(torch.from_numpy(params[name]))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    m = rng.integers(20, 200, size=(8, 8)).astype(np.float64) * (rng.random((8, 8)) < 0.8)
    prow = ScheduleTable.from_schedules([plan_schedule(decompose(m, "maxweight"))], envelope="auto").row(0)
    jrow = JaxTable.from_schedules([jax_plan(jax_decompose(m, "maxweight"))], envelope="auto").row(0)
    for ps, js in ((None, None), (prow, jrow)):
        y, st = moe_apply(p, pcfg, torch.from_numpy(x), schedule=ps, return_stats=True)
        jy, jst = jax_moe_apply(params, jcfg, jnp.asarray(x), schedule=js, return_stats=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        for key in ("routing", "dropped"):
            np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]), err_msg=key)
        assert st["routing"].shape == (1, 128) and float(st["routing"].sum()) == 2 * 64 * 8
    assert float(st["admitted"]) < 2 * 64 * 8, "the row's dark pairs must clip some choices"


def test_qwen3_head_dim_attention_matches_jax(monkeypatch):
    """Qwen3's explicit head_dim makes the q width twice d (here d 64, 8
    heads of 16 over 2 KV heads, GQA group 4): prefill (flash) and two
    decode steps against ``repro.models.attention`` in f32, within 1e-5."""
    from repro.configs import get_config as jax_get_config
    from repro.models.attention import attn_decode as jax_decode
    from repro.models.attention import attn_init as jax_attn_init
    from repro.models.attention import attn_prefill as jax_prefill

    from repro_torch.configs import get_config
    from repro_torch.models.attention import attn_decode, attn_init, attn_prefill, init_cache

    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(jax_attention, "USE_PALLAS_FLASH", True)
    arch = "qwen3-moe-235b-a22b"

    def narrow(cfg):
        return dataclasses.replace(cfg, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16)

    jcfg, pcfg = narrow(jax_get_config(arch)), narrow(get_config(arch))
    assert pcfg.n_heads * pcfg.resolved_head_dim == 2 * pcfg.d_model
    params = jax.tree.map(np.array, jax_attn_init(jax.random.PRNGKey(5), jcfg))
    p = attn_init(pcfg, gen=None, device="cpu", dtype=torch.float32)
    for name in ("q", "k", "v", "o"):
        getattr(p, name).data.copy_(torch.from_numpy(params[name]["w"]))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    steps = rng.standard_normal((2, 2, 1, 64)).astype(np.float32)
    cache = init_cache(pcfg, 2, 14, dtype=torch.float32, device="cpu")
    jcache = {"k": jnp.zeros((2, 14, 2, 16)), "v": jnp.zeros((2, 14, 2, 16)), "pos": jnp.full((2, 14), -1, jnp.int32)}
    y, cache = attn_prefill(p, pcfg, torch.from_numpy(x), cache)
    jy, jcache = jax_prefill(params, jcfg, jnp.asarray(x), jcache)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for i, xs in enumerate(steps):
        y, cache = attn_decode(p, pcfg, torch.from_numpy(xs), cache, 12 + i)
        jy, jcache = jax_decode(params, jcfg, jnp.asarray(xs), jcache, jnp.int32(12 + i))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5, err_msg=f"decode {i}")
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=1e-5, atol=1e-5)

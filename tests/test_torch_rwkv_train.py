"""RWKV6 training in the port against the JAX package, at smoke size on
the CPU: the recurrence's backward (K5b's plain version,
``wkv6_bwd_plain``) against ``jax.vjp`` of the scan oracle and against
``torch.autograd`` of the plain forward, the smoke RWKV model's loss and
gradients against ``jax.grad`` of the JAX loss, three AdamW train steps
against the JAX train step, and the training launcher end to end through
``train_loop``.  JAX runs as its own tests run it on the CPU; its
parameters (``Model.init(PRNGKey(0))``) are transplanted into the port as
f32 masters.

Tolerances:
- ``wkv6_bwd_plain`` vs ``jax.vjp(wkv6_ref)`` in f32: 1e-5 relative to
  each gradient's largest magnitude (both in f32, sums in another order).
- the same against ``torch.autograd`` of ``wkv6_plain`` in f64: 1e-10
  (the same arithmetic, ordered differently).
- loss and gradients in f32 (``COMPUTE_DTYPE`` patched to f32 on the JAX
  side): 1e-4, as ``test_torch_train.py`` holds Mixtral; in bf16 the loss
  within 1e-2 and each leaf within 0.1 relative L2 (bf16 roundings land
  an ulp apart between the frameworks, as there).
- three AdamW steps in f32: losses within 1e-4, parameters within 2e-4
  absolute (``test_torch_train.py``'s reasons).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.configs import smoke_config as jax_smoke
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticStream as JaxStream
from repro.kernels.rwkv_wkv.ref import wkv6_ref
from repro.models import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine
from repro.train import make_train_step as jax_make_train_step

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.kernels.rwkv_wkv import wkv6_bwd_plain, wkv6_plain
from repro_torch.launch import train as train_mod
from repro_torch.models.transplant import load_reference, to_reference
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import make_train_step

ARCH = "rwkv6-7b"
B, S = 2, 16
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _wkv_case(b, h, t, d, seed, dtype=np.float32):
    """r/k/v ~ 0.5 N(0, 1), w in 0.45-0.95, u ~ 0.1 N(0, 1), s0 and dS_final ~ 0.3 N(0, 1), dy ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((b, h, t, d)) * 0.5).astype(dtype) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, t, d)))) * 0.5 + 0.45).astype(dtype)
    u = (rng.standard_normal((h, d)) * 0.1).astype(dtype)
    s0, ds = ((rng.standard_normal((b, h, d, d)) * 0.3).astype(dtype) for _ in range(2))
    dy = rng.standard_normal((b, h, t, d)).astype(dtype)
    return r, k, v, w, u, s0, dy, ds


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("b,h,t,d", [(2, 3, 17, 16), (1, 2, 40, 64)])
def test_wkv6_bwd_plain_matches_jax_vjp(b, h, t, d, carried):
    """From s0 with a nonzero dS_final (ds0 returned), or from 0 with dS_final 0."""
    r, k, v, w, u, s0, dy, ds = _wkv_case(b, h, t, d, seed=t + d)
    if not carried:
        s0, ds = None, np.zeros_like(ds)
    jx = [jnp.asarray(a) for a in (r, k, v, w, u)]
    if carried:
        (jy, js), vjp = jax.vjp(wkv6_ref, *jx, jnp.asarray(s0))
    else:
        (jy, js), vjp = jax.vjp(lambda *a: wkv6_ref(*a), *jx)
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = wkv6_bwd_plain(*(torch.from_numpy(a) for a in (r, k, v, w, u, dy)),
                         None if s0 is None else torch.from_numpy(s0), torch.from_numpy(ds) if carried else None)
    assert (got[5] is None) == (not carried)
    for name, g, wnt in zip(NAMES, got, want):
        wnt = np.asarray(wnt)
        assert g.dtype == torch.float32 and g.shape == wnt.shape, name
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-5, atol=1e-5 * np.abs(wnt).max(), err_msg=name)


@pytest.mark.parametrize("carried", [False, True])
def test_wkv6_bwd_plain_matches_torch_autograd_in_f64(carried):
    r, k, v, w, u, s0, dy, ds = (torch.from_numpy(a) for a in _wkv_case(2, 3, 23, 8, seed=5, dtype=np.float64))
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, *((s0,) if carried else ()))]
    y, s = wkv6_plain(*leaves)
    want = torch.autograd.grad((y * dy).sum() + ((s * ds).sum() if carried else 0.0), leaves)
    got = wkv6_bwd_plain(r, k, v, w, u, dy, s0 if carried else None, ds if carried else None)
    for name, g, wnt in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        torch.testing.assert_close(g, wnt, rtol=1e-10, atol=1e-10, msg=name)


# ------------------------------------------------------------- the model
def _cfgs(remat="none"):
    return dataclasses.replace(jax_smoke(ARCH), remat=remat), dataclasses.replace(smoke_config(ARCH), remat=remat)


def _batch(step=0):
    return JaxStream(JaxDataConfig(vocab_size=256, seq_len=S, global_batch=B)).batch(step)


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0])


def _port_model(pcfg, params, dtype):
    return load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=dtype,
                          param_dtype=torch.float32, requires_grad=True)


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_and_gradients_match_jax(monkeypatch, dtype, remat):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    jcfg, pcfg = _cfgs(remat)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    batch = _batch()
    jm = JaxModel(jcfg)
    jloss, jgrads = jax.jit(
        jax.value_and_grad(lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}))
    )(params)
    model = _port_model(pcfg, params, dtype)
    loss, stats = model.loss_and_stats({k: torch.from_numpy(v) for k, v in batch.items()})
    assert stats is None  # no MoE layer, as in JAX
    loss.backward()
    pgrads = _flat(to_reference({n: p.grad for n, p in model.named_parameters()}))
    ref = _flat(jgrads)
    assert pgrads.keys() == ref.keys()
    if dtype == torch.float32:
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4, atol=1e-4)
        for path, want in ref.items():
            np.testing.assert_allclose(pgrads[path], want, rtol=1e-4, atol=1e-4, err_msg=jax.tree_util.keystr(path))
    else:
        assert abs(float(loss.detach()) - float(jloss)) < 1e-2
        for path, want in ref.items():
            rel = np.linalg.norm(pgrads[path] - want) / np.linalg.norm(want)
            assert rel < 0.1, (jax.tree_util.keystr(path), rel)


def test_train_steps_match_jax(monkeypatch):
    """Three AdamW steps at lr 1e-3 with JAX's stacked-rank decay (``Model.reference_ranks``) on every
    RWKV leaf: mixes, LoRA weights, w0, u, the group norm and the eight dense weights."""
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jcfg, pcfg = _cfgs()
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = _port_model(pcfg, params, torch.float32)
    ranks, groups, flat = model.reference_ranks(), model.reference_groups(), _flat(params)
    # one group per JAX leaf, each tensor of a group at its leaf's rank
    assert len(groups) == len(flat) and ["layers.0.mixer.ln_x_bias", "layers.1.mixer.ln_x_bias"] in groups
    assert all(len({ranks[n] for n in g}) == 1 for g in groups)
    assert sorted(ranks[g[0]] for g in groups) == sorted(v.ndim for v in flat.values())
    assert ranks["layers.0.mixer.w0"] == 2 and ranks["layers.1.mixer.u"] == 3 and ranks["layers.0.mixer.mu"] == 3
    jopt = JaxAdamW(lr=jax_cosine(1e-3, 1, 3))
    jstep = jax.jit(jax_make_train_step(JaxModel(jcfg), jopt))
    pstep = make_train_step(model, AdamW(lr=cosine_schedule(1e-3, 1, 3)))
    jparams, jstate = params, jopt.init(params)
    for step in range(3):
        batch = _batch(step)
        jparams, jstate, _, jm = jstep(jparams, jstate, None, {k: jnp.asarray(v) for k, v in batch.items()})
        pm = pstep({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    got, want = _flat(to_reference(model)), _flat(jparams)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-4, err_msg=jax.tree_util.keystr(path))


def test_train_launcher_runs_rwkv_through_the_loop(tmp_path):
    """``--dispatch`` is left alone for a model without MoE (it used to rebuild ``cfg.moe``); no table;
    checkpoints and a resume, as for Mixtral."""
    argv = ["--arch", ARCH, "--smoke", "--seq", "16", "--batch", "2", "--dispatch", "phase_pipelined",
            "--device", "cpu", "--ckpt", str(tmp_path)]
    res = train_mod.main([*argv, "--steps", "3"])
    assert res["table"] is None and res["final_step"] == 3 and res["failures"] == 0
    assert [h["step"] for h in res["history"]] == [0, 2] and all(np.isfinite([h["loss"] for h in res["history"]]))
    assert CheckpointManager(str(tmp_path)).steps() == [3]
    res = train_mod.main([*argv, "--steps", "4"])
    assert [h["step"] for h in res["history"]] == [3] and res["final_step"] == 4

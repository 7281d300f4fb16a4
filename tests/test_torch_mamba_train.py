"""Training the Mamba hybrid and the dense configs in the port against the
JAX package, at smoke size on the CPU: the selective scan's backward (K6b's
plain version, ``selective_scan_bwd_plain``) against ``torch.autograd`` of
the plain forward and against ``jax.vjp`` of ``_scan_ssm``, the Mamba
mixer's gradients against ``jax.vjp`` of ``repro.models.mamba.mamba_seq``,
the smoke Jamba (Mamba, attention and MoE layers under a table whose rows
differ) loss and every gradient leaf against ``jax.value_and_grad`` of the
JAX loss with remat none and block, three AdamW steps, qwen2-1.5b's tied
head and musicgen-large's frames prefix, and the training launcher's data
for the frontend configs (its first batch and the loss on it) and a Jamba
run through ``train_loop``.  JAX runs as its own tests run it on the CPU;
its parameters (``Model.init(PRNGKey(0))``) are transplanted into the port
as f32 masters, with ``COMPUTE_DTYPE`` patched to f32 on the JAX side.

Tolerances:
- ``selective_scan_bwd_plain`` against ``torch.autograd`` of
  ``selective_scan_plain`` in f64: 1e-10 (the same arithmetic, ordered
  differently); against ``jax.vjp(_scan_ssm)`` in f32: 1e-5 relative to
  each gradient's largest magnitude.
- the mixer's gradients (every parameter and the input) in f32: 1e-4
  relative L2 each.
- loss and gradients of the models in f32: 1e-4 (``rtol`` and ``atol``),
  as ``test_torch_train.py`` holds Mixtral.
- three AdamW steps in f32: losses within 1e-4, parameters within 2e-4
  absolute (``test_torch_train.py``'s reasons).
- the launcher's first batch: equal to JAX's stream, array for array; the
  loss on it within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.configs import smoke_config as jax_smoke
from repro.core import ScheduleTable as JaxTable
from repro.core import decompose as jax_decompose
from repro.core import plan_schedule as jax_plan
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticStream as JaxStream
from repro.models import Model as JaxModel
from repro.models import mamba as jm
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine
from repro.train import make_train_step as jax_make_train_step

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.core import ScheduleTable, decompose, plan_schedule
from repro_torch.data import SyntheticStream
from repro_torch.kernels.mamba_scan import selective_scan_bwd_plain, selective_scan_plain
from repro_torch.launch import train as train_mod
from repro_torch.models import Model
from repro_torch.models import mamba as pm
from repro_torch.models.transplant import load_reference, to_reference
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import make_train_step

JAMBA = "jamba-1.5-large-398b"
B, S = 2, 16
NAMES = ("dx", "ddt", "db", "dc", "da", "dd_skip", "dh0")


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)


# ------------------------------------------------------------ the scan
def _scan_case(b, s, di, ds, seed, dtype=np.float64):
    """x ~ N(0, 1), dt in 0.001-0.5, B/C ~ N(0, 1), a in -(0.5-16), d_skip, h0, dy and dh_final ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, di))
    dt = rng.uniform(0.001, 0.5, (b, s, di))
    bm, cm = rng.standard_normal((b, s, ds)), rng.standard_normal((b, s, ds))
    a = -rng.uniform(0.5, 16, (di, ds))
    d_skip, h0 = rng.standard_normal(di), rng.standard_normal((b, di, ds))
    dy, dh = rng.standard_normal((b, s, di)), rng.standard_normal((b, di, ds))
    return [torch.from_numpy(v.astype(dtype)) for v in (x, dt, bm, cm, a, d_skip, h0, dy, dh)]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("b,s,di,ds", [(2, 23, 7, 16), (1, 40, 5, 3)])
def test_scan_bwd_plain_matches_torch_autograd_in_f64(b, s, di, ds, carried):
    """From h0 with a nonzero dh_final (dh0 returned), or from zeros with neither (dh0 None)."""
    x, dt, bm, cm, a, d_skip, h0, dy, dh = _scan_case(b, s, di, ds, seed=s + ds)
    leaves = [v.clone().requires_grad_() for v in (x, dt, bm, cm, a, d_skip, *((h0,) if carried else ()))]
    y, h = selective_scan_plain(*leaves)
    assert y.dtype == h.dtype == torch.float64
    want = torch.autograd.grad((y * dy).sum() + ((h * dh).sum() if carried else 0.0), leaves)
    got = selective_scan_bwd_plain(x, dt, bm, cm, a, d_skip, dy, h0 if carried else None, dh if carried else None)
    assert (got[6] is None) == (not carried)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


def test_scan_bwd_plain_matches_jax_vjp_of_scan_ssm(f32):
    """The scan's part of ``_scan_ssm``'s vjp (x, dt, B, C, a, d_skip, h0) in f32, at a length JAX chunks
    and rematerialises (S = 24: chunks of 8)."""
    x, dt, bm, cm, a, d_skip, h0, dy, dh = (v.float() for v in _scan_case(2, 24, 6, 16, seed=3))

    def scan(x, dt, bm, cm, a, d_skip, h0):
        """``_scan_ssm`` with its dt, B and C given (its ``_ssm_params`` swapped for the call)."""
        saved = jm._ssm_params
        jm._ssm_params = lambda p, c, xc: (dt, bm, cm)
        try:
            return jm._scan_ssm({"a_log": jnp.log(-a), "d_skip": d_skip}, jax_smoke(JAMBA), x, h0)
        finally:
            jm._ssm_params = saved

    args = [jnp.asarray(v.numpy()) for v in (x, dt, bm, cm, a, d_skip, h0)]
    _, vjp = jax.vjp(scan, *args)
    want = vjp((jnp.asarray(dy.numpy()), jnp.asarray(dh.numpy())))
    got = selective_scan_bwd_plain(x, dt, bm, cm, a, d_skip, dy, h0, dh)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=name)


# ------------------------------------------------------------ the mixer
def test_mixer_gradients_match_jax_vjp(f32):
    """``mamba_seq``'s gradients in every parameter and the input, with cotangents on y, the final state
    and the conv tail, against ``jax.vjp`` of the JAX mixer on the same weights (a_log, dt_bias, d_skip
    and conv_b moved off their init so each term counts)."""
    jcfg, pcfg = jax_smoke(JAMBA), smoke_config(JAMBA)
    params = jax.tree.map(np.array, jm.mamba_init(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(11)
    params["a_log"] = params["a_log"] + 0.3 * rng.standard_normal(params["a_log"].shape).astype(np.float32)
    params["dt_bias"] = params["dt_bias"] + rng.uniform(0, 2, params["dt_bias"].shape).astype(np.float32)
    params["d_skip"] = rng.standard_normal(params["d_skip"].shape).astype(np.float32)
    params["conv_b"] = 0.1 * rng.standard_normal(params["conv_b"].shape).astype(np.float32)
    p = pm.Mamba(pcfg, gen=None, device="cpu", dtype=torch.float32)
    for n in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        getattr(p, n).data.copy_(torch.from_numpy(params[n]["w"]))
    for n in ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip"):
        getattr(p, n).data.copy_(torch.from_numpy(params[n]))
    p.requires_grad_(True)
    x = rng.standard_normal((B, 24, pcfg.d_model)).astype(np.float32)
    di, ds, cw, _ = pm.mamba_dims(pcfg)
    gy = rng.standard_normal((B, 24, pcfg.d_model)).astype(np.float32)
    gh = rng.standard_normal((B, di, ds)).astype(np.float32)
    gt = rng.standard_normal((B, cw - 1, di)).astype(np.float32)
    _, vjp = jax.vjp(lambda prm, xx: jm.mamba_seq(prm, jcfg, xx), params, jnp.asarray(x))
    jgrads, jdx = vjp((jnp.asarray(gy), (jnp.asarray(gh), jnp.asarray(gt))))
    xt = torch.from_numpy(x).requires_grad_()
    y, (h, tail) = pm.mamba_seq(p, pcfg, xt)
    ((y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum()
     + (tail * torch.from_numpy(gt)).sum()).backward()

    def rel(got, want):
        want = np.asarray(want)
        return np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want)

    assert rel(xt.grad, jdx) <= 1e-4
    for n in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        assert rel(getattr(p, n).grad, jgrads[n]["w"]) <= 1e-4, n
    for n in ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip"):
        assert rel(getattr(p, n).grad, jgrads[n]) <= 1e-4, n


# ------------------------------------------------------------- the models
def _cfgs(arch, remat="none"):
    jcfg, pcfg = jax_smoke(arch), smoke_config(arch)
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch="phase_pipelined"))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="phase_pipelined"))
    return dataclasses.replace(jcfg, remat=remat), dataclasses.replace(pcfg, remat=remat)


def _tables(pcfg):
    """(port table, JAX table): one planned row per MoE layer from its own seeded demand, rows all differ."""
    if pcfg.moe is None:
        return None, None
    rng = np.random.default_rng(9)
    mats = [rng.integers(5, 60, size=(8, 8)).astype(np.float64) * (rng.random((8, 8)) < 0.7)
            for _ in range(pcfg.n_moe_layers)]
    ptable = ScheduleTable.from_schedules([plan_schedule(decompose(m, "maxweight")) for m in mats], envelope="auto")
    jtable = JaxTable.from_schedules([jax_plan(jax_decompose(m, "maxweight")) for m in mats], envelope="auto")
    assert len({tuple(ptable.caps[i].flatten().tolist()) for i in range(ptable.num_layers)}) == ptable.num_layers
    return ptable, jtable


def _batch(jcfg, step=0, seq=S):
    """JAX's launcher data: a frontend config's seq positions are its prefix embeddings, then tokens."""
    prefix = jcfg.frontend_tokens if jcfg.frontend != "none" else 0
    return JaxStream(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=seq, global_batch=B,
                                   frontend_tokens=prefix, d_model=jcfg.d_model)).batch(step)


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0])


def _port_model(pcfg, params):
    return load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=torch.float32,
                          param_dtype=torch.float32, requires_grad=True)


def _loss_and_grads_match(arch, remat, seq=S):
    jcfg, pcfg = _cfgs(arch, remat)
    ptable, jtable = _tables(pcfg)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    batch = _batch(jcfg, seq=seq)
    jmodel = JaxModel(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, schedule=jtable)))(params)
    model = _port_model(pcfg, params)
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()}, schedule=ptable)
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    pgrads = _flat(to_reference({n: p.grad for n, p in model.named_parameters()}, pcfg))
    ref = _flat(jgrads)
    assert pgrads.keys() == ref.keys()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4, atol=1e-4)
    for path, want in ref.items():
        np.testing.assert_allclose(pgrads[path], want, rtol=1e-4, atol=1e-4, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", ["none", "block"])
def test_jamba_loss_and_gradients_match_jax(f32, remat):
    """Both periods of the smoke Jamba (Mamba at 14 layers, attention at 2, MoE at 8 under a table whose
    rows differ); under ``remat="block"`` the backward recomputes each block, K6 included."""
    _loss_and_grads_match(JAMBA, remat)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "musicgen-large"])
def test_dense_config_gradients_match_jax(f32, arch):
    """qwen2's tied table (the head's and the embedding's gradients sum into one leaf) and QKV biases;
    musicgen's frames prefix (positions without loss) and sinusoidal positions over the whole sequence."""
    _loss_and_grads_match(arch, "block", seq=S + 4)


def test_jamba_train_steps_match_jax(f32):
    """Three AdamW steps at lr 1e-3 with JAX's decay by stacked rank: d_skip, dt_bias and conv_b are
    stacked over periods in JAX (rank 2), so they decay; the port's ``reference_ranks`` says so."""
    jcfg, pcfg = _cfgs(JAMBA)
    ptable, jtable = _tables(pcfg)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = _port_model(pcfg, params)
    ranks, groups, flat = model.reference_ranks(), model.reference_groups(), _flat(params)
    assert len(groups) == len(flat) and all(len({ranks[n] for n in g}) == 1 for g in groups)
    assert sorted(ranks[g[0]] for g in groups) == sorted(v.ndim for v in flat.values())
    for leaf in ("d_skip", "dt_bias", "conv_b"):
        assert ranks[f"layers.0.mixer.{leaf}"] == 2
    assert ranks["layers.0.mixer.a_log"] == 3 and ["layers.0.mixer.d_skip", "layers.8.mixer.d_skip"] in groups
    jopt = JaxAdamW(lr=jax_cosine(1e-3, 1, 3))
    jstep = jax.jit(jax_make_train_step(JaxModel(jcfg), jopt))
    pstep = make_train_step(model, AdamW(lr=cosine_schedule(1e-3, 1, 3)))
    jparams, jstate = params, jopt.init(params)
    for step in range(3):
        batch = _batch(jcfg, step)
        jparams, jstate, _, jmet = jstep(jparams, jstate, None, {k: jnp.asarray(v) for k, v in batch.items()}, jtable)
        pmet = pstep({k: torch.from_numpy(v) for k, v in batch.items()}, ptable)
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(pmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    got, want = _flat(to_reference(model)), _flat(jparams)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-4, err_msg=jax.tree_util.keystr(path))


def test_jamba_cut_below_a_period_groups_by_position():
    """``--layers 1`` builds one Mamba + dense SwiGLU layer: each leaf is its own group, at the rank the
    JAX leaf stacked over periods would have (so d_skip, dt_bias and conv_b decay)."""
    pcfg = dataclasses.replace(smoke_config(JAMBA), n_layers=1)
    model = Model(pcfg, device="cpu", dtype=torch.float32, param_dtype=torch.float32, requires_grad=True)
    assert model.layers[0].kind == "mamba" and pcfg.n_moe_layers == 0
    groups, ranks = model.reference_groups(), model.reference_ranks()
    assert all(len(g) == 1 for g in groups) and len(groups) == len(ranks)
    assert {ranks[f"layers.0.mixer.{n}"] for n in ("d_skip", "dt_bias", "conv_b")} == {2}
    assert ranks["layers.0.ffn.w_gate"] == 3 and ranks["embed"] == 2


# ------------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-large"])
def test_launcher_feeds_frontend_configs_as_jax(f32, monkeypatch, arch):
    """The launcher's data for a frontend config: ``frontend_tokens`` prefix embeddings, then
    ``seq - frontend_tokens`` tokens, JAX's stream array for array; ``main`` hands that config to the loop;
    the port's loss on the first batch equals JAX's ``Model.loss`` within 1e-4."""
    jcfg, pcfg = _cfgs(arch)
    seq = S + pcfg.frontend_tokens
    cfg = train_mod.data_config(pcfg, seq=seq, batch=B)
    assert cfg.frontend_tokens == pcfg.frontend_tokens > 0 and cfg.d_model == pcfg.d_model
    got, want = SyntheticStream(cfg).batch(0), _batch(jcfg, seq=seq)
    assert got.keys() == want.keys() == {"tokens", "targets", "ext_embeds"}
    assert got["tokens"].shape == (B, S) and got["ext_embeds"].shape == (B, pcfg.frontend_tokens, pcfg.d_model)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    seen = {}

    def loop(model, data_cfg, loop_cfg, schedule=None):
        seen["data"] = data_cfg
        return {"final_step": 0, "final_loss": 0.0, "failures": 0}

    monkeypatch.setattr(train_mod, "train_loop", loop)
    train_mod.main(["--arch", arch, "--smoke", "--steps", "1", "--seq", str(seq), "--batch", str(B), "--device", "cpu"])
    assert seen["data"] == cfg
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    jloss = float(JaxModel(jcfg).loss(params, {k: jnp.asarray(v) for k, v in want.items()}))
    ploss = float(_port_model(pcfg, params).loss({k: torch.from_numpy(v) for k, v in got.items()}).detach())
    assert abs(ploss - jloss) <= 1e-4 * max(1.0, abs(jloss)), (ploss, jloss)


def test_train_launcher_runs_jamba_through_the_loop(tmp_path):
    """The smoke Jamba through ``main``: a table over its MoE layers, checkpoints and a resume."""
    argv = ["--arch", JAMBA, "--smoke", "--seq", "16", "--batch", "2", "--dispatch", "phase_pipelined",
            "--device", "cpu", "--ckpt", str(tmp_path)]
    res = train_mod.main([*argv, "--steps", "2"])
    pcfg = smoke_config(JAMBA)
    assert res["table"] is not None and res["table"].num_layers == pcfg.n_moe_layers
    assert res["final_step"] == 2 and res["failures"] == 0 and all(np.isfinite([h["loss"] for h in res["history"]]))
    assert CheckpointManager(str(tmp_path)).steps() == [2]
    res = train_mod.main([*argv, "--steps", "3"])
    assert res["final_step"] == 3

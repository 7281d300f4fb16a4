"""Training-slice parity: the port's loss, gradients, AdamW, data stream
and train step against the JAX package on the smoke Mixtral.

The JAX side runs as its own tests run it on the CPU: ``use_pallas=True``
(the grouped MoE kernel forward and its Pallas dgrad/wgrad backward in
interpret mode), parameters from ``Model.init(PRNGKey(0))`` transplanted
into the port as f32 masters, and a ``phase_pipelined`` table planned on
each side from the launcher's lossless recipe (the tables are equal).

Tolerances:
- f32 (``COMPUTE_DTYPE`` patched to f32 on the JAX side): loss and every
  gradient leaf within 1e-4 (observed: within 1e-6 relative); AdamW
  within 1e-6.
- bf16: loss within 1e-2 and each gradient leaf within 0.1 relative L2.
  The JAX package's own bf16 gradients differ from its f32 ones by up to
  5.8% relative L2 on this batch (router), the port's by up to 2%; the
  port-vs-JAX gap (up to 5.7%) is that rounding, not the algorithm.
- Three train steps in f32: losses within 1e-4 (observed 5e-7);
  parameters within 2e-4 absolute after three AdamW steps at lr 1e-3
  (observed 1.9e-5: an update is lr * m/(sqrt(v)+eps), so a gradient
  element near zero moves its parameter by a visible fraction of lr
  between the two frameworks' roundings).  The same with ef8 (observed
  3.2e-5); its ef state within one quantum, and within 1e-5 but for at
  most 0.1% of elements (a q flipped by the 1e-7 gradient gap).
- ef8 on the same gradients: bit for bit.
- ``attn_chunked`` in f32: output within 1e-5, gradients within 1e-4 +
  1e-5 relative.
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
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticStream as JaxStream
from repro.launch.dryrun import build_schedule as jax_build_schedule
from repro.models import Model as JaxModel
from repro.models.attention import attn_chunked as jax_attn_chunked
from repro.optim import AdamW as JaxAdamW
from repro.optim import ef_int8_compress as jax_ef_compress
from repro.optim import ef_int8_init as jax_ef_init
from repro.optim import cosine_schedule as jax_cosine
from repro.train import make_train_step as jax_make_train_step

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.core.traffic import RouterConfig, traffic_matrix
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch import train as train_mod
from repro_torch.launch.dryrun import expected_traffic
from repro_torch.launch.train import plan_table
from repro_torch.models import attention
from repro_torch.models.transplant import load_reference, to_reference
from repro_torch.optim import AdamW, cosine_schedule, ef_int8_compress, ef_int8_init
from repro_torch.train import make_train_step

B, S = 4, 32


def _cfgs(remat="none"):
    jcfg = jax_smoke("mixtral-8x7b")
    jcfg = dataclasses.replace(
        jcfg, remat=remat, moe=dataclasses.replace(jcfg.moe, dispatch="phase_pipelined", use_pallas=True)
    )
    pcfg = smoke_config("mixtral-8x7b")
    pcfg = dataclasses.replace(pcfg, remat=remat, moe=dataclasses.replace(pcfg.moe, dispatch="phase_pipelined"))
    return jcfg, pcfg


def _tables(jcfg, pcfg):
    sched = jax_build_schedule(jcfg, 8, B * S // 8, plan="lossless")
    jtable = JaxTable.from_schedules([sched] * jcfg.n_layers, envelope="auto")
    return jtable, plan_table(pcfg, batch=B, seq=S, virtual_ranks=8, device="cpu")


def _batch(step=0):
    return JaxStream(JaxDataConfig(vocab_size=256, seq_len=S, global_batch=B)).batch(step)


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0])


def _port_model(pcfg, params, dtype):
    """The JAX parameters as f32 masters of a port model computing in ``dtype``."""
    return load_reference(
        pcfg, jax.tree.map(np.array, params), device="cpu", dtype=dtype, param_dtype=torch.float32,
        requires_grad=True,
    )


def test_launcher_table_equals_jax_plan():
    jcfg, pcfg = _cfgs()
    jtable, ptable = _tables(jcfg, pcfg)
    for name in ("perms", "caps", "valid", "offsets", "n_phases"):
        np.testing.assert_array_equal(getattr(ptable, name).numpy(), np.asarray(getattr(jtable, name)), err_msg=name)
    assert ptable.envelope == jtable.envelope
    from repro.core.traffic import RouterConfig as JaxRouter, traffic_matrix as jax_traffic
    from repro.launch.dryrun import expected_traffic as jax_expected

    np.testing.assert_array_equal(expected_traffic(pcfg, 8, 16), jax_expected(jcfg, 8, 16))
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(
        traffic_matrix(rng_a, RouterConfig("r", 16, 4), np.arange(1, 9) * 10, n_ranks=8, skew_alpha=0.5),
        jax_traffic(rng_b, JaxRouter("r", 16, 4), np.arange(1, 9) * 10, n_ranks=8, skew_alpha=0.5),
    )


@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_stream_batches_equal(step):
    cfg = dict(vocab_size=256, seq_len=S, global_batch=B, seed=3)
    port = SyntheticStream(DataConfig(**cfg)).batch(step)
    ref = JaxStream(JaxDataConfig(**cfg)).batch(step)
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k])


@pytest.mark.parametrize(
    "dtype,remat",
    [(torch.float32, "none"), (torch.bfloat16, "none"), (torch.float32, "block")],
)
def test_loss_and_gradients_match_jax(monkeypatch, dtype, remat):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    jcfg, pcfg = _cfgs(remat)
    jtable, ptable = _tables(jcfg, pcfg)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    batch = _batch()
    jm = JaxModel(jcfg)
    jloss, jgrads = jax.jit(
        jax.value_and_grad(lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, schedule=jtable))
    )(params)
    model = _port_model(pcfg, params, dtype)
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()}, schedule=ptable)
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


def test_forward_logits_match_jax(monkeypatch):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jcfg, pcfg = _cfgs()
    jtable, ptable = _tables(jcfg, pcfg)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tokens = _batch()["tokens"]
    ref = jax.jit(lambda p, t: JaxModel(jcfg).forward(p, t, schedule=jtable))(params, jnp.asarray(tokens))
    with torch.no_grad():
        out = _port_model(pcfg, params, torch.float32)(torch.from_numpy(tokens), schedule=ptable)
    assert out.dtype == torch.float32 and out.shape == (B, S, pcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_adamw_update_matches_jax():
    """One update on the transplanted tree with the same gradients; the
    stacked per-layer norm scales decay, the final norm does not."""
    jcfg, pcfg = _cfgs()
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), params)
    jopt = JaxAdamW(lr=jax_cosine(1e-2, 2, 10), weight_decay=0.1, clip_norm=1.0)
    jstate = jopt.init(params)
    jparams, jstate, jstats = jopt.update(grads, jstate, params)
    jparams, jstate, jstats = jopt.update(grads, jstate, jparams)  # a second step: bias correction moves

    model = _port_model(pcfg, params, torch.float32)
    pgrad_model = load_reference(pcfg, grads, device="cpu", dtype=torch.float32, param_dtype=torch.float32)
    opt = AdamW(lr=cosine_schedule(1e-2, 2, 10), weight_decay=0.1, clip_norm=1.0)
    named = dict(model.named_parameters())
    state = opt.init(named, ranks=model.reference_ranks())
    assert state["decay"]["layers.0.ln1"] and state["decay"]["layers.1.ln2"] and not state["decay"]["ln_f"]
    for _ in range(2):
        g = {n: t.detach().clone() for n, t in pgrad_model.named_parameters()}
        _, state, stats = opt.update(g, state, named)
    np.testing.assert_allclose(float(stats["grad_norm"]), float(jstats["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(stats["lr"], float(jstats["lr"]), rtol=1e-6)
    got, want = _flat(to_reference(model)), _flat(jparams)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-6, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(monkeypatch, microbatches):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jcfg, pcfg = _cfgs()
    jtable, ptable = _tables(jcfg, pcfg)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = _port_model(pcfg, params, torch.float32)
    jopt = JaxAdamW(lr=jax_cosine(1e-3, 1, 3))
    jstep = jax.jit(jax_make_train_step(JaxModel(jcfg), jopt, microbatches=microbatches, collect_routing=True))
    pstep = make_train_step(model, AdamW(lr=cosine_schedule(1e-3, 1, 3)), microbatches=microbatches,
                            collect_routing=True)
    jparams, jstate = params, jopt.init(params)
    for step in range(3):
        batch = _batch(step)
        jparams, jstate, _, jm = jstep(jparams, jstate, None, {k: jnp.asarray(v) for k, v in batch.items()}, jtable)
        pm = pstep({k: torch.from_numpy(v) for k, v in batch.items()}, ptable)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        for key in ("routing", "dropped"):  # the JAX stats carry no "admitted"
            np.testing.assert_array_equal(pm["moe_stats"][key].numpy(), np.asarray(jm["moe_stats"][key]))
    got, want = _flat(to_reference(model)), _flat(jparams)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-4, err_msg=jax.tree_util.keystr(path))


def test_train_entry_point_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--smoke", "--steps", "1"])
    res = train_mod.main(
        ["--smoke", "--steps", "3", "--seq", "16", "--batch", "2", "--dispatch", "phase_pipelined", "--device", "cpu",
         "--ckpt", str(tmp_path), "--grad-compress", "ef8"]
    )
    assert res["final_step"] == 3 and res["failures"] == 0
    assert [h["step"] for h in res["history"]] == [0, 2] and all(np.isfinite([h["loss"] for h in res["history"]]))
    assert res["table"] is not None and res["table"].num_layers == 2
    assert CheckpointManager(str(tmp_path)).steps() == [3]
    # the same directory again: the loop resumes at step 3 and runs on to 4
    res = train_mod.main(
        ["--smoke", "--steps", "4", "--seq", "16", "--batch", "2", "--dispatch", "phase_pipelined", "--device", "cpu",
         "--ckpt", str(tmp_path), "--grad-compress", "ef8"]
    )
    assert [h["step"] for h in res["history"]] == [3] and res["final_step"] == 4


def test_unknown_grad_compress_raises():
    jcfg, pcfg = _cfgs()
    model = _port_model(pcfg, JaxModel(jcfg).init(jax.random.PRNGKey(0)), torch.float32)
    with pytest.raises(ValueError, match="ef8"):
        make_train_step(model, AdamW(), grad_compress="pod")


def test_ef8_equals_jax_bit_for_bit():
    """Four seeded steps of error-feedback compression on gradients in the
    JAX tree's layout (block leaves stacked over layers, one scale each):
    the decompressed gradients and the ef state equal JAX's bit for bit
    (the module doc says which roundings make that so)."""
    jcfg, pcfg = _cfgs()
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = _port_model(pcfg, params, torch.float32)
    groups = model.reference_groups()
    assert ["layers.0.ffn.w_gate", "layers.1.ffn.w_gate"] in groups and ["ln_f"] in groups
    rng = np.random.default_rng(11)
    jef = jax_ef_init(params)
    pef = ef_int8_init(dict(model.named_parameters()))
    for step in range(4):
        # magnitudes over five decades, one leaf all zeros
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 10.0 ** rng.uniform(-4, 1, a.shape)).astype(np.float32), params
        )
        grads["ln_f"]["scale"] = np.zeros_like(grads["ln_f"]["scale"])
        jdeq, jef = jax.jit(jax_ef_compress)(grads, jef)
        pg = load_reference(pcfg, grads, device="cpu", dtype=torch.float32, param_dtype=torch.float32)
        pgrads = {n: t.detach().clone() for n, t in pg.named_parameters()}
        ef_int8_compress(pgrads, pef, groups)
        for got, want in ((pgrads, jdeq), (pef, jef)):
            flat_got, flat_want = _flat(to_reference(got)), _flat(want)
            for path, w in flat_want.items():
                np.testing.assert_array_equal(flat_got[path], w, err_msg=f"step {step} {jax.tree_util.keystr(path)}")


def test_ef8_train_steps_match_jax(monkeypatch):
    """Three ``grad_compress="ef8"`` steps against JAX's at the f32
    tolerances of ``test_train_steps_match_jax``."""
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jcfg, pcfg = _cfgs()
    jtable, ptable = _tables(jcfg, pcfg)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = _port_model(pcfg, params, torch.float32)
    jopt = JaxAdamW(lr=jax_cosine(1e-3, 1, 3))
    jstep = jax.jit(jax_make_train_step(JaxModel(jcfg), jopt, grad_compress="ef8"))
    pstep = make_train_step(model, AdamW(lr=cosine_schedule(1e-3, 1, 3)), grad_compress="ef8")
    jparams, jstate, jef = params, jopt.init(params), jax_ef_init(params)
    for step in range(3):
        batch = _batch(step)
        jparams, jstate, jef, jm = jstep(jparams, jstate, jef, {k: jnp.asarray(v) for k, v in batch.items()}, jtable)
        pm = pstep({k: torch.from_numpy(v) for k, v in batch.items()}, ptable)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    got, want = _flat(to_reference(model)), _flat(jparams)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-4, err_msg=jax.tree_util.keystr(path))
    # the residuals: where the two sides' f32 gradients (1e-7 apart) put
    # x / scale on opposite sides of a rounding boundary, q differs by one
    # and the residual by one quantum (the scale, >= 2 max|e|), and by part
    # of one in later steps; all within one quantum, and at most 0.1% of
    # each leaf beyond 1e-5 (observed: 3 elements of 65536 in w_gate)
    got_ef = _flat(to_reference(pstep.state["ef"]))
    for path, w in _flat(jef).items():
        diff = np.abs(got_ef[path] - w)
        quantum = 2 * np.abs(w).max() * (1 + 1e-3)
        assert diff.max() <= quantum, (jax.tree_util.keystr(path), diff.max(), quantum)
        assert (diff > 1e-5).mean() <= 1e-3, (jax.tree_util.keystr(path), (diff > 1e-5).sum())


@pytest.mark.parametrize("seq", [1536, 2048])
def test_attn_chunked_matches_jax(monkeypatch, seq):
    """The chunked online softmax against JAX ``attn_chunked`` on layer 0
    of the transplanted smoke Mixtral in f32: the output within 1e-5 and
    the gradients of x and of the q/k/v/o weights within 1e-4 + 1e-5
    relative (observed 1e-6 and 6e-5 at |grad| up to 53: sums in another
    order).  ``attn_train`` takes this path beyond 2 * CHUNK tokens."""
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jcfg, pcfg = _cfgs()
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = _port_model(pcfg, params, torch.float32)
    mix = jax.tree.map(lambda a: a[0], params["stack"]["pos0"]["mixer"])
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((1, seq, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((1, seq, jcfg.d_model)).astype(np.float32)
    jy, vjp = jax.vjp(jax.jit(lambda m, x_: jax_attn_chunked(m, jcfg, x_)[0]), mix, jnp.asarray(x))
    jg, jgx = vjp(jnp.asarray(ct))
    att = model.layers[0].mixer
    xt = torch.from_numpy(x).requires_grad_(True)
    y = attention.attn_train(att, pcfg, xt)
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-4)
    for name in "qkvo":
        np.testing.assert_allclose(getattr(att, name).grad.numpy(), np.asarray(jg[name]["w"]), rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    with torch.no_grad():  # and it is the same function as the full path
        np.testing.assert_allclose(attention.attn_full(att, pcfg, xt).numpy(), y.detach().numpy(), rtol=0, atol=1e-5)

"""The seven configs of the twelfth slice at smoke width against the JAX
package, JAX weights transplanted into the port: granite-34b (GELU MLP,
MQA), granite-3-8b, h2o-danube-3-4b (sliding window), qwen2-1.5b (QKV
bias, tied embeddings), internvl2-26b and musicgen-large (patch / frames
prefix, musicgen's sinusoidal positions) and jamba-1.5-large-398b (Mamba
and attention interleaved, MoE on every second layer under a schedule
table whose rows differ).

The JAX side runs as its own tests run it on the CPU: the default
``attn_full`` prefill (``USE_PALLAS_FLASH = False``); the port's kernel
path is always on, and on CPU tensors its wrappers run the plain
versions.  Tolerances: f32 (``COMPUTE_DTYPE`` patched to f32 on the JAX
side) logits within 1e-4, as ``test_torch_model.py``, and greedy tokens
equal; bf16 logits within 0.1 and greedy tokens equal (the rule of
``test_torch_model.py``).  h2o-danube's prompts are a multiple of its
smoke window (8): after a prompt of ``S % window != 0`` tokens the JAX
decode evicts a position still inside the window and the port does not
(``test_ring_slot_decode_matches_attn_full``).
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
from repro.models import Model as JaxModel

from repro_torch.configs import smoke_config
from repro_torch.core import ScheduleTable, decompose, plan_schedule
from repro_torch.models import stack
from repro_torch.models.transplant import load_reference, to_reference

B, S, NEW = 2, 16, 4
JAMBA = "jamba-1.5-large-398b"
ARCHS = ("granite-34b", "granite-3-8b", "h2o-danube-3-4b", "qwen2-1.5b", "internvl2-26b", "musicgen-large", JAMBA)


def _cfgs(arch):
    jcfg, pcfg = jax_smoke(arch), smoke_config(arch)
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch="phase_pipelined"))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="phase_pipelined"))
    return jcfg, pcfg


def _tables(pcfg):
    """(port table, JAX table): one planned row per MoE layer, each from its
    own seeded demand matrix, so no two rows agree."""
    if pcfg.moe is None:
        return None, None
    rng = np.random.default_rng(9)
    mats = [rng.integers(5, 60, size=(8, 8)).astype(np.float64) * (rng.random((8, 8)) < 0.7)
            for _ in range(pcfg.n_moe_layers)]
    ptable = ScheduleTable.from_schedules([plan_schedule(decompose(m, "maxweight")) for m in mats], envelope="auto")
    jtable = JaxTable.from_schedules([jax_plan(jax_decompose(m, "maxweight")) for m in mats], envelope="auto")
    rows = {tuple(ptable.caps[i].flatten().tolist()) for i in range(ptable.num_layers)}
    assert len(rows) == ptable.num_layers, "the table's rows must differ"
    return ptable, jtable


def _inputs(pcfg, seed):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, pcfg.vocab_size, size=(B, S)).astype(np.int32)
    ext = None
    if pcfg.frontend != "none":
        ext = rng.standard_normal((B, pcfg.frontend_tokens, pcfg.d_model)).astype(np.float32)
    return prompts, ext


def _run_jax(jcfg, params, prompts, ext, table, dtype, fed=None):
    """Prefill and NEW greedy decode steps: (logits of each step, the tokens
    fed to the decode steps [B, NEW]).  ``fed`` feeds those tokens instead
    of the greedy ones."""
    model = JaxModel(jcfg)
    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
    prefix = 0 if ext is None else ext.shape[1]
    caches = model.init_cache(B, prefix + S + NEW, dtype)
    logits, caches = prefill(params, jnp.asarray(prompts), caches, None if ext is None else jnp.asarray(ext),
                             schedule=table)
    out, tokens = [np.asarray(logits, np.float32)], []
    for i in range(NEW):
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32) if fed is None else jnp.asarray(fed[:, i])
        tokens.append(np.asarray(token))
        logits, caches = decode(params, token, caches, jnp.int32(prefix + S + i), schedule=table)
        out.append(np.asarray(logits, np.float32))
    return out, np.stack(tokens, 1)


def _run_port(model, prompts, ext, table, dtype, fed=None):
    prefix = 0 if ext is None else ext.shape[1]
    caches = model.init_cache(B, prefix + S + NEW, dtype)
    logits, caches = model.prefill(torch.from_numpy(prompts), caches, None if ext is None else torch.from_numpy(ext),
                                   schedule=table)
    out, tokens = [logits.float().numpy()], []
    for i in range(NEW):
        token = torch.argmax(logits, dim=-1) if fed is None else torch.from_numpy(fed[:, i]).long()
        tokens.append(token.numpy())
        logits, caches = model.decode_step(token, caches, prefix + S + i, schedule=table)
        out.append(logits.float().numpy())
    return out, np.stack(tokens, 1)


def _compare(monkeypatch, arch, dtype, tol, seed):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jdtype)
    jcfg, pcfg = _cfgs(arch)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=dtype)
    prompts, ext = _inputs(pcfg, seed)
    ptable, jtable = _tables(pcfg)
    jl, jt = _run_jax(jcfg, params, prompts, ext, jtable, jdtype)
    pl, pt = _run_port(model, prompts, ext, ptable, dtype)
    for step, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{arch} step {step}")
    np.testing.assert_array_equal(pt, jt)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_jax(monkeypatch, arch):
    _compare(monkeypatch, arch, torch.float32, 1e-4, 1)


BF16_NOISE_MULT = 2.0
# the port's bf16 logits must lie at least this fraction of the noise floor away from JAX's f32 logits: a port
# that computed in f32 lies ~1e-5 away and fails (seed 2, the five steps: Jamba 0.30-0.99 of the floor, qwen2
# 0.88-1.22)
BF16_GAP_FRACTION = 0.1


@pytest.mark.parametrize("arch", ["qwen2-1.5b", JAMBA])
def test_bf16_prefill_decode_matches_jax(monkeypatch, arch):
    """bf16, prompt seed 2 (as ``test_torch_model.py``).  The noise floor of
    a step is JAX's own bf16 logits against its f32 logits on the same
    tokens.  qwen2 (2 layers): logits within 0.1 and greedy tokens equal.
    Jamba's 16 random-weight layers spread one flipped bf16 rounding (XLA
    keeps some intermediates unrounded where PyTorch rounds) and the MoE
    routing choices it flips past 0.1: both packages are fed the JAX bf16
    run's greedy tokens, and each step's logits must agree within the
    larger of 0.1 and twice the noise floor (the rule ``chip_smoke.py``
    holds the card to).  In both, each step's logits must lie at least
    ``BF16_GAP_FRACTION`` of the floor away from JAX's f32 logits, so a
    port that runs in f32 fails."""
    jcfg, pcfg = _cfgs(arch)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=torch.bfloat16)
    prompts, ext = _inputs(pcfg, 2)
    ptable, jtable = _tables(pcfg)
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.bfloat16)
    jl, fed = _run_jax(jcfg, params, prompts, ext, jtable, jnp.bfloat16)
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    j32, _ = _run_jax(jcfg, params, prompts, ext, jtable, jnp.float32, fed)
    if arch == JAMBA:
        pl, _ = _run_port(model, prompts, ext, ptable, torch.bfloat16, fed)
    else:
        pl, tokens = _run_port(model, prompts, ext, ptable, torch.bfloat16)
        np.testing.assert_array_equal(tokens, fed)
    for step, (a, b, f) in enumerate(zip(pl, jl, j32)):
        floor = float(np.abs(b - f).max())
        err = float(np.abs(a - b).max())
        gap = float(np.abs(a - f).max())
        tol = max(1e-1, BF16_NOISE_MULT * floor) if arch == JAMBA else 1e-1
        print(f"{arch} step {step}: |port - JAX bf16| {err:.4g} (tol {tol:.4g}), noise floor {floor:.4g}, "
              f"|port - JAX f32| {gap:.4g} = {gap / floor:.3g} floors")
        assert np.isfinite(a).all() and err <= tol, (step, err, floor)
        assert gap >= BF16_GAP_FRACTION * floor, (step, gap, floor)


def test_jamba_layer_pattern_and_table_rows():
    """Jamba's period: attention at position 4, Mamba elsewhere, MoE at the
    odd positions; the table's row i goes to the i-th MoE layer, which is
    JAX's [period, MoE position] layout (row p * 4 + m)."""
    pcfg = smoke_config(JAMBA)
    assert [pcfg.layer_kind(l) for l in range(8)] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert (pcfg.period, pcfg.n_layers, pcfg.n_moe_layers) == (8, 16, 8)
    rows = stack.moe_rows(pcfg)
    positions = [j for j in range(8) if pcfg.ffn_kind(j) == "moe"]
    for l, r in enumerate(rows):
        p, j = divmod(l, 8)
        assert r == (p * len(positions) + positions.index(j) if j in positions else None)
    ptable, _ = _tables(pcfg)
    per_layer = stack.schedule_rows(ptable, pcfg)
    assert per_layer[3].caps.equal(ptable.row(1).caps) and per_layer[9].caps.equal(ptable.row(4).caps)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internvl2-26b"])
def test_loss_matches_jax(monkeypatch, arch):
    """Mean next-token loss in f32 within 1e-5: qwen2's tied embeddings
    (the table in f32 for the logits), internvl2's patch prefix (its
    positions carry no loss)."""
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jcfg, pcfg = _cfgs(arch)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=torch.float32)
    prompts, ext = _inputs(pcfg, 3)
    targets = np.roll(prompts, -1, axis=1)
    targets[:, -1] = -1
    jbatch = {"tokens": jnp.asarray(prompts), "targets": jnp.asarray(targets)}
    pbatch = {"tokens": torch.from_numpy(prompts), "targets": torch.from_numpy(targets)}
    if ext is not None:
        jbatch["ext_embeds"], pbatch["ext_embeds"] = jnp.asarray(ext), torch.from_numpy(ext)
    want = float(JaxModel(jcfg).loss(params, jbatch))
    got = float(model.loss(pbatch))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)
    if ext is not None:  # the prefix is masked: the loss equals the tokens' mean over S - 1 targets
        logits = model.forward(pbatch["tokens"], pbatch["ext_embeds"])[:, pcfg.frontend_tokens:]
        ce = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, pcfg.vocab_size),
                                               pbatch["targets"][:, :-1].reshape(-1).long())
        assert abs(float(ce) - got) <= 1e-5 * max(1.0, abs(got))


@pytest.mark.parametrize("arch", [JAMBA, "qwen2-1.5b", "granite-34b"])
def test_transplant_round_trip(arch):
    """``to_reference(load_reference(tree))`` gives the tree back leaf for
    leaf (f32 masters): Jamba's eight period positions, qwen2's tied table
    (no head leaf) and q/k/v biases, granite-34b's GELU w_up / w_down."""
    jcfg, pcfg = _cfgs(arch)
    tree = jax.tree.map(np.array, JaxModel(jcfg).init(jax.random.PRNGKey(4)))
    model = load_reference(pcfg, tree, device="cpu", dtype=torch.bfloat16, param_dtype=torch.float32)
    got = to_reference(model)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    want, back = flat(tree), flat(got)
    assert set(want) == set(back)
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], np.asarray(arr, np.float32), err_msg=str(key))
    if pcfg.tie_embeddings:
        assert "head" not in tree and model.head is None and model.embed.dtype == torch.float32
        assert model.layers[0].mixer.q_bias is not None
    grads = {n: p.detach().clone() for n, p in model.named_parameters()}
    regrouped = flat(to_reference(grads, pcfg))
    assert set(regrouped) == set(want)


def test_transplant_dtypes_of_the_new_modules():
    """Serving storage (bf16): Mamba's a_log / dt_bias / d_skip, the norm
    scales and the router stay f32; projections, conv and biases are bf16."""
    jcfg, pcfg = _cfgs(JAMBA)
    tree = jax.tree.map(np.array, JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    model = load_reference(pcfg, tree, device="cpu", dtype=torch.bfloat16)
    mixer = model.layers[0].mixer
    for name in ("a_log", "dt_bias", "d_skip"):
        assert getattr(mixer, name).dtype == torch.float32, name
    for name in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "out_proj"):
        assert getattr(mixer, name).dtype == torch.bfloat16, name
    assert model.layers[1].ffn.router.dtype == torch.float32 and model.layers[0].ffn.w_gate.dtype == torch.bfloat16
    # layer 13 = period 1, position 5: its leaves come from stack/pos5 at index 1
    np.testing.assert_array_equal(
        model.layers[13].mixer.a_log.numpy(), tree["stack"]["pos5"]["mixer"]["a_log"][1])
    np.testing.assert_array_equal(
        model.layers[12].mixer.q.float().numpy(),
        torch.from_numpy(tree["stack"]["pos4"]["mixer"]["q"]["w"][1]).to(torch.bfloat16).float().numpy())


def test_mamba_block_training_raises():
    """Training through a Mamba block no longer raises (K6b is the scan's
    backward; the name is the test's first, kept): a loss over the smoke
    Jamba's first period backpropagates, and every f32 leaf of its Mamba
    blocks (the mixers' a_log, dt_bias and d_skip among them) receives a
    finite, nonzero gradient.  ``tests/test_torch_mamba_train.py`` holds the
    gradients against JAX's."""
    pcfg = dataclasses.replace(smoke_config(JAMBA), n_layers=8)
    from repro_torch.models import Model

    model = Model(pcfg, device="cpu", dtype=torch.float32, param_dtype=torch.float32, requires_grad=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, pcfg.vocab_size, (2, 12)))
    model.loss({"tokens": tokens, "targets": tokens.roll(-1, 1)}).backward()
    mamba_blocks = [blk for blk in model.layers if blk.kind == "mamba"]
    assert len(mamba_blocks) == 7
    for blk in mamba_blocks:
        for name, prm in blk.named_parameters():
            assert prm.dtype == torch.float32 and prm.grad is not None, name
            assert torch.isfinite(prm.grad).all() and prm.grad.abs().max() > 0, name


@pytest.mark.parametrize("s", [8, 11, 16, 19])
def test_ring_slot_decode_matches_attn_full(monkeypatch, s):
    """h2o-danube's smoke attention (window 8, 8 cache slots): a prefill of
    ``s`` tokens, then one decode step, against JAX's ``attn_full`` over all
    s + 1 tokens in f32 within 1e-5.  Prefill position p sits in slot
    p % 8, so the decode step evicts the oldest position whatever s % 8 is
    (the JAX decode differs by 0.5 at s = 11: its prefill fills slots in
    order)."""
    from repro.models.attention import attn_full as jax_attn_full
    from repro.models.attention import attn_init as jax_attn_init

    from repro_torch.models.attention import attn_decode, attn_init, attn_prefill, init_cache

    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jcfg, pcfg = _cfgs("h2o-danube-3-4b")
    assert pcfg.sliding_window == 8
    params = jax.tree.map(np.array, jax_attn_init(jax.random.PRNGKey(7), jcfg))
    p = attn_init(pcfg, gen=None, device="cpu", dtype=torch.float32)
    for name in ("q", "k", "v", "o"):
        getattr(p, name).data.copy_(torch.from_numpy(params[name]["w"]))
    x = np.random.default_rng(s).standard_normal((2, s + 1, pcfg.d_model)).astype(np.float32)
    cache = init_cache(pcfg, 2, s + 1, dtype=torch.float32, device="cpu")
    assert cache["k"].shape[1] == min(s + 1, 8)
    _, cache = attn_prefill(p, pcfg, torch.from_numpy(x[:, :s]), cache)
    y, cache = attn_decode(p, pcfg, torch.from_numpy(x[:, s:]), cache, s)
    want, _ = jax_attn_full(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(y[:, 0].numpy(), np.asarray(want)[:, -1], rtol=1e-5, atol=1e-5)
    slots = cache["k"].shape[1]
    assert sorted(cache["pos"][0].tolist()) == list(range(s + 1 - slots, s + 1))
    assert all(int(q) % slots == i for i, q in enumerate(cache["pos"][0]))

"""The RWKV6 slice of the port against the JAX package, at smoke size on
the CPU: the WKV6 recurrence (K5's plain version) against the Pallas
kernel in interpret mode and its scan oracle, the time and channel mixes
and the group norm against the JAX functions, the whole serving path
(prefill and greedy decode) with JAX weights transplanted, the
transplant itself, and the serve launcher for an arch without MoE.

Tolerances:

- WKV6: 1e-4 (rtol and atol).  Both sides get the same values (bf16
  r/k/v are rounded once, identically, before either side widens them to
  f32) and compute in f32; only the order of the D-term sums differs.
- Mixes and group norm: 1e-5, with JAX ``COMPUTE_DTYPE`` patched to f32
  (one layer of f32 products over d = 64).
- Whole slice: f32 logits within 1e-4 (as ``test_torch_model.py``: whole
  f32 stacks of the JAX package itself differ by up to 2.3e-4 between
  scan and unroll) with equal greedy tokens; bf16 logits within 0.1 (a
  few bf16 roundings per layer, each up to 2^-9 relative, can land an
  ulp apart between the frameworks) with equal greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.configs import smoke_config as jax_smoke
from repro.kernels.rwkv_wkv import wkv6 as jax_wkv6
from repro.kernels.rwkv_wkv import wkv6_ref
from repro.models import Model as JaxModel
from repro.models import rwkv as jax_rwkv

from repro_torch.configs import smoke_config
from repro_torch.kernels.rwkv_wkv import wkv6
from repro_torch.launch import serve as serve_mod
from repro_torch.models import rwkv
from repro_torch.models.layers import groupnorm
from repro_torch.models.transplant import load_reference, to_reference

ARCH = "rwkv6-7b"
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
MIX_TOL = dict(rtol=1e-5, atol=1e-5)


def _wkv_inputs(b, h, t, d, seed, dtype=np.float32):
    """r/k/v ~ 0.5 N(0, 1) (rounded to bf16 when asked), w in the JAX
    test's 0.45-0.95 range, u ~ 0.1 N(0, 1); numpy f32 arrays."""
    rng = np.random.default_rng(seed)
    rkv = [(rng.standard_normal((b, h, t, d)) * 0.5).astype(np.float32) for _ in range(3)]
    if dtype == "bf16":
        rkv = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in rkv]
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, t, d)))) * 0.5 + 0.45).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.1).astype(np.float32)
    return (*rkv, w, u)


def _port(arrays, bf16=False):
    out = [torch.from_numpy(a) for a in arrays]
    if bf16:  # r/k/v in bf16, as the model hands them over
        out[:3] = [a.to(torch.bfloat16) for a in out[:3]]
    return out


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,h,t,d,bt", [(1, 2, 64, 32, 32), (2, 4, 128, 64, 64), (1, 1, 96, 16, 32)])
def test_wkv6_plain_matches_jax_kernel_and_ref(b, h, t, d, bt, bf16):
    arrays = _wkv_inputs(b, h, t, d, seed=t + d, dtype="bf16" if bf16 else np.float32)
    y, s = wkv6(*_port(arrays, bf16))  # CPU tensors: the plain version
    assert y.dtype == s.dtype == torch.float32 and y.shape == (b, h, t, d) and s.shape == (b, h, d, d)
    jx = [jnp.asarray(a) for a in arrays]
    if bf16:
        jx[:3] = [a.astype(jnp.bfloat16) for a in jx[:3]]
    for name, (jy, js) in (
        ("pallas", jax_wkv6(*jx, block_t=bt, interpret=True)),
        ("ref", wkv6_ref(*jx)),
    ):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), err_msg=name, **WKV_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), err_msg=name, **WKV_TOL)


def test_wkv6_plain_from_a_carried_state_matches_ref():
    b, h, t, d = 2, 3, 40, 16
    arrays = _wkv_inputs(b, h, t, d, seed=7)
    s0 = (np.random.default_rng(8).standard_normal((b, h, d, d)) * 0.3).astype(np.float32)
    y, s = wkv6(*_port(arrays), torch.from_numpy(s0))
    jy, js = wkv6_ref(*(jnp.asarray(a) for a in arrays), s0=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **WKV_TOL)
    y0, _ = wkv6(*_port(arrays))  # a state that is dropped shows in y
    assert np.abs(y.numpy() - y0.numpy()).max() > 1e-2


@pytest.mark.parametrize("split", [1, 37])
def test_wkv6_plain_chains_through_the_state(split):
    """T split in two with S carried equals one pass (decode chains T = 1
    steps the same way)."""
    arrays = _port(_wkv_inputs(1, 2, 64, 16, seed=9))
    y, s = wkv6(*arrays)
    r, k, v, w, u = arrays
    y1, s1 = wkv6(r[:, :, :split], k[:, :, :split], v[:, :, :split], w[:, :, :split], u)
    y2, s2 = wkv6(r[:, :, split:], k[:, :, split:], v[:, :, split:], w[:, :, split:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), y, **WKV_TOL)
    torch.testing.assert_close(s2, s, **WKV_TOL)


# ---------------------------------------------------------------- mixes
def _cfgs():
    return jax_smoke(ARCH), smoke_config(ARCH)


@pytest.fixture
def f32_layer(monkeypatch):
    """JAX smoke rwkv6 parameters (layer 1, f32 compute) and the port's
    layer holding them."""
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jcfg, pcfg = _cfgs()
    params = jax.tree.map(np.array, JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    model = load_reference(pcfg, params, device="cpu", dtype=torch.float32)
    jmix = jax.tree.map(lambda a: jnp.asarray(a[1]), params["stack"]["pos0"]["mixer"])
    return jcfg, pcfg, jmix, model.layers[1].mixer


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_jax(f32_layer, with_state):
    jcfg, pcfg, jmix, mixer = f32_layer
    b, s, d, hd = 2, 12, pcfg.d_model, pcfg.rwkv_head_dim
    x = _x((b, s, d), 1)
    state = None
    if with_state:
        state = (_x((b, d), 2), (_x((b, d // hd, hd, hd), 3) * 0.3).astype(np.float32))
    jy, (jlast, js) = jax_rwkv.rwkv_time_mix(
        jmix, jcfg, jnp.asarray(x), None if state is None else tuple(jnp.asarray(a) for a in state)
    )
    py, (plast, ps) = rwkv.rwkv_time_mix(
        mixer, pcfg, torch.from_numpy(x), None if state is None else tuple(torch.from_numpy(a) for a in state)
    )
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **MIX_TOL)
    np.testing.assert_allclose(plast.numpy(), np.asarray(jlast), **MIX_TOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), **MIX_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(f32_layer, with_state):
    _, pcfg, jmix, mixer = f32_layer
    b, s, d = 2, 12, pcfg.d_model
    x = _x((b, s, d), 4)
    state = _x((b, d), 5) if with_state else None
    jy, jlast = jax_rwkv.rwkv_channel_mix(jmix, jnp.asarray(x), None if state is None else jnp.asarray(state))
    py, plast = rwkv.rwkv_channel_mix(mixer, torch.from_numpy(x), None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **MIX_TOL)
    np.testing.assert_allclose(plast.numpy(), np.asarray(jlast), **MIX_TOL)


def test_groupnorm_matches_jax():
    x = _x((3, 5, 64), 6) * 3.0 + 1.0
    scale, bias = _x((64,), 7), _x((64,), 8)
    want = jax_layers.groupnorm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x), groups=4)
    got = groupnorm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), groups=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX_TOL)


# ---------------------------------------------------------- whole slice
B, S, NEW = 2, 16, 4


def _run_jax(jcfg, params, prompts, cache_dtype):
    model = JaxModel(jcfg)
    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
    caches = model.init_cache(B, S + NEW, cache_dtype)
    logits, caches = prefill(params, jnp.asarray(prompts), caches)
    out_logits, tokens = [np.asarray(logits)], []
    token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for i in range(NEW):
        logits, caches = decode(params, token, caches, jnp.int32(S + i))
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out_logits.append(np.asarray(logits))
        tokens.append(np.asarray(token))
    return out_logits, np.stack(tokens, 1)


def _run_port(model, prompts, cache_dtype):
    caches = model.init_cache(B, S + NEW, cache_dtype)
    logits, caches, stats = model.prefill(torch.from_numpy(prompts), caches, collect_stats=True)
    assert stats is None  # no MoE layer
    out_logits, tokens = [logits.numpy()], []
    token = torch.argmax(logits, dim=-1)
    for i in range(NEW):
        logits, caches, stats = model.decode_step(token, caches, S + i, collect_stats=True)
        assert stats is None
        token = torch.argmax(logits, dim=-1)
        out_logits.append(logits.numpy())
        tokens.append(token.numpy())
    assert caches[0]["s"].dtype == torch.float32 and caches[0]["x_tm"].dtype == cache_dtype
    return out_logits, np.stack(tokens, 1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-1)])
def test_prefill_decode_matches_jax(monkeypatch, dtype, tol):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jdtype)
    jcfg, pcfg = _cfgs()
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=dtype)
    prompts = np.random.default_rng(1).integers(0, pcfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jt = _run_jax(jcfg, params, prompts, jdtype)
    pl, pt = _run_port(model, prompts, dtype)
    for step, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol, atol=tol, err_msg=f"step {step}")
    np.testing.assert_array_equal(pt, jt)


def test_decode_carries_the_wkv_state():
    """Decode resumes the recurrence from the cached state: a step whose
    state is reset to zero gives other logits."""
    model = load_reference(*_params(), device="cpu", dtype=torch.float32)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(B, S)))
    caches = model.init_cache(B, S + 1, torch.float32)
    logits, caches = model.prefill(prompts, caches)
    token = torch.argmax(logits, dim=-1)
    zeroed = [dict(c, s=torch.zeros_like(c["s"])) for c in caches]
    carried, _ = model.decode_step(token, caches, S)
    restarted, _ = model.decode_step(token, zeroed, S)
    assert (carried - restarted).abs().max().item() > 1e-3


# ----------------------------------------------------------- transplant
def _params():
    jcfg, pcfg = _cfgs()
    return pcfg, jax.tree.map(np.array, JaxModel(jcfg).init(jax.random.PRNGKey(0)))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_transplant_round_trip():
    pcfg, params = _params()
    back = to_reference(load_reference(pcfg, params, device="cpu", dtype=torch.float32))
    want, got = _leaves(params), _leaves(back)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_transplant_rejects_leftover_and_mismatch():
    pcfg, params = _params()
    params["extra"] = {"w": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        load_reference(pcfg, params, device="cpu")
    del params["extra"]
    params["stack"]["pos0"]["mixer"]["u"] = params["stack"]["pos0"]["mixer"]["u"][:, :, :8]
    with pytest.raises(ValueError, match="mixer/u"):
        load_reference(pcfg, params, device="cpu")


def test_transplant_dtypes():
    pcfg, params = _params()
    model = load_reference(pcfg, params, device="cpu", dtype=torch.bfloat16)
    for layer in model.layers:
        for name, prm in layer.named_parameters():
            want = torch.bfloat16 if name.removeprefix("mixer.") in rwkv.DENSE else torch.float32
            assert prm.dtype == want, name
    assert model.embed.dtype == model.head.dtype == torch.bfloat16 and model.ln_f.dtype == torch.float32
    np.testing.assert_array_equal(
        model.layers[1].mixer.cm_k.float().numpy(),
        torch.from_numpy(params["stack"]["pos0"]["mixer"]["cm_k"]["w"][1]).to(torch.bfloat16).float().numpy(),
    )
    np.testing.assert_array_equal(model.layers[1].mixer.mix_w1.numpy(), params["stack"]["pos0"]["mixer"]["mix_w1"][1])


# -------------------------------------------------------------- launcher
def test_serve_rwkv_plans_no_table_and_counts_no_moe():
    res = serve_mod.main(
        ["--arch", ARCH, "--smoke", "--controller", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "3", "--rounds", "2"]
    )
    assert res.table is None
    assert res.admitted == res.dropped == res.routed == 0.0
    assert res.tokens.shape == (2, 2, 3)
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < smoke_config(ARCH).vocab_size
    assert torch.isfinite(res.first_logits).all()


def test_serve_rwkv_raises_without_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--arch", ARCH, "--smoke", "--batch", "1", "--prompt-len", "4", "--new-tokens", "1"])


def test_rwkv_training_is_not_ported_yet():
    model = load_reference(*_params(), device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="rwkv6"):
        model(torch.zeros((1, 4), dtype=torch.long))

"""The Mamba mixer (``repro_torch.models.mamba``) and the selective scan
K6's plain version (``kernels.mamba_scan.selective_scan_plain``, what the
wrapper runs on a CPU tensor) against the JAX package's
``repro.models.mamba`` at Jamba's smoke widths (d 64, d_inner 128,
d_state 16, conv 4, dt_rank 4), in f32 within 1e-5: the scan against
``_scan_ssm`` with a carried state, a prefill followed by 4 decode steps
(output, SSM state and conv tail after each), and a prefill from a
carried state.  JAX weights are copied into the port's module; a_log,
dt_bias and d_skip are perturbed from their init so every term counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.configs import smoke_config as jax_smoke
from repro.models import mamba as jm

from repro_torch.configs import smoke_config
from repro_torch.kernels.mamba_scan import ops as k6
from repro_torch.models import mamba as pm

ARCH = "jamba-1.5-large-398b"
TOL = 1e-5


@pytest.fixture
def pair(monkeypatch):
    """(JAX params, JAX cfg, port module, port cfg) in f32."""
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jcfg, pcfg = jax_smoke(ARCH), smoke_config(ARCH)
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
    return params, jcfg, p, pcfg


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


def test_dims_match_jax():
    assert pm.mamba_dims(smoke_config(ARCH)) == jm._dims(jax_smoke(ARCH)) == (128, 16, 4, 4)


def test_plain_scan_matches_scan_ssm(pair):
    """The plain scan, fed ``_ssm_params``' dt/B/C, against ``_scan_ssm``
    from a carried state; ``h_out`` receives the final state in place."""
    params, jcfg, p, pcfg = pair
    rng = np.random.default_rng(0)
    xc = rng.standard_normal((2, 13, 128)).astype(np.float32)
    h0 = rng.standard_normal((2, 128, 16)).astype(np.float32)
    jy, jh = jm._scan_ssm(params, jcfg, jnp.asarray(xc), jnp.asarray(h0))
    dt, b, c = pm._ssm_params(p, pcfg, torch.from_numpy(xc))
    h_out = torch.from_numpy(h0.copy())
    y, h = k6.selective_scan(torch.from_numpy(xc), dt, b, c, -torch.exp(p.a_log), p.d_skip, h_out, h_out)
    assert h is h_out
    _close(y, jy, "y")
    _close(h, jh, "h")


def test_prefill_then_four_steps_match_jax(pair):
    params, jcfg, p, pcfg = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    jy, (jh, jtail) = jm.mamba_seq(params, jcfg, jnp.asarray(x))
    state = pm.mamba_init_state(pcfg, 2, dtype=torch.float32, device="cpu")
    y, (h, tail) = pm.mamba_seq(p, pcfg, torch.from_numpy(x), h_out=state["h"])
    assert h is state["h"]
    state["tail"].copy_(tail)
    _close(y, jy, "prefill y")
    _close(state["h"], jh, "prefill h")
    _close(state["tail"], jtail, "prefill conv tail")
    jstate = (jh, jtail)
    for i in range(4):
        xs = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jy, jstate = jm.mamba_step(params, jcfg, jnp.asarray(xs), jstate)
        h_ptr = state["h"].data_ptr()
        y, state = pm.mamba_step(p, pcfg, torch.from_numpy(xs), state)
        assert state["h"].data_ptr() == h_ptr, "the step writes the cache's own state"
        _close(y, jy, f"step {i} y")
        _close(state["h"], jstate[0], f"step {i} h")
        _close(state["tail"], jstate[1], f"step {i} conv tail")


def test_prefill_from_a_carried_state_matches_jax(pair):
    params, jcfg, p, pcfg = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    h0 = 0.5 * rng.standard_normal((2, 128, 16)).astype(np.float32)
    jy, (jh, jtail) = jm.mamba_seq(params, jcfg, jnp.asarray(x), jnp.asarray(h0))
    y, (h, tail) = pm.mamba_seq(p, pcfg, torch.from_numpy(x), torch.from_numpy(h0))
    _close(y, jy, "y")
    _close(h, jh, "h")
    _close(tail, jtail, "conv tail")


def test_short_prompt_conv_tail_is_zero_padded(pair):
    """A prompt shorter than conv_width - 1 leaves zeros before its first
    token in the tail, so the next steps see what a longer run of zeros would."""
    _, _, p, pcfg = pair
    x = torch.randn((1, 2, 64), generator=torch.Generator().manual_seed(0))
    _, (_, tail) = pm.mamba_seq(p, pcfg, x)
    assert tail.shape == (1, 3, 128) and tail[:, 0].abs().max() == 0
    _, (_, full_tail) = pm.mamba_seq(p, pcfg, torch.cat([torch.zeros(1, 3, 64), x], 1))
    torch.testing.assert_close(tail[:, 1:], full_tail[:, 1:])


def test_kernel_wrapper_refuses_other_devices():
    x = torch.zeros((1, 1, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k6.selective_scan(x, x.float(), x.float(), x.float(), torch.zeros((4, 2), device="meta"),
                          torch.zeros(4, device="meta"))

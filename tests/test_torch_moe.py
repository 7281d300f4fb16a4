"""MoE layer parity: the port's ``moe_apply`` with a schedule row against
``repro.models.moe.moe_apply`` (``use_pallas=True``, the grouped kernel
in interpret mode) on identical weights and inputs: output and stats.

f32 run (JAX ``COMPUTE_DTYPE`` patched to f32): 1e-5, both sides sum
the same f32 products in another order.  bf16 run: 2e-2, as the JAX
kernel tests, since one bf16 rounding of h may differ by an ulp.
Stats are integer counts and must be equal.
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
from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_init as jax_moe_init

from repro_torch.configs import smoke_config
from repro_torch.core import ScheduleTable, decompose, plan_schedule
from repro_torch.models.moe import moe_apply, moe_init


def _cfgs():
    jcfg = jax_smoke("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch="phase_pipelined", use_pallas=True))
    pcfg = smoke_config("mixtral-8x7b")
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="phase_pipelined"))
    return jcfg, pcfg


def _tables(seed: int):
    """A tight plan (small caps, dark pairs) so admission clips choices."""
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 6, size=(8, 8)).astype(np.float64) * (rng.random((8, 8)) < 0.7)
    port = ScheduleTable.from_schedules([plan_schedule(decompose(m, "maxweight", min_fill=0.1))], envelope="auto")
    ref = JaxTable.from_schedules([jax_plan(jax_decompose(m, "maxweight", min_fill=0.1))], envelope="auto")
    return port.row(0), ref.row(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("use_table", [True, False])
def test_moe_apply_matches_jax(monkeypatch, dtype, tol, use_table):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jdtype)
    jcfg, pcfg = _cfgs()
    params = jax.tree.map(np.array, jax_moe_init(jax.random.PRNGKey(1), jcfg))
    p = moe_init(pcfg, gen=None, device="cpu", dtype=dtype)
    p.router.data.copy_(torch.from_numpy(params["router"]["w"]))
    for name in ("w_gate", "w_up", "w_down"):
        getattr(p, name).data.copy_(torch.from_numpy(params[name]).to(dtype))
    x = np.random.default_rng(2).standard_normal((2, 32, pcfg.d_model)).astype(np.float32)
    prow, jrow = _tables(3) if use_table else (None, None)

    y, st = moe_apply(p, pcfg, torch.from_numpy(x).to(dtype), schedule=prow, return_stats=True)
    jy, jst = jax_moe_apply(params, jcfg, jnp.asarray(x).astype(jdtype), schedule=jrow, return_stats=True)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), rtol=tol, atol=tol)
    np.testing.assert_array_equal(st["routing"].numpy(), np.asarray(jst["routing"]))
    np.testing.assert_array_equal(st["dropped"].numpy(), np.asarray(jst["dropped"]))
    if use_table:
        assert float(st["admitted"]) < 2 * 64, "the tight plan must clip some choices"

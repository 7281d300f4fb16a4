"""The backward of the grouped expert GEMM (K2 dgrad, K3 wgrad), the
ungrouped forward (K3b) and the rmsnorm backward: the port's plain
versions and autograd Functions against the JAX Pallas kernels in
interpret mode and against ``jax.vjp``.  The CUDA kernels are held
against the same plain versions in ``test_torch_kernels_cuda.py``.

Tolerances: 2e-5 in f32 for the kernels (both sides accumulate in f32,
in another order), 1e-4 for whole VJPs in f32 (as the JAX package's own
oracle tests), and 2e-2 in bf16: the port rounds ``da`` and ``du`` to
bf16 before the products (the tensor cores take bf16) where the TPU
kernel keeps them in f32, one more rounding of up to 2^-9 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm
from repro.kernels.moe_gemm.kernel import moe_gemm_grouped_pallas_dgrad, moe_gemm_grouped_pallas_wgrad
from repro.kernels.moe_gemm.ops import row_block_meta
from repro.models.layers import _rmsnorm as jax_rmsnorm

from repro_torch.kernels.moe_gemm import (
    ROW_TILE,
    moe_gemm,
    moe_gemm_dgrad,
    moe_gemm_ungrouped,
    moe_gemm_wgrad,
    tile_occupancy,
)
from repro_torch.models.layers import rmsnorm

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SHAPES = [
    # full / full+partial / dark / partial+dark tiles at the port's 64-row tile; expert 2 all dark
    (4, 128, 64, 128, [128, 70, 0, 8]),
    # C smaller than the row tile: one 8-row tile per expert, some live, some dark
    (8, 8, 64, 128, [1, 0, 3, 0, 8, 2, 0, 1]),
]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)


def _inputs(e, c, d, f, counts, seed, dtype):
    """(go, x, wg, wu, wd) as port tensors and JAX arrays, and row_valid."""
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal((e, c, d)) * 0.5).astype(np.float32) for _ in range(2)]
    arrs += [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((e, d, f), (e, d, f), (e, f, d))]
    rv = np.zeros((e, c), bool)
    for i, ct in enumerate(counts):
        rv[i, :ct] = True
    return [torch.from_numpy(a).to(dtype) for a in arrs], [jnp.asarray(a).astype(JNP[dtype]) for a in arrs], rv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f,counts", SHAPES)
def test_k2_k3_plain_match_jax_kernels(e, c, d, f, counts, dtype):
    (go, x, wg, wu, wd), (jgo, jx, jwg, jwu, jwd), rv = _inputs(e, c, d, f, counts, 0, dtype)
    bc = min(ROW_TILE, c)
    meta = row_block_meta(jnp.asarray(rv), bc).astype(jnp.int32)
    kw = dict(block_c=bc, block_f=64, interpret=True)
    ref_dx = moe_gemm_grouped_pallas_dgrad(jgo, jx, meta, jwg, jwu, jwd, **kw)
    ref_w = moe_gemm_grouped_pallas_wgrad(jgo, jx, meta, jwg, jwu, jwd, **kw)
    trv = torch.from_numpy(rv)
    dx = moe_gemm_dgrad(go, x, wg, wu, wd, trv)  # CPU tensors: the plain versions
    grads = moe_gemm_wgrad(go, x, wg, wu, wd, trv)
    assert dx.dtype == dtype and all(g.dtype == dtype for g in grads)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(ref_dx, np.float32), **_tol(dtype))
    for got, want in zip(grads, ref_w):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype))
    dark = ~tile_occupancy(trv).numpy()
    assert dark.any() and np.abs(dx.float().numpy()[dark]).max() == 0.0  # exact zeros
    dark_experts = ~rv.any(axis=1)
    assert dark_experts.any()
    for g in grads:
        assert np.abs(g.float().numpy()[dark_experts]).max() == 0.0


def _leaves(tensors):
    return [t.clone().requires_grad_() for t in tensors]


@pytest.mark.parametrize("e,c,d,f,counts", SHAPES)
def test_moe_gemm_autograd_matches_jax_vjp(e, c, d, f, counts):
    (go, *prim), (jgo, *jprim), rv = _inputs(e, c, d, f, counts, 1, torch.float32)
    leaves = _leaves(prim)
    out = moe_gemm(*leaves, torch.from_numpy(rv))
    out.backward(go)
    bc = min(ROW_TILE, c)
    ref, vjp = jax.vjp(lambda *a: jax_moe_gemm(*a, row_valid=jnp.asarray(rv), block_c=bc, block_f=64), *jprim)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    for leaf, want in zip(leaves, vjp(jgo)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3b_ungrouped_forward_and_backward_match_jax(dtype):
    (go, *prim), (jgo, *jprim), _ = _inputs(2, 128, 64, 128, [], 2, dtype)
    leaves = _leaves(prim)
    out = moe_gemm_ungrouped(*leaves)
    out.backward(go)
    # row_valid=None: moe_gemm_pallas forward, Pallas backward at full occupancy
    ref, vjp = jax.vjp(lambda *a: jax_moe_gemm(*a, block_c=ROW_TILE, block_f=64), *jprim)
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32), **_tol(dtype))
    for leaf, want in zip(leaves, vjp(jgo)):
        assert leaf.grad.dtype == dtype
        np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x_np = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale_np = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g_np = rng.standard_normal((2, 5, 64)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dtype).requires_grad_()
    scale = torch.from_numpy(scale_np).requires_grad_()
    y = rmsnorm(x, scale, eps=1e-5)
    y.backward(torch.from_numpy(g_np).to(dtype))
    jx = jnp.asarray(x_np).astype(JNP[dtype])
    ref, vjp = jax.vjp(lambda a, s: jax_rmsnorm(a, s, 1e-5), jx, jnp.asarray(scale_np))
    jdx, jds = vjp(jnp.asarray(g_np).astype(JNP[dtype]))
    assert y.dtype == dtype and x.grad.dtype == dtype and scale.grad.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(ref, np.float32), **tol)
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(jdx, np.float32), **tol)
    np.testing.assert_allclose(scale.grad.numpy(), np.asarray(jds), rtol=1e-5, atol=1e-5)

"""Kernels K1 (grouped SwiGLU) and K4 (flash attention): the port's plain
versions against the JAX Pallas kernels in interpret mode.  The CUDA
kernels are held against the plain versions in
``test_torch_kernels_cuda.py`` (card only).

Tolerances follow ``tests/test_kernels.py``: 2e-5 in f32 (both sides
accumulate in f32, in another order) and 2e-2 in bf16 (one bf16 rounding
of h or p can differ by an ulp and carry into the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.moe_gemm import ROW_TILE, moe_gemm, moe_gemm_plain, tile_occupancy

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)


def _k1_inputs(e, c, d, f, counts, seed, dtype):
    """``counts[i]``: expert i's live rows, ``n`` for rows [0, n) or a list
    of ``(lo, hi)`` row ranges."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((e, c, d)) * 0.5).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((e, d, f), (e, d, f), (e, f, d))]
    rv = np.zeros((e, c), bool)
    for i, ct in enumerate(counts):
        for lo, hi in ct if isinstance(ct, list) else [(0, ct)]:
            rv[i, lo:hi] = True
    port = [torch.from_numpy(a).to(dtype) for a in (x, *ws)]
    ref = [jnp.asarray(a).astype(JNP[dtype]) for a in (x, *ws)]
    return port, ref, rv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "e,c,d,f,counts",
    [
        # full / full+partial / dark / partial+dark tiles at the port's 64-row tile
        (4, 128, 64, 128, [128, 70, 0, 8]),
        # decode-like: one 8-row tile per expert, some live, some dark
        (8, 8, 64, 128, [1, 0, 3, 0, 8, 2, 0, 1]),
        # not a prefix: live rows only in the second 64-row tile of each 128 rows, so
        # the first 64-row half of every 128-row block is dark and the second live
        (3, 256, 64, 128, [[(64, 128), (192, 256)], [(70, 71), (200, 230)], [(127, 128)]]),
    ],
)
def test_k1_plain_matches_jax_kernel(e, c, d, f, counts, dtype):
    (x, wg, wu, wd), (jx, jwg, jwu, jwd), rv = _k1_inputs(e, c, d, f, counts, 0, dtype)
    out = moe_gemm(x, wg, wu, wd, torch.from_numpy(rv))  # CPU tensor: the plain version
    # the JAX grouped kernel at the port's row tile (C itself when smaller)
    ref = jax_moe_gemm(jx, jwg, jwu, jwd, row_valid=jnp.asarray(rv), block_c=min(ROW_TILE, c), block_f=64)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **_tol(dtype))
    dark = ~tile_occupancy(torch.from_numpy(rv)).numpy()
    assert dark.any() and float(out.float().numpy()[dark].__abs__().max()) == 0.0  # exact zeros


def test_k1_plain_ragged_rows():
    """C not a multiple of the tile: live rows match the JAX kernel, the
    port's dark tiles are exact zeros."""
    (x, wg, wu, wd), (jx, jwg, jwu, jwd), rv = _k1_inputs(2, 72, 64, 64, [70, 3], 1, torch.float32)
    out = moe_gemm_plain(x, wg, wu, wd, torch.from_numpy(rv)).numpy()
    ref = np.asarray(jax_moe_gemm(jx, jwg, jwu, jwd, row_valid=jnp.asarray(rv), block_c=8, block_f=64))
    np.testing.assert_allclose(out[rv], ref[rv], **_tol(torch.float32))
    assert np.abs(out[1, 64:]).max() == 0.0


def _k4_inputs(b, h, kh, sq, skv, d, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d))]
    return [torch.from_numpy(a).to(dtype) for a in arrs], [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,kh,sq,skv,d,window,blk",
    [
        (2, 4, 4, 64, 64, 16, None, 16),  # causal, 4 KV blocks of online softmax
        (1, 4, 1, 64, 64, 16, 8, 16),  # sliding window + MQA
        (2, 8, 2, 32, 32, 32, None, 32),  # GQA G=4, one block
        (1, 4, 2, 16, 48, 16, None, 16),  # q_offset = Skv - Sq > 0
    ],
)
def test_k4_plain_matches_jax_kernel(b, h, kh, sq, skv, d, window, blk, dtype):
    (q, k, v), (jq, jk, jv) = _k4_inputs(b, h, kh, sq, skv, d, 3, dtype)
    out = flash_attention(q, k, v, causal=True, window=window)  # CPU tensor: the plain version
    ref = jax_flash(jq, jk, jv, causal=True, window=window, block_q=blk, block_k=blk, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **_tol(dtype))


def test_k4_fully_masked_row_is_uniform():
    """NEG = -1e30, not -inf: a row that sees no key averages all of them."""
    (q, k, v), _ = _k4_inputs(1, 1, 1, 4, 4, 16, 0, torch.float32)
    out = flash_attention_plain(q, k, v, causal=True, window=0)  # window 0 masks every key
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 0], v[0, 0].mean(0, keepdim=True).expand(4, 16))

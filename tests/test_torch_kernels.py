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

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain, kernel_readable
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prescale", [None, 16**0.5])
def test_k4_plain_on_strided_views_matches_jax_kernel(dtype, prescale):
    """K4 as the model calls it: [B, S, H, D] storage handed over as
    [B, H, S, D] views (GQA G=4), and with ``prescale`` the model's
    pre-scaled q, undone in q's dtype before the wrapper's own scaling
    (JAX's attn_flash: ``q * D**0.5``, then the flash wrapper)."""
    (q, k, v), _ = _k4_inputs(2, 8, 2, 32, 32, 16, 5, dtype)
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not qv.is_contiguous() and torch.equal(qv, q)
    if prescale is None:
        out = flash_attention(qv, kv, vv, causal=True)
        jq = jnp.asarray(q.float().numpy()).astype(JNP[dtype])
    else:
        qv = qv * 16**-0.5  # the model's pre-scaled q, as _qkv returns it
        out = flash_attention(qv, kv, vv, causal=True, prescale=prescale)
        jq = jnp.asarray(qv.float().numpy()).astype(JNP[dtype]) * prescale
    jk, jv = (jnp.asarray(t.float().numpy()).astype(JNP[dtype]) for t in (k, v))
    ref = jax_flash(jq, jk, jv, causal=True, block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **_tol(dtype))


def test_k4_kernel_reads_the_models_views_in_place():
    """The rule for which views the K4 kernel reads in place with 16-byte
    loads (anything else raises on the card; nothing is copied): unit
    innermost stride, other strides multiples of 16 bytes, a 16-byte-aligned
    start."""
    qkv = torch.zeros((2, 7, 4, 64), dtype=torch.bfloat16)  # [B, S, H, D] storage, as the model projects it
    assert kernel_readable(qkv.transpose(1, 2))  # the [B, H, S, D] view attn_flash hands over
    assert kernel_readable(torch.zeros((2, 4, 7, 32), dtype=torch.bfloat16)[..., :16])  # a head-dim slice
    assert kernel_readable(torch.zeros((1, 1, 1, 16), dtype=torch.bfloat16).expand(2, 3, 5, 16))  # stride 0
    flat = torch.zeros(2 * 4 * 7 * 64 + 1, dtype=torch.bfloat16)
    assert not kernel_readable(flat[1:].view(2, 4, 7, 64))  # 2 bytes past an aligned start
    assert not kernel_readable(qkv.transpose(1, 2).transpose(-1, -2))  # D not innermost
    assert not kernel_readable(torch.zeros((1, 2, 3, 12), dtype=torch.bfloat16))  # 24-byte rows


def test_k4_output_takes_the_layout_of_q():
    """``torch.empty_like`` of the transposed view keeps its permuted dense
    layout, so the output's [B, S, H, D] transpose needs no copy."""
    view = torch.zeros((2, 7, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    out = torch.empty_like(view)
    assert out.stride() == view.stride() and out.transpose(1, 2).is_contiguous()

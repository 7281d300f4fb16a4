"""The CUDA kernels K1, K2/K3 (its backward), K3b (ungrouped), K4 and K5
(the WKV6 recurrence) against their plain PyTorch versions on the card,
at small and ragged shapes.  Skips without a CUDA device.  Run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance 2e-2 (bf16): kernel and plain version both accumulate in f32,
in another order, so a bf16 rounding of h, p or the output can differ by
an ulp.  The weight gradients (K3) are held by relative L2 (2e-3) and a
max error of 2e-2 * max|plain|: kernel and plain version each round
their own f32 da/du/h to bf16, a few tenths of a percent of those land
one ulp apart, and one such element times a large x moves a single
weight gradient by more than the elementwise bound.  K5 computes in f32
on both sides (bf16 r/k/v are widened first): 1e-4, for the order of
the 64-term sums.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import attention_mask, flash_attention, flash_attention_plain, kernel_readable
from repro_torch.kernels.flash_attention.ops import _launch as k4_launch
from repro_torch.kernels.rwkv_wkv import wkv6, wkv6_plain
from repro_torch.kernels.moe_gemm import ops as moe_gemm_ops
from repro_torch.kernels.moe_gemm import (
    moe_gemm,
    moe_gemm_bwd,
    moe_gemm_dgrad,
    moe_gemm_dgrad_plain,
    moe_gemm_plain,
    moe_gemm_ungrouped,
    moe_gemm_wgrad,
    moe_gemm_wgrad_plain,
    tile_occupancy,
)

TOL = dict(rtol=2e-2, atol=2e-2)


def _close_l2(got, want, rel=2e-3, max_rel=2e-2):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= rel
    assert (got - want).abs().max().item() <= max_rel * want.abs().max().item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def _randn(rng, shape, scale, device):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "e,c,d,f,counts",
    [
        (4, 130, 128, 256, [130, 70, 0, 5]),  # full, partial, dark tiles and a ragged 2-row tail tile
        (8, 8, 128, 256, [1, 0, 3, 0, 8, 2, 0, 1]),  # decode-like: C smaller than the row tile
        # live rows only in [64, 128): the first 64-row half of a 128-row block dark, the second live
        (3, 192, 128, 192, [(64, 128), (70, 100), (0, 0)]),
        # prefill-like: several K stages and n-tiles, a 256-wide down tile over d; full, partial and
        # dark tiles and an all-dark expert
        (4, 320, 512, 1024, [320, 200, 5, 0]),
        (2, 1, 128, 256, [1, 0]),  # C = 1
    ],
)
def test_k1_kernel_matches_plain_on_card(cuda_device, e, c, d, f, counts):
    rng = np.random.default_rng(2)
    x = _randn(rng, (e, c, d), 0.5, cuda_device)
    wg, wu = (_randn(rng, (e, d, f), 0.05, cuda_device) for _ in range(2))
    wd = _randn(rng, (e, f, d), 0.05, cuda_device)
    rv = torch.zeros((e, c), dtype=torch.bool, device=cuda_device)
    for i, ct in enumerate(counts):
        lo, hi = ct if isinstance(ct, tuple) else (0, ct)
        rv[i, lo:hi] = True
    before = moe_gemm.launches
    out = moe_gemm(x, wg, wu, wd, rv)
    torch.cuda.synchronize()
    assert moe_gemm.launches == before + 1
    torch.testing.assert_close(out.float(), moe_gemm_plain(x, wg, wu, wd, rv).float(), **TOL)
    dark = ~tile_occupancy(rv)
    assert out[dark].abs().max().item() == 0.0


def _k2k3_inputs(e, c, counts, device, d=128, f=256):
    """Unit-scale activations and 1/sqrt(fan-in) weights: outputs of order 1.
    ``counts[i]``: expert i's live rows, ``n`` for rows [0, n) or a list of
    ``(lo, hi)`` row ranges."""
    rng = np.random.default_rng(3)
    x, go = _randn(rng, (e, c, d), 1.0, device), _randn(rng, (e, c, d), 1.0, device)
    wg, wu = (_randn(rng, (e, d, f), d**-0.5, device) for _ in range(2))
    wd = _randn(rng, (e, f, d), f**-0.5, device)
    rv = torch.zeros((e, c), dtype=torch.bool, device=device)
    for i, ct in enumerate(counts):
        for lo, hi in ct if isinstance(ct, list) else [(0, ct)]:
            rv[i, lo:hi] = True
    return go, x, wg, wu, wd, rv


@pytest.mark.cuda
@pytest.mark.parametrize(
    "e,c,counts",
    [
        (4, 130, [130, 70, 0, 5]),  # full, partial, dark tiles, a ragged tail tile, an all-dark expert
        (8, 8, [1, 0, 3, 0, 8, 2, 0, 1]),  # C smaller than the row tile
        (3, 200, [0, 200, 64]),  # an all-dark expert first; a live tile after a dark one
    ],
)
def test_k2_k3_kernels_match_plain_on_card(cuda_device, e, c, counts):
    _check_k2_k3(*_k2k3_inputs(e, c, counts, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "e,c,d,f,counts",
    [
        # live rows only in the second 64-row half of a 128-row block; a dark expert; C = 192, not a
        # multiple of the recompute's 128-row block
        (3, 192, 128, 256, [[(64, 128)], 0, 150]),
        # C = 300 (ragged tail tile); one live row in the second half of the first block; a dark expert
        (3, 300, 128, 256, [[(128, 300)], [(70, 71)], 0]),
        # d = 192: the wgrad's second 64-row half of d and the down tile's fourth box lie past d;
        # F = 320: the last 128-column F tile is half outside; several contraction stages
        (3, 260, 192, 320, [260, 0, [(100, 200)]]),
        # dark tiles between live ones: wgrad walks tiles 0, 3 and 5 of expert 0 and 1, 4 of expert 2;
        # expert 1 has no live tile at all
        (3, 384, 128, 256, [[(0, 10), (200, 250), (330, 384)], 0, [(64, 65), (300, 301)]]),
    ],
)
def test_k2_k3_kernels_match_plain_on_card_at_block_edges(cuda_device, e, c, d, f, counts):
    _check_k2_k3(*_k2k3_inputs(e, c, counts, cuda_device, d=d, f=f))


def _check_k2_k3(go, x, wg, wu, wd, rv):
    n2, n3 = moe_gemm_dgrad.launches, moe_gemm_wgrad.launches
    dx = moe_gemm_dgrad(go, x, wg, wu, wd, rv)
    grads = moe_gemm_wgrad(go, x, wg, wu, wd, rv)
    torch.cuda.synchronize()
    assert (moe_gemm_dgrad.launches, moe_gemm_wgrad.launches) == (n2 + 1, n3 + 1)
    torch.testing.assert_close(dx.float(), moe_gemm_dgrad_plain(go, x, wg, wu, wd, rv).float(), **TOL)
    for got, want in zip(grads, moe_gemm_wgrad_plain(go, x, wg, wu, wd, rv)):
        assert got.dtype == torch.bfloat16
        _close_l2(got, want)
    occ = tile_occupancy(rv)
    assert dx[~occ].abs().max().item() == 0.0  # dark tiles: exact zeros
    dark_experts = ~occ.any(dim=1)
    for g in grads:
        assert g[dark_experts].abs().max().item() == 0.0
    fused = moe_gemm_bwd(go, x, wg, wu, wd, rv)  # the autograd backward's shared-recompute form
    for a, b in zip(fused, (dx, *grads)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "e,c,counts",
    [
        # C = 130: block 0 of expert 0 has a dark first half beside a live second half, block 1 two
        # live rows of a ragged tail; expert 1 all dark
        (3, 130, [[(64, 130)], 0, 130]),
        # C = 300: a live first half beside a dark second half, then dark blocks; an all-dark expert
        (3, 300, [300, [(0, 10)], 0]),
    ],
)
def test_k2_dgrad_tile_edges_on_card(cuda_device, e, c, counts):
    """The dgrad's 128-row x 256-column tile: d = 192 puts a quarter of it past d (TMA zero-fill,
    clipped stores); F = 320 is five contraction stages of each of (da, wg) and (du, wu)."""
    _check_k2_k3(*_k2k3_inputs(e, c, counts, cuda_device, d=192, f=320))


@pytest.mark.cuda
@pytest.mark.parametrize("c,counts", [(130, [[(64, 130)], 0, 100]), (300, [[(0, 10), (200, 210)], 0, 300])])
def test_k2_dgrad_never_reads_dark_scratch_on_card(cuda_device, c, counts):
    """The recompute leaves da/du unwritten on dark tiles, so that scratch may hold any bits: filled
    with NaN there, dgrad still equals its plain version, finite, with exact zeros on dark tiles."""
    go, x, wg, wu, wd, rv = _k2k3_inputs(3, c, counts, cuda_device, d=192, f=320)
    rvb, (da, du, _) = moe_gemm_ops._launch_silu_grads(go, x, wg, wu, wd, rv)
    dark = ~tile_occupancy(rv)
    assert dark.any()
    for t in (da, du):
        t[dark] = float("nan")
    dx = moe_gemm_ops._launch_dgrad(x, wg, wu, rvb, da, du)
    torch.cuda.synchronize()
    assert torch.isfinite(dx).all()
    assert dx[dark].abs().max().item() == 0.0
    want = moe_gemm_ops._dgrad_from(da, du, wg, wu, rv, torch.bfloat16)  # bmm keeps a NaN row in its row
    torch.testing.assert_close(dx.float(), want.float(), **TOL)
    torch.testing.assert_close(dx.float(), moe_gemm_dgrad_plain(go, x, wg, wu, wd, rv).float(), **TOL)


@pytest.mark.cuda
def test_k3b_and_autograd_backward_on_card(cuda_device):
    """K3b (every row live) forward and its backward through autograd."""
    go, x, wg, wu, wd, _ = _k2k3_inputs(2, 72, [], cuda_device)
    leaves = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
    n1, nb = moe_gemm.launches, moe_gemm_ungrouped.launches
    out = moe_gemm_ungrouped(*leaves)
    out.backward(go)
    torch.cuda.synchronize()
    assert (moe_gemm.launches, moe_gemm_ungrouped.launches) == (n1, nb + 1)
    ref = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
    torch.testing.assert_close(out.float(), moe_gemm_plain(*ref).float(), **TOL)
    all_live = torch.ones((2, 72), dtype=torch.bool, device=cuda_device)
    want = (moe_gemm_dgrad_plain(go, x, wg, wu, wd, all_live), *moe_gemm_wgrad_plain(go, x, wg, wu, wd, all_live))
    torch.testing.assert_close(leaves[0].grad.float(), want[0].float(), **TOL)
    for leaf, w in zip(leaves[1:], want[1:]):
        _close_l2(leaf.grad, w)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "h,kh,sq,skv,d,window",
    [
        (8, 2, 100, 100, 128, None),  # ragged q and kv tiles, GQA G=4
        (4, 4, 64, 200, 64, None),  # q_offset = Skv - Sq
        (4, 1, 96, 96, 16, 20),  # sliding window skips leading KV tiles
    ],
)
def test_k4_kernel_matches_plain_on_card(cuda_device, h, kh, sq, skv, d, window):
    rng = np.random.default_rng(4)
    q = _randn(rng, (2, h, sq, d), 1.0, cuda_device)
    k, v = (_randn(rng, (2, kh, skv, d), 1.0, cuda_device) for _ in range(2))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q * (d**-0.5), k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize(
    "h,kh,sq,skv,window,causal",
    [
        # an even group: two query heads and two q tiles a block
        (8, 2, 70, 200, None, True),  # G = 4, Sq < Skv (q_offset 130)
        (8, 2, 150, 150, 40, True),  # a window: leading KV tiles skipped, straddling ones masked
        (4, 1, 130, 190, 50, False),  # a window without the causal mask, MQA
        (4, 1, 70, 600, None, True),  # 10 KV tiles: the pair's tiles stream through the ring with refills
        (8, 4, 300, 300, 100, True),  # G = 2, window, refills
        # an odd group: one block per query head and q tile
        (4, 4, 100, 100, None, True),  # G = 1, ragged q and kv tiles
        (6, 2, 300, 300, 100, True),  # G = 3, window, refills of the two-stage ring
        (3, 1, 70, 600, None, True),  # G = 3, 10 KV tiles
    ],
)
def test_k4_kernel_head_sizes_on_card(cuda_device, d, h, kh, sq, skv, window, causal):
    rng = np.random.default_rng(8)
    q = _randn(rng, (2, h, sq, d), 1.0, cuda_device)
    k, v = (_randn(rng, (2, kh, skv, d), 1.0, cuda_device) for _ in range(2))
    out = k4_launch(q, k, v, causal=causal, window=window)
    ref = flash_attention_plain(q * (d**-0.5), k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.cuda
def test_k4_kernel_at_the_prefill_shape_from_strided_views(cuda_device):
    """Mixtral's prefill (B=4, 32/8 heads of 128, S=256) as attn_flash calls
    it: the [B, S, H, D] projections handed over as [B, H, S, D] views are
    read in place, the pre-scaled q is undone (``prescale``) and scaled
    again in the kernel with both bf16 roundings, and the output's
    [B, S, H, D] transpose is dense, as _apply_out wants."""
    rng = np.random.default_rng(9)
    q = _randn(rng, (4, 256, 32, 128), 1.0, cuda_device).transpose(1, 2) * 128**-0.5  # _qkv's pre-scale
    k, v = (_randn(rng, (4, 256, 8, 128), 1.0, cuda_device).transpose(1, 2) for _ in range(2))
    assert all(kernel_readable(t) and not t.is_contiguous() for t in (k, v))
    out = k4_launch(q, k, v, causal=True, window=None, prescale=128**0.5)
    assert out.transpose(1, 2).is_contiguous()
    ref = flash_attention_plain((q * 128**0.5) * 128**-0.5, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "sq,skv,window,causal",
    [
        (100, 100, 0, True),  # window 0: no row sees a key
        (150, 40, None, True),  # Sq > Skv: rows before position 0 see no key
        (130, 130, 0, False),  # window 0 without the causal mask: only the last row sees none
    ],
)
def test_k4_kernel_fully_masked_rows_average_every_key(cuda_device, sq, skv, window, causal):
    """NEG = -1e30, not -inf: a row that sees no key averages all of them,
    as the reference; the kernel then walks every KV tile."""
    rng = np.random.default_rng(10)
    q = _randn(rng, (2, 8, sq, 64), 1.0, cuda_device)
    k, v = (_randn(rng, (2, 2, skv, 64), 1.0, cuda_device) for _ in range(2))
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_plain(q * 64**-0.5, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    blind = ~attention_mask(sq, skv, causal=causal, window=window, device=cuda_device).any(dim=1)
    assert blind.any()
    mean_v = v.float().mean(dim=2, keepdim=True).repeat_interleave(4, dim=1)  # [B, H, 1, D]
    torch.testing.assert_close(out[:, :, blind].float(), mean_v.expand(-1, -1, int(blind.sum()), -1), **TOL)


@pytest.mark.cuda
def test_k4_kernel_raises_for_views_it_cannot_read(cuda_device):
    """A view the kernel cannot read in place raises; nothing is copied."""
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    d_strided = torch.zeros((1, 2, 64, 8), dtype=torch.bfloat16, device=cuda_device).transpose(-1, -2)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="unit stride in D"):
        flash_attention(d_strided, q, q)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros((2, 8, 64), device=cuda_device)  # f32: the kernel takes bf16 only
    w = torch.zeros((2, 64, 64), device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        moe_gemm(x, w, w, w, torch.ones((2, 8), dtype=torch.bool, device=cuda_device))
    q = torch.zeros((1, 2, 8, 48), dtype=torch.bfloat16, device=cuda_device)  # D=48 not built
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention(q, q, q)


@pytest.mark.cuda
def test_k4_kernel_takes_transposed_views(cuda_device):
    """The model hands K4 [B, S, H, D] tensors transposed to [B, H, S, D]."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (2, 72, 8, 128), 1.0, cuda_device).transpose(1, 2)
    k, v = (_randn(rng, (2, 72, 2, 128), 1.0, cuda_device).transpose(1, 2) for _ in range(2))
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q * (128**-0.5), k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


WKV_TOL = dict(rtol=1e-4, atol=1e-4)


def _wkv_inputs(rng, b, h, t, device, layout="bhtd", dtype=torch.bfloat16):
    """r/k/v ~ 0.5 N(0, 1) in ``dtype``, f32 w = exp(-exp(-2 + 0.5 N(0, 1)))
    (the model's range), u ~ 0.1 N(0, 1).  ``layout="btdh"`` draws
    [B, T, H, D] storage and returns its [B, H, T, D] view, as the model
    hands them."""
    d = 64
    shape = (b, h, t, d) if layout == "bhtd" else (b, t, h, d)
    r, k, v = (_randn(rng, shape, 0.5, device).to(dtype) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(-2.0 + 0.5 * rng.standard_normal(shape))).astype(np.float32)).to(device)
    if layout != "bhtd":
        r, k, v, w = (x.transpose(1, 2) for x in (r, k, v, w))
    u = torch.from_numpy((rng.standard_normal((h, d)) * 0.1).astype(np.float32)).to(device)
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 5, 37, 1024])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("layout,dtype", [("bhtd", torch.bfloat16), ("btdh", torch.bfloat16), ("btdh", torch.float32)])
def test_k5_kernel_matches_plain_on_card(cuda_device, t, carried, layout, dtype):
    rng = np.random.default_rng(6)
    b, h = 2, 3
    r, k, v, w, u = _wkv_inputs(rng, b, h, t, cuda_device, layout, dtype)
    s0 = None
    if carried:
        s0 = torch.from_numpy((rng.standard_normal((b, h, 64, 64)) * 0.3).astype(np.float32)).to(cuda_device)
    before = wkv6.launches
    y, s = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert y.shape == (b, h, t, 64) and s.shape == (b, h, 64, 64) and y.dtype == s.dtype == torch.float32
    y_ref, s_ref = wkv6_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_ref, **WKV_TOL)
    torch.testing.assert_close(s, s_ref, **WKV_TOL)


@pytest.mark.cuda
def test_k5_kernel_chains_through_the_state(cuda_device):
    """Decode's T = 1 steps from the carried state equal one pass."""
    r, k, v, w, u = _wkv_inputs(np.random.default_rng(7), 1, 2, 8, cuda_device)
    y, s = wkv6(r, k, v, w, u)
    state, ys = None, []
    for i in range(8):
        yi, state = wkv6(r[:, :, i:i + 1], k[:, :, i:i + 1], v[:, :, i:i + 1], w[:, :, i:i + 1], u, state)
        ys.append(yi)
    torch.testing.assert_close(torch.cat(ys, dim=2), y, **WKV_TOL)
    torch.testing.assert_close(state, s, **WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["near 0", "near 1"])
@pytest.mark.parametrize("carried", [False, True])
def test_k5_kernel_at_a_pass_boundary_with_extreme_decays(cuda_device, decay, carried):
    """T = 33 is one staged pass of 32 steps plus one, B·H = 5 blocks; decays near 0 forget the state
    at every step, near 1 let it grow over all 33.  One call equals a chain of T = 1 calls."""
    rng = np.random.default_rng(12)
    b, h, t = 1, 5, 33
    r, k, v, _, u = _wkv_inputs(rng, b, h, t, cuda_device)
    eps = rng.uniform(0.0, 1e-3, (b, h, t, 64))
    w = torch.from_numpy((eps if decay == "near 0" else 1.0 - eps).astype(np.float32)).to(cuda_device)
    s0 = None
    if carried:
        s0 = torch.from_numpy((rng.standard_normal((b, h, 64, 64)) * 0.3).astype(np.float32)).to(cuda_device)
    y, s = wkv6(r, k, v, w, u, s0)
    y_ref, s_ref = wkv6_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_ref, **WKV_TOL)
    torch.testing.assert_close(s, s_ref, **WKV_TOL)
    state, ys = s0, []
    for i in range(t):
        yi, state = wkv6(r[:, :, i:i + 1], k[:, :, i:i + 1], v[:, :, i:i + 1], w[:, :, i:i + 1], u, state)
        ys.append(yi)
    torch.testing.assert_close(torch.cat(ys, dim=2), y, **WKV_TOL)
    torch.testing.assert_close(state, s, **WKV_TOL)


@pytest.mark.cuda
def test_k5_kernel_copies_views_whose_rows_are_not_16_byte_aligned(cuda_device):
    """Rows of 64 of a [.., 68] storage start 136 bytes apart in bf16: the kernel's 16-byte copies
    cannot read them in place, so the wrapper hands it contiguous copies."""
    rng = np.random.default_rng(13)
    r, k, v, w, u = _wkv_inputs(rng, 2, 3, 40, cuda_device)
    pad = [torch.nn.functional.pad(x, (0, 4))[..., :64] for x in (r, k, v, w)]
    assert pad[0].stride()[2] == 68 and not pad[0].is_contiguous()
    y, s = wkv6(*pad, u)
    y_ref, s_ref = wkv6_plain(r, k, v, w, u)
    torch.testing.assert_close(y, y_ref, **WKV_TOL)
    torch.testing.assert_close(s, s_ref, **WKV_TOL)


@pytest.mark.cuda
def test_k5_kernel_raises_for_other_head_sizes(cuda_device):
    """D != 64 raises on a CUDA tensor instead of running the plain version."""
    r = torch.zeros((1, 2, 4, 16), dtype=torch.bfloat16, device=cuda_device)
    w = torch.full((1, 2, 4, 16), 0.5, device=cuda_device)
    u = torch.zeros((2, 16), device=cuda_device)
    before = wkv6.launches
    with pytest.raises(ValueError, match="head size 16"):
        wkv6(r, r, r, w, u)
    with pytest.raises(ValueError, match="w must be"):
        wkv6(*(torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16, device=cuda_device) for _ in range(4)),
             torch.zeros((2, 64), device=cuda_device))
    assert wkv6.launches == before


@pytest.mark.cuda
def test_stream_handle_is_the_current_stream(cuda_device):
    """Every wrapper launches on ``build.stream_handle``, PyTorch's raw stream
    query: it must name the stream ``torch.cuda.current_stream`` does, on the
    default stream and under another one, and K4 must run on the latter."""
    dev = torch.device("cuda", torch.cuda.current_device())  # the wrappers pass a tensor's device: indexed
    assert build.stream_handle(dev) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    rng = np.random.default_rng(11)
    q = _randn(rng, (1, 4, 64, 64), 1.0, cuda_device)
    k, v = (_randn(rng, (1, 2, 64, 64), 1.0, cuda_device) for _ in range(2))
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        assert build.stream_handle(dev) == side.cuda_stream != torch.cuda.default_stream(dev).cuda_stream
        out = flash_attention(q, k, v, causal=True)
    side.synchronize()
    assert build.stream_handle(dev) == torch.cuda.current_stream(dev).cuda_stream
    torch.testing.assert_close(out.float(), flash_attention_plain(q * 64**-0.5, k, v, causal=True).float(), **TOL)

"""The CUDA kernels K1, K2/K3 (its backward), K3b (ungrouped), K4, K5
(the WKV6 recurrence), K5b (its backward), K6 (the Mamba selective
scan) and K6b (its backward) against their plain PyTorch versions on the card,
at small and ragged shapes.  Skips without a CUDA device.  Run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance 2e-2 (bf16): kernel and plain version both accumulate in f32,
in another order, so a bf16 rounding of h, p or the output can differ by
an ulp.  K4 at head dim 120 is also held to a relative L2 of 3e-3 over
each (b, head), which a window edge moved by a tile exceeds.  The weight gradients (K3) are held by relative L2 (2e-3) and a
max error of 2e-2 * max|plain|: kernel and plain version each round
their own f32 da/du/h to bf16, a few tenths of a percent of those land
one ulp apart, and one such element times a large x moves a single
weight gradient by more than the elementwise bound.  K5 computes in f32
on both sides (bf16 r/k/v are widened first): 1e-4, for the order of
the 64-term sums.  K5b too, in f32 on both sides: each gradient within
1e-3 relative L2 and 1e-3 * max|plain| (sums over T and over 64 terms in
another order).  K6 is f32 on both sides (bf16 x widened first): 1e-4
relative to max|plain|, for the order of the 16-term sums and the
exponential's rounding.  K6b is f32 on both sides too: each gradient
within 1e-3 relative L2 and 1e-3 * max|plain| (K5b's rule: sums over t,
over channels and over 16 states in another order), and two runs give
the same bits.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import attention_mask, flash_attention, flash_attention_plain, kernel_readable
from repro_torch.kernels.flash_attention.ops import _launch as k4_launch
from repro_torch.kernels.mamba_scan import ops as k6_ops
from repro_torch.kernels.mamba_scan import selective_scan, selective_scan_bwd, selective_scan_bwd_plain, selective_scan_plain
from repro_torch.kernels.rwkv_wkv import wkv6, wkv6_bwd, wkv6_bwd_plain, wkv6_plain
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
K4_REL_L2 = 3e-3  # K4 vs plain, relative L2 over each (b, head): chip_smoke.py's limit


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
    q = torch.zeros((1, 2, 8, 20), dtype=torch.bfloat16, device=cuda_device)  # D=20: not a multiple of 8
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


def _close_bwd(got, want, tol=1e-3):
    """K5b vs plain, gradient by gradient: relative L2 and max |diff| against max |plain|."""
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    for name, g, p in zip(names, got, want):
        if p is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float32 and g.shape == p.shape and torch.isfinite(g).all(), name
        scale = p.abs().max().item()
        assert (g - p).norm().item() <= tol * p.norm().item(), (name, ((g - p).norm() / p.norm()).item())
        assert (g - p).abs().max().item() <= tol * scale, (name, (g - p).abs().max().item(), scale)


def _bwd_case(rng, b, h, t, device, layout, dtype, carried, w=None):
    r, k, v, w_, u = _wkv_inputs(rng, b, h, t, device, layout, dtype)
    w = w_ if w is None else w
    dy = torch.from_numpy(rng.standard_normal((b, h, t, 64)).astype(np.float32)).to(device)
    s0 = ds = None
    if carried:
        s0, ds = (torch.from_numpy((rng.standard_normal((b, h, 64, 64)) * 0.3).astype(np.float32)).to(device)
                  for _ in range(2))
    return r, k, v, w, u, dy, s0, ds


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 63, 64, 65, 1024])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("layout,dtype", [("bhtd", torch.bfloat16), ("btdh", torch.bfloat16), ("btdh", torch.float32),
                                          ("bhtd", torch.float32)])
def test_k5b_kernel_matches_plain_on_card(cuda_device, t, carried, layout, dtype):
    """Carried: from s0 with a nonzero dS_final (ds0 returned); else from 0 with none."""
    args = _bwd_case(np.random.default_rng(t), 2, 3, t, cuda_device, layout, dtype, carried)
    before = wkv6_bwd.launches
    got = wkv6_bwd(*args)
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == before + 1
    _close_bwd(got, wkv6_bwd_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["near 0", "near 1"])
@pytest.mark.parametrize("carried", [False, True])
def test_k5b_kernel_with_extreme_decays(cuda_device, decay, carried):
    """Decays near 0 (down to 1e-30 in a product of two steps) forget the state at every step, near 1 keep
    it over all 97 steps (three snapshots and a ragged chunk)."""
    rng = np.random.default_rng(14)
    b, h, t = 1, 5, 97
    eps = rng.uniform(1e-15, 1e-3, (b, h, t, 64))
    w = torch.from_numpy((eps if decay == "near 0" else 1.0 - eps).astype(np.float32)).to(cuda_device)
    args = _bwd_case(rng, b, h, t, cuda_device, "bhtd", torch.bfloat16, carried, w=w)
    _close_bwd(wkv6_bwd(*args), wkv6_bwd_plain(*args))


K5B_CHUNK = 32  # steps a chunk of K5b's parallel walk (csrc/rwkv_wkv_bwd.cu, C)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, K5B_CHUNK - 1, K5B_CHUNK + 1, 1000])
@pytest.mark.parametrize("carried", [False, True])
def test_k5b_kernel_at_its_chunk_edges(cuda_device, t, carried):
    """T at one step, a chunk less one, a chunk and one, and 1000 (31 whole chunks and a ragged one of 8),
    in the model's [B, T, H, D] views."""
    args = _bwd_case(np.random.default_rng(100 + t), 2, 3, t, cuda_device, "btdh", torch.bfloat16, carried)
    before = wkv6_bwd.launches
    got = wkv6_bwd(*args)
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == before + 1
    _close_bwd(got, wkv6_bwd_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("carried", [False, True])
def test_k5b_kernel_with_extreme_decays_across_chunk_edges(cuda_device, carried):
    """Decays of 1e-30 and of 1 - 1e-7 mixed in at random, and on the last step of every chunk and the
    first of the next: the closed form's products of decays across a chunk, its 8-step blocks and the
    chunk edges meet both ends."""
    rng = np.random.default_rng(21)
    b, h, t = 2, 3, 3 * K5B_CHUNK + 5
    w = rng.uniform(0.3, 0.99, (b, h, t, 64))
    pick = rng.random((b, h, t, 64))
    w = np.where(pick < 0.2, 1e-30, np.where(pick > 0.8, 1 - 1e-7, w))
    edges = [e + d for e in range(K5B_CHUNK, t, K5B_CHUNK) for d in (-1, 0)]
    w[:, :, edges, ::2] = 1e-30
    w[:, :, edges, 1::2] = 1 - 1e-7
    w = torch.from_numpy(w.astype(np.float32)).to(cuda_device)
    args = _bwd_case(rng, b, h, t, cuda_device, "btdh", torch.bfloat16, carried, w=w)
    _close_bwd(wkv6_bwd(*args), wkv6_bwd_plain(*args))


@pytest.mark.cuda
def test_k5b_kernel_gives_the_same_bits_twice(cuda_device):
    """Every sum (the sweep over the chunk edges, the rows' KER sums, du over the chunks) has a fixed
    order and no atomics: two calls are equal bit for bit."""
    args = _bwd_case(np.random.default_rng(22), 4, 8, 300, cuda_device, "btdh", torch.bfloat16, True)
    first, second = wkv6_bwd(*args), wkv6_bwd(*args)
    for name, g1, g2 in zip(("dr", "dk", "dv", "dw", "du", "ds0"), first, second):
        assert torch.equal(g1, g2), name


@pytest.mark.cuda
def test_k5b_kernel_copies_views_whose_rows_are_not_16_byte_aligned(cuda_device):
    """Rows of a [.., 68] storage (bf16, 136 bytes apart) are handed to K5b as contiguous copies,
    as to K5; dy keeps its own strides."""
    rng = np.random.default_rng(15)
    r, k, v, w, u, dy, s0, ds = _bwd_case(rng, 2, 3, 40, cuda_device, "bhtd", torch.bfloat16, True)
    pad = [torch.nn.functional.pad(x, (0, 4))[..., :64] for x in (r, k, v, w)]
    assert pad[0].stride()[2] == 68 and not pad[0].is_contiguous()
    dy_t = dy.transpose(1, 2).contiguous().transpose(1, 2)  # [B, T, H, D] storage
    _close_bwd(wkv6_bwd(*pad, u, dy_t, s0, ds), wkv6_bwd_plain(r, k, v, w, u, dy, s0, ds))


@pytest.mark.cuda
def test_k5b_kernel_raises_for_other_head_sizes(cuda_device):
    """D != 64 raises on a CUDA tensor instead of running the plain version."""
    r = torch.zeros((1, 2, 4, 16), dtype=torch.bfloat16, device=cuda_device)
    w = torch.full((1, 2, 4, 16), 0.5, device=cuda_device)
    u = torch.zeros((2, 16), device=cuda_device)
    before = wkv6_bwd.launches
    with pytest.raises(ValueError, match="head size 16"):
        wkv6_bwd(r, r, r, w, u, torch.zeros((1, 2, 4, 16), device=cuda_device))
    assert wkv6_bwd.launches == before


@pytest.mark.cuda
def test_wkv6_autograd_runs_k5_and_k5b_on_card(cuda_device):
    """Through autograd: one K5 launch forward, one K5b backward, the gradients in the inputs' dtypes
    and equal to the plain backward's; under no_grad no node and no K5b."""
    rng = np.random.default_rng(16)
    r, k, v, w, u, dy, s0, ds = _bwd_case(rng, 2, 3, 70, cuda_device, "btdh", torch.bfloat16, True)
    leaves = [x.detach().clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    fwd, bwd = wkv6.launches, wkv6_bwd.launches
    y, s = wkv6(*leaves)
    ((y * dy).sum() + (s * ds).sum()).backward()
    assert (wkv6.launches, wkv6_bwd.launches) == (fwd + 1, bwd + 1)
    want = wkv6_bwd_plain(r, k, v, w, u, dy, s0, ds)
    for leaf, g in zip(leaves, (*want[:5], want[5])):
        assert leaf.grad.dtype == leaf.dtype
        torch.testing.assert_close(leaf.grad.float(), g.to(leaf.dtype).float(), rtol=2e-2, atol=2e-2)
    with torch.no_grad():
        y2, _ = wkv6(*leaves)
    assert y2.grad_fn is None and wkv6_bwd.launches == bwd + 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("h,kh,sq", [(8, 2, 150), (6, 2, 300), (4, 1, 70)])
def test_k4_kernel_at_head_dim_120_on_card(cuda_device, h, kh, sq, window):
    """h2o-danube's D = 120 in the model's [B, S, H, D] views, transposed:
    a 128-column tile whose loads stop at column 120 (the next head's
    columns sit right after), the pre-scaled q undone with the true D, and
    only 120 columns stored; with and without a window."""
    d = 120
    rng = np.random.default_rng(12)
    q = _randn(rng, (2, sq, h, d), 1.0, cuda_device).transpose(1, 2) * d**-0.5
    k, v = (_randn(rng, (2, sq, kh, d), 1.0, cuda_device).transpose(1, 2) for _ in range(2))
    assert all(kernel_readable(t) for t in (q, k, v))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window, prescale=d**0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.shape == (2, h, sq, d)
    ref = flash_attention_plain((q * d**0.5) * d**-0.5, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    o, r = out.float().flatten(2), ref.float().flatten(2)
    assert ((o - r).norm(dim=-1) / r.norm(dim=-1)).max().item() <= K4_REL_L2


def _scan_inputs(rng, b, s, di, ds, x_dtype, device, carried):
    x = torch.from_numpy(rng.standard_normal((b, s, di)).astype(np.float32)).to(device, x_dtype)
    dt = torch.from_numpy(rng.uniform(0.001, 0.5, (b, s, di)).astype(np.float32)).to(device)
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, ds)).astype(np.float32)).to(device) for _ in range(2))
    a = -torch.from_numpy(rng.uniform(0.5, 16, (di, ds)).astype(np.float32)).to(device)
    d_skip = torch.from_numpy(rng.standard_normal(di).astype(np.float32)).to(device)
    h0 = torch.from_numpy(rng.standard_normal((b, di, ds)).astype(np.float32)).to(device) if carried else None
    return x, dt, bm, cm, a, d_skip, h0


def _scan_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,s,di,ds,carried",
    [
        (2, 1, 256, 16, True),  # decode: one step from a carried state
        (2, 37, 200, 16, False),  # ragged channels (a partial block) and a partial chunk
        (1, 64, 128, 16, True),  # two whole chunks
        (3, 70, 384, 7, True),  # fewer states than the registers hold
    ],
)
def test_k6_kernel_matches_plain_on_card(cuda_device, x_dtype, b, s, di, ds, carried):
    rng = np.random.default_rng(13)
    args = _scan_inputs(rng, b, s, di, ds, x_dtype, cuda_device, carried)
    before = selective_scan.launches
    y, h = selective_scan(*args)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    want_y, want_h = selective_scan_plain(*args)
    assert y.shape == (b, s, di) and h.shape == (b, di, ds) and y.dtype == h.dtype == torch.float32
    _scan_close(y, want_y)
    _scan_close(h, want_h)


@pytest.mark.cuda
def test_k6_kernel_writes_the_state_in_place_on_card(cuda_device):
    """A decode step passes the cache's state as h0 and h_out: the kernel
    updates that tensor, and eight such steps equal one eight-step scan."""
    rng = np.random.default_rng(14)
    x, dt, bm, cm, a, d_skip, h0 = _scan_inputs(rng, 2, 8, 256, 16, torch.bfloat16, cuda_device, True)
    state = h0.clone()
    ptr = state.data_ptr()
    ys = []
    for t in range(8):
        y, h = selective_scan(x[:, t:t + 1], dt[:, t:t + 1], bm[:, t:t + 1], cm[:, t:t + 1], a, d_skip, state, state)
        assert h is state and state.data_ptr() == ptr
        ys.append(y)
    want_y, want_h = selective_scan_plain(x, dt, bm, cm, a, d_skip, h0)
    _scan_close(torch.cat(ys, dim=1), want_y)
    _scan_close(state, want_h)


K6_CHUNK = 16  # steps K6 stages at a time (csrc/mamba_scan.cu, CH); 64 channels a block


@pytest.mark.cuda
@pytest.mark.parametrize("s", [K6_CHUNK - 1, K6_CHUNK, K6_CHUNK + 1, 2 * K6_CHUNK + 1])
@pytest.mark.parametrize("ds", [1, 5, 16])
def test_k6_kernel_across_its_staging_edges(cuda_device, s, ds):
    """S on either side of the double-buffered chunks, ds at 1, 5 and 16, and di = 100 (a block of 64 and
    a ragged one of 36), from a carried state."""
    rng = np.random.default_rng(200 + s + ds)
    args = _scan_inputs(rng, 2, s, 100, ds, torch.bfloat16, cuda_device, True)
    y, h = selective_scan(*args)
    want_y, want_h = selective_scan_plain(*args)
    _scan_close(y, want_y)
    _scan_close(h, want_h)


@pytest.mark.cuda
@pytest.mark.parametrize("ds,di", [(16, 1000), (5, 100), (1, 37)])
def test_k6_decode_step_in_place(cuda_device, ds, di):
    """The one-step kernel (float4 rows at ds = 16, element by element otherwise, di not a multiple of a
    block) updates the cache's tensor in place, and 5 steps equal one 5-step scan."""
    rng = np.random.default_rng(210 + ds)
    x, dt, bm, cm, a, d_skip, h0 = _scan_inputs(rng, 3, 5, di, ds, torch.bfloat16, cuda_device, True)
    state = h0.clone()
    ys = []
    for t in range(5):
        y, h = selective_scan(x[:, t:t + 1], dt[:, t:t + 1], bm[:, t:t + 1], cm[:, t:t + 1], a, d_skip, state, state)
        assert h is state
        ys.append(y)
    want_y, want_h = selective_scan_plain(x, dt, bm, cm, a, d_skip, h0)
    _scan_close(torch.cat(ys, dim=1), want_y)
    _scan_close(state, want_h)


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [5, 16])
def test_k6b_holds_on_the_checkpoints_k6_writes_across_its_staging_edges(cuda_device, ds):
    """K6 with checkpoints at S = 2 chunks + 1 and a ragged channel block; K6b from them against the
    explicit reverse recurrence."""
    rng = np.random.default_rng(220 + ds)
    args, dy, dh = _k6b_case(rng, 2, 2 * K6_CHUNK + 1, 200, ds, torch.bfloat16, cuda_device, True)
    y, h, hck = k6_ops._launch(*args, checkpoints=True)
    want_y, want_h = selective_scan_plain(*args)
    _scan_close(y, want_y)
    _scan_close(h, want_h)
    _k6b_close(selective_scan_bwd(*args[:6], dy, args[6], dh, checkpoints=hck),
               selective_scan_bwd_plain(*args[:6], dy, args[6], dh))


@pytest.mark.cuda
def test_k6_kernel_rejects_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(15)
    x, dt, bm, cm, a, d_skip, _ = _scan_inputs(rng, 1, 4, 64, 16, torch.bfloat16, cuda_device, False)
    before = selective_scan.launches
    with pytest.raises(ValueError, match="ds="):
        selective_scan(x, dt, torch.zeros((1, 4, 17), device=cuda_device), cm, torch.zeros((64, 17), device=cuda_device),
                       d_skip)
    with pytest.raises(ValueError, match="dt must be f32"):
        selective_scan(x, dt.to(torch.bfloat16), bm, cm, a, d_skip)
    assert selective_scan.launches == before


K6B_NAMES = ("dx", "ddt", "db", "dc", "da", "dd_skip", "dh0")


def _k6b_close(got, want):
    for name, g, w in zip(K6B_NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float32 and g.shape == w.shape and torch.isfinite(g).all(), name
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert rel <= 1e-3 and (g - w).abs().max().item() <= 1e-3 * w.abs().max().item(), (name, rel)


def _k6b_case(rng, b, s, di, ds, x_dtype, device, carried):
    args = _scan_inputs(rng, b, s, di, ds, x_dtype, device, carried)
    dy = torch.from_numpy(rng.standard_normal((b, s, di)).astype(np.float32)).to(device)
    dh = torch.from_numpy(rng.standard_normal((b, di, ds)).astype(np.float32)).to(device) if carried else None
    return args, dy, dh


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,di,ds,carried,x_dtype",
    [
        (2, 37, 200, 16, True, torch.bfloat16),  # ragged channels, a partial checkpoint chunk, h0 and dh_final
        (1, 64, 128, 16, False, torch.float32),  # whole chunks from zeros
        (3, 70, 384, 7, True, torch.float32),  # fewer states than the registers hold
        (2, 1, 64, 16, True, torch.bfloat16),  # one step
    ],
)
def test_k6b_kernel_matches_plain_on_card(cuda_device, b, s, di, ds, carried, x_dtype):
    """K6b from K6's checkpoints against the explicit reverse recurrence; the checkpoints are the plain
    forward's states before every ckpt_steps()-th step, [B, n, ds, di]."""
    rng = np.random.default_rng(17)
    args, dy, dh = _k6b_case(rng, b, s, di, ds, x_dtype, cuda_device, carried)
    y, h, hck = k6_ops._launch(*args, checkpoints=True)
    ck = k6_ops.ckpt_steps()
    assert hck.shape == (b, -(-s // ck), ds, di)
    x, dt, bm, cm, a, d_skip, h0 = args
    for k in range(hck.shape[1]):
        want = h0 if h0 is not None and k == 0 else (
            selective_scan_plain(x[:, :ck * k], dt[:, :ck * k], bm[:, :ck * k], cm[:, :ck * k], a, d_skip, h0)[1]
            if k else torch.zeros((b, di, ds), device=cuda_device))
        _scan_close(hck[:, k].transpose(1, 2), want)
    before = selective_scan_bwd.launches
    got = selective_scan_bwd(*args[:6], dy, h0, dh, checkpoints=hck)
    torch.cuda.synchronize()
    assert selective_scan_bwd.launches == before + 1
    _k6b_close(got, selective_scan_bwd_plain(*args[:6], dy, h0, dh))


@pytest.mark.cuda
def test_k6b_kernel_gives_the_same_bits_twice(cuda_device):
    """The channel sums (db, dc) and the sums over b and t (da, dd_skip) go through ordered partials, no
    atomics: two runs are equal bit for bit."""
    rng = np.random.default_rng(18)
    args, dy, dh = _k6b_case(rng, 4, 100, 1000, 16, torch.bfloat16, cuda_device, True)
    _, _, hck = k6_ops._launch(*args, checkpoints=True)
    first = selective_scan_bwd(*args[:6], dy, args[6], dh, checkpoints=hck)
    second = selective_scan_bwd(*args[:6], dy, args[6], dh, checkpoints=hck)
    for name, g1, g2 in zip(K6B_NAMES, first, second):
        assert torch.equal(g1, g2), name


@pytest.mark.cuda
def test_selective_scan_autograd_runs_k6_and_k6b_on_card(cuda_device):
    """Through autograd: one K6 launch with checkpoints forward, one K6b backward, gradients in the inputs'
    dtypes equal to the plain backward's; under inference_mode and no_grad no node, no checkpoint buffer
    and no K6b."""
    rng = np.random.default_rng(19)
    args, dy, dh = _k6b_case(rng, 2, 50, 256, 16, torch.bfloat16, cuda_device, True)
    leaves = [t.detach().clone().requires_grad_() for t in args]
    fwd, bwd = selective_scan.launches, selective_scan_bwd.launches
    y, h = selective_scan(*leaves)
    ((y * dy).sum() + (h * dh).sum()).backward()
    assert (selective_scan.launches, selective_scan_bwd.launches) == (fwd + 1, bwd + 1)
    want = selective_scan_bwd_plain(*args[:6], dy, args[6], dh)
    for name, leaf, g in zip(K6B_NAMES, leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        torch.testing.assert_close(leaf.grad.float(), g.to(leaf.dtype).float(), rtol=2e-2, atol=2e-2, msg=name)
    calls = []
    real = k6_ops._launch

    def spy(*a_, **kw):
        calls.append(kw.get("checkpoints", a_[8] if len(a_) > 8 else False))
        return real(*a_, **kw)

    k6_ops._launch = spy
    try:
        for mode in (torch.inference_mode, torch.no_grad):
            with mode():
                y2, _ = selective_scan(*leaves)
            assert y2.grad_fn is None
    finally:
        k6_ops._launch = real
    assert calls == [False, False] and selective_scan_bwd.launches == bwd + 1
    with pytest.raises(ValueError, match="h_out"):
        selective_scan(*leaves, h_out=torch.empty_like(args[6]))


K6B_CLUSTER_CHANNELS = 512  # channels a K6b cluster sums dB/dC over (csrc/mamba_scan_bwd.cu: 8 blocks of 64)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", ["under one interval", "ragged", "several intervals"])
@pytest.mark.parametrize("di,ds,x_dtype", [(100, 5, torch.bfloat16), (600, 16, torch.float32), (1100, 1, torch.bfloat16)])
@pytest.mark.parametrize("given", ["neither", "h0", "dh_final", "both"])
def test_k6b_across_its_interval_block_and_cluster_edges(cuda_device, steps, di, ds, x_dtype, given):
    """K6b from K6's checkpoints at S under one checkpoint interval, S not a multiple of it and S over
    several; di a ragged block of 64 channels (100), past one cluster of 512 (600: a second cluster
    mostly of blocks past di) and ragged in both (1100); ds 1, 5 and 16; bf16 and f32 x; h0 and dh_final
    each None and given; two runs give the same bits."""
    ck = k6_ops.ckpt_steps()
    s = {"under one interval": ck - 3, "ragged": ck + 5, "several intervals": 3 * ck + 1}[steps]
    rng = np.random.default_rng(300 + s + di + ds)
    args, dy, dh = _k6b_case(rng, 2, s, di, ds, x_dtype, cuda_device, True)
    h0 = args[6] if given in ("h0", "both") else None
    dh = dh if given in ("dh_final", "both") else None
    args = (*args[:6], h0)
    assert -(-di // 64) != -(-di // K6B_CLUSTER_CHANNELS) * 8  # some blocks lie past di
    _, _, hck = k6_ops._launch(*args, checkpoints=True)
    first = selective_scan_bwd(*args[:6], dy, h0, dh, checkpoints=hck)
    second = selective_scan_bwd(*args[:6], dy, h0, dh, checkpoints=hck)
    _k6b_close(first, selective_scan_bwd_plain(*args[:6], dy, h0, dh))
    for name, g1, g2 in zip(K6B_NAMES, first, second):
        assert (g1 is None and g2 is None) or torch.equal(g1, g2), name


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_selective_scan_autograd_at_the_checkpoint_interval(cuda_device, x_dtype):
    """K6 -> K6b through autograd at S = 4 intervals + 3 with a carried state: the forward writes its
    checkpoints every ckpt_steps() steps, and every gradient equals the plain backward's."""
    ck = k6_ops.ckpt_steps()
    rng = np.random.default_rng(330)
    args, dy, dh = _k6b_case(rng, 3, 4 * ck + 3, 700, 16, x_dtype, cuda_device, True)
    leaves = [t.detach().clone().requires_grad_() for t in args]
    bwd = selective_scan_bwd.launches
    y, h = selective_scan(*leaves)
    ((y * dy).sum() + (h * dh).sum()).backward()
    assert selective_scan_bwd.launches == bwd + 1
    want = selective_scan_bwd_plain(*args[:6], dy, args[6], dh)
    grads = [leaf.grad for leaf in leaves]
    assert grads[0].dtype == x_dtype
    if x_dtype == torch.bfloat16:  # dx leaves in x's dtype: one bf16 rounding (the existing autograd test's 2e-2)
        torch.testing.assert_close(grads[0].float(), want[0].to(x_dtype).float(), rtol=2e-2, atol=2e-2)
        grads[0] = want[0]
    _k6b_close(grads, want)


@pytest.mark.cuda
def test_k6b_kernel_rejects_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(20)
    args, dy, _ = _k6b_case(rng, 1, 20, 64, 16, torch.float32, cuda_device, False)
    _, _, hck = k6_ops._launch(*args, checkpoints=True)
    before = selective_scan_bwd.launches
    x, dt, bm, cm, a, d_skip, _ = args
    with pytest.raises(ValueError, match="checkpoints"):
        selective_scan_bwd(*args[:6], dy)
    with pytest.raises(ValueError, match="checkpoints must be f32"):
        selective_scan_bwd(*args[:6], dy, checkpoints=hck[:, :1])
    with pytest.raises(ValueError, match="ds="):
        selective_scan_bwd(x, dt, torch.zeros((1, 20, 17), device=cuda_device), cm,
                           torch.zeros((64, 17), device=cuda_device), d_skip, dy, checkpoints=hck)
    assert selective_scan_bwd.launches == before

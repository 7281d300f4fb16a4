#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this
file; imports nothing of JAX or of the JAX package.  Phases, in order:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once);
3. K1 (grouped SwiGLU) and 4. K4 (flash attention) against their plain
   PyTorch versions at the serving path's full-width shapes, with the
   kernel's time beside the plain version's, one PyTorch library call's
   and the least time the card could take (``bound``);
5. K2 (dgrad) and K3 (wgrad) at the training shape, the same way, and
   K3b (the ungrouped forward): its own path, forward and backward
   through autograd, counted and held against the plain versions;
6. serve full-width Mixtral-8x7B cut to 4 layers (random weights from a
   seed) through the scheduled MoE path: plan a table, prefill, greedy
   decode, 2 rounds; the kernels' launch counts are reset just before and
   read just after, and the prefill logits of the kernel path are held
   against the plain path on the card;
7. one training step of full-width Mixtral at 1 layer, kernel path
   against plain path: loss and every gradient;
8. train full-width Mixtral-8x7B cut to 2 layers (f32 masters, bf16
   compute, remat per block, AdamW) for a few steps of synthetic data
   under the launcher's lossless table; counts reset just before and read
   just after; the loss must be finite and fall; then one more step runs
   under ``torch.profiler`` and its device time is printed by kernel group.

It prints a ``kernels`` JSON line, then, last, ``{"ok": true, "device":
...}``.  Any failure exits non-zero before that line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_TOL = 2e-2  # kernel vs plain, |diff| <= TOL + TOL * |plain| (both f32-accumulated; bf16 rounding)
# K3 (wgrad) vs plain: relative L2 per output <= WGRAD_REL_L2 and max |diff| <= WGRAD_MAX_REL * max |plain|.
# Kernel and plain version each round their own f32 da/du/h to bf16 before the products; the two f32
# accumulation orders put 0.4-0.6% of those elements one bf16 ulp apart (up to 0.03 at |da| ~ 8), and
# a flipped element times |x| up to ~4 moves a weight gradient of |p| ~ 1 by ~0.13, so the elementwise
# bound above does not hold for K3 at this shape (measured: rel L2 5.8e-4, max |diff| 0.5 at max |plain| 100).
WGRAD_REL_L2, WGRAD_MAX_REL = 2e-3, 2e-2
LOGITS_REL_TOL = 2e-2  # per-row relative L2 error of the 4-layer prefill logits, kernel vs plain path

GRAD_REL_TOL = 2e-2  # per-leaf relative L2 of the 1-layer train-step gradients, kernel vs plain path

# serving shape: the first slice's path
BATCH, PROMPT, NEW_TOKENS, ROUNDS, LAYERS, VIRTUAL_RANKS = 4, 256, 32, 2, 4, 8
# training shape: this slice's path (C = round8(ceil(2048 * 2 / 8 * 1.25)) = 640 slots per expert)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAYERS, TRAIN_STEPS, TRAIN_C = 8, 256, 2, 8, 640
PEAK_LR, WARMUP = 3e-4, 2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms for the work: the larger of bytes over the memory
    rate and operations over the bf16 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch next to {Path(__file__).name}: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.kernels.moe_gemm import ops as k1
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import plan_table, train
    from repro_torch.models import Model

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions run full f32 products
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(build.SOURCES)}")
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def close_l2(out, ref, what: str) -> float:
        out, ref = out.float(), ref.float()
        if not torch.isfinite(out).all():
            fail(f"{what}: non-finite output")
        rel = float((out - ref).norm() / ref.norm())
        err = float((out - ref).abs().max())
        if rel > WGRAD_REL_L2 or err > WGRAD_MAX_REL * float(ref.abs().max()):
            fail(f"{what}: rel L2 {rel:.3g} (tol {WGRAD_REL_L2}), max |kernel - plain| {err:.4g} "
                 f"(tol {WGRAD_MAX_REL} * max|plain| = {WGRAD_MAX_REL * float(ref.abs().max()):.4g})")
        print(f"  {what}: rel L2 {rel:.3g} (tol {WGRAD_REL_L2}), max abs err {err:.4g}, max |plain| {float(ref.abs().max()):.4g}")
        return err

    def close(out, ref, what: str) -> float:
        out, ref = out.float(), ref.float()
        if not torch.isfinite(out).all():
            fail(f"{what}: non-finite output")
        err = (out - ref).abs()
        worst = float((err - BF16_TOL * ref.abs()).max())
        if worst > BF16_TOL:
            fail(f"{what}: max |kernel - plain| {float(err.max()):.4g} beyond {BF16_TOL} + {BF16_TOL}*|plain|")
        return float(err.max())

    COUNTED = {
        "moe_gemm_grouped": k1.moe_gemm, "flash_attention_fwd": k4.flash_attention,
        "moe_gemm_grouped_dgrad": k1.moe_gemm_dgrad, "moe_gemm_grouped_wgrad": k1.moe_gemm_wgrad,
        "moe_gemm_ungrouped": k1.moe_gemm_ungrouped,
    }

    def reset_counts():
        for fn in COUNTED.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in COUNTED.items()}

    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = get_config("mixtral-8x7b")
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts

    # 3. K1 at the prefill (C=320 for B=4, S=256) and decode (C=8 for B=4) shapes
    def randn(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    wg, wu, wd = randn((e, d, f), d**-0.5), randn((e, d, f), d**-0.5), randn((e, f, d), f**-0.5)
    k1_rows = {}
    for label, c, counts in (
        ("prefill", 320, [320, 300, 256, 200, 130, 64, 5, 0]),  # full, partial and dark 64-row tiles
        ("decode", 8, [1, 0, 2, 0, 3, 1, 0, 1]),
    ):
        x = randn((e, c, d), 1.0)
        rv = torch.zeros((e, c), dtype=torch.bool, device=dev)
        for i, ct in enumerate(counts):
            rv[i, :ct] = True
        out = k1.moe_gemm(x, wg, wu, wd, rv)  # the wrapper, as the model calls it
        torch.cuda.synchronize()
        err = close(out, k1.moe_gemm_plain(x, wg, wu, wd, rv), f"K1 {label}")
        occ = k1.tile_occupancy(rv)
        rows = int(occ.sum())  # rows the function computes (rows of tiles with a live row)
        live_experts = int(occ.any(dim=1).sum())
        flops = 6.0 * d * f * rows
        nbytes = rows * d * 2 + live_experts * 3 * d * f * 2 + e * c + e * c * d * 2
        b_ms, b_by = bound(flops, nbytes)
        reps = 20 if label == "prefill" else 100

        def library():
            g = torch.bmm(x, wg)
            return torch.bmm(F.silu(g) * torch.bmm(x, wu), wd)

        k1_rows[label] = {
            "shape": f"x[{e},{c},{d}] w[{e},{d},{f}] occupied rows {rows}, live experts {live_experts}",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: k1._launch(x, wg, wu, wd, rv), reps),
            "plain_ms": cuda_ms(lambda: k1.moe_gemm_plain(x, wg, wu, wd, rv), 3, warmup=1),
            "library_ms": cuda_ms(library, reps),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        r = k1_rows[label]
        print(
            f"K1 {label}: {r['shape']} | max_abs_err {err:.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|) | kernel {r['ms']:.3f} ms | "
            f"plain {r['plain_ms']:.3f} ms | torch.bmm SwiGLU {r['library_ms']:.3f} ms | "
            f"bound {b_ms:.3f} ms ({b_by})"
        )
    del x, out  # the expert weights stay for K2, K3 and K3b
    torch.cuda.empty_cache()

    # 4. K4 at the prefill shape
    b, h, kh, s, hd = BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, cfg.resolved_head_dim
    q, k, v = randn((b, h, s, hd), 1.0), randn((b, kh, s, hd), 1.0), randn((b, kh, s, hd), 1.0)
    qs = q * (hd**-0.5)  # the wrapper's own scaling; the timings below start from it
    out = k4.flash_attention(q, k, v, causal=True)  # the wrapper, as the model calls it
    torch.cuda.synchronize()
    err = close(out, k4.flash_attention_plain(qs, k, v, causal=True), "K4 prefill")
    pairs = b * h * s * (s + 1) / 2  # causal (query, key) pairs
    b_ms, b_by = bound(4.0 * hd * pairs, 2 * (2 * b * h * s * hd + 2 * b * kh * s * hd))
    k4_row = {
        "shape": f"q[{b},{h},{s},{hd}] kv[{b},{kh},{s},{hd}] causal",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: k4._launch(qs, k, v, causal=True, window=None), 50),
        "plain_ms": cuda_ms(lambda: k4.flash_attention_plain(qs, k, v, causal=True), 10),
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(qs, k, v, is_causal=True, scale=1.0, enable_gqa=True), 50
        ),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    print(
        f"K4 prefill: {k4_row['shape']} | max_abs_err {err:.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|) | "
        f"kernel {k4_row['ms']:.4f} ms | "
        f"plain {k4_row['plain_ms']:.4f} ms | SDPA {k4_row['library_ms']:.4f} ms | bound {b_ms:.4f} ms ({b_by})"
    )
    del q, k, v, qs, out

    # 5. K2 and K3 at the training shape: go/x [8, 640, 4096], full, partial
    # and dark 64-row tiles and one expert with no live tile
    # (their own generator: the serving phase below draws its prompts from
    # ``gen`` exactly as it did before these phases existed)
    c = TRAIN_C
    bgen = torch.Generator(device=dev).manual_seed(1)
    x, go = ((torch.randn((e, c, d), generator=bgen, device=dev)).to(torch.bfloat16) for _ in range(2))
    rv = torch.zeros((e, c), dtype=torch.bool, device=dev)
    for i, ct in enumerate([640, 600, 512, 400, 300, 130, 5, 0]):
        rv[i, :ct] = True
    dx = k1.moe_gemm_dgrad(go, x, wg, wu, wd, rv)
    dws = k1.moe_gemm_wgrad(go, x, wg, wu, wd, rv)
    torch.cuda.synchronize()
    err2 = close(dx, k1.moe_gemm_dgrad_plain(go, x, wg, wu, wd, rv), "K2 dgrad")
    occ = k1.tile_occupancy(rv)
    if dx[~occ].abs().max().item() != 0.0:
        fail("K2 dgrad: dark tiles are not exact zeros")
    err3 = max(close_l2(a, b, f"K3 wgrad {n}") for a, b, n in zip(dws, k1.moe_gemm_wgrad_plain(go, x, wg, wu, wd, rv), ("dwg", "dwu", "dwd")))
    dark_experts = ~occ.any(dim=1)
    if not dark_experts.any() or any(g[dark_experts].abs().max().item() != 0.0 for g in dws):
        fail("K3 wgrad: an expert with no live tile must get exact-zero gradients")
    del dx, dws
    rows = int(occ.sum())
    live_experts = int(occ.any(dim=1).sum())
    wbytes = live_experts * 3 * d * f * 2
    b2 = bound(10.0 * d * f * rows, 2 * rows * d * 2 + wbytes + e * c + e * c * d * 2)
    b3 = bound(12.0 * d * f * rows, 2 * rows * d * 2 + wbytes + e * c + e * 3 * d * f * 2)

    def lib_silu_grads():
        a, u = torch.bmm(x, wg).float(), torch.bmm(x, wu).float()
        dh = torch.bmm(go, wd.transpose(1, 2)).float()
        sg = torch.sigmoid(a)
        da = (dh * u * sg * (1 + a * (1 - sg))).to(x.dtype)
        return da, (dh * sg * a).to(x.dtype), (sg * a * u).to(x.dtype)

    def lib_dgrad():
        da, du, _ = lib_silu_grads()
        return torch.bmm(da, wg.transpose(1, 2)) + torch.bmm(du, wu.transpose(1, 2))

    def lib_wgrad():
        da, du, hh = lib_silu_grads()
        xt = x.transpose(1, 2)
        return torch.bmm(xt, da), torch.bmm(xt, du), torch.bmm(hh.transpose(1, 2), go)

    shape = f"go/x[{e},{c},{d}] w[{e},{d},{f}] occupied rows {rows}, live experts {live_experts}"
    k23_rows = {}
    for name, err, kern, plain, lib, (b_ms, b_by) in (
        ("dgrad", err2, k1.moe_gemm_dgrad, k1.moe_gemm_dgrad_plain, lib_dgrad, b2),
        ("wgrad", err3, k1.moe_gemm_wgrad, k1.moe_gemm_wgrad_plain, lib_wgrad, b3),
    ):
        k23_rows[name] = {
            "shape": shape, "max_abs_err": err,
            "ms": cuda_ms(lambda: kern(go, x, wg, wu, wd, rv), 5),
            "plain_ms": cuda_ms(lambda: plain(go, x, wg, wu, wd, rv), 2, warmup=1),
            "library_ms": cuda_ms(lib, 5),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        r = k23_rows[name]
        tol = f"tol {BF16_TOL} + {BF16_TOL}*|plain|" if name == "dgrad" else f"tol {WGRAD_MAX_REL}*max|plain|, rel L2 {WGRAD_REL_L2}"
        print(
            f"K{2 if name == 'dgrad' else 3} {name}: {shape} | max_abs_err {err:.4g} ({tol}) | "
            f"kernel {r['ms']:.3f} ms | plain {r['plain_ms']:.3f} ms | torch.bmm chain {r['library_ms']:.3f} ms | "
            f"bound {b_ms:.3f} ms ({b_by})"
        )

    # K3b: its own path, moe_gemm with no occupancy table (every row live),
    # forward and backward through autograd, counts reset just before
    leaves = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
    reset_counts()
    out = k1.moe_gemm_ungrouped(*leaves)
    out.backward(go)
    torch.cuda.synchronize()
    k3b_path = read_counts()
    expect = dict.fromkeys(COUNTED, 0)
    expect.update(moe_gemm_ungrouped=1, moe_gemm_grouped_dgrad=1, moe_gemm_grouped_wgrad=1)
    if k3b_path != expect:
        fail(f"K3b path launches {k3b_path}, expected {expect}: one K3b forward and one K2/K3 backward")
    all_live = torch.ones((e, c), dtype=torch.bool, device=dev)
    err3b = close(out.detach(), k1.moe_gemm_plain(x, wg, wu, wd), "K3b ungrouped forward")
    for leaf, want, n in zip(leaves, k1.moe_gemm_bwd_plain(go, x, wg, wu, wd, all_live), ("dx", "dwg", "dwu", "dwd")):
        (close if n == "dx" else close_l2)(leaf.grad, want, f"K3b backward {n}")
    del leaves, out
    b_ms, b_by = bound(6.0 * d * f * e * c, 2 * e * c * d * 2 + e * 3 * d * f * 2)

    def lib_swiglu():
        return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

    k3b_row = {
        "shape": f"x[{e},{c},{d}] w[{e},{d},{f}] every row live",
        "max_abs_err": err3b,
        "ms": cuda_ms(lambda: k1._launch(x, wg, wu, wd, all_live), 5),
        "plain_ms": cuda_ms(lambda: k1.moe_gemm_plain(x, wg, wu, wd), 2, warmup=1),
        "library_ms": cuda_ms(lib_swiglu, 5),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    print(
        f"K3b ungrouped: {k3b_row['shape']} | max_abs_err {err3b:.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|) | "
        f"kernel {k3b_row['ms']:.3f} ms | plain {k3b_row['plain_ms']:.3f} ms | torch.bmm SwiGLU {k3b_row['library_ms']:.3f} ms | "
        f"bound {b_ms:.3f} ms ({b_by}) | its path's launches {k3b_path}"
    )
    del x, go, wg, wu, wd, rv, all_live
    torch.cuda.empty_cache()

    # 6. serve: full-width Mixtral-8x7B, 4 layers, scheduled MoE path
    mcfg = dataclasses.replace(
        cfg, n_layers=LAYERS, moe=dataclasses.replace(cfg.moe, dispatch="phase_pipelined", use_pallas=True)
    )
    t0 = time.perf_counter()
    model = Model(mcfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {mcfg.name} {LAYERS} layers, {n_params / 1e9:.2f} B params, init {time.perf_counter() - t0:.1f} s")

    reset_counts()
    res = serve(
        model, batch=BATCH, prompt_len=PROMPT, new_tokens=NEW_TOKENS, rounds=ROUNDS,
        controller=True, virtual_ranks=VIRTUAL_RANKS, seed=0,
    )
    launches = read_counts()
    expect = dict.fromkeys(COUNTED, 0)
    expect.update(moe_gemm_grouped=ROUNDS * (1 + NEW_TOKENS) * LAYERS, flash_attention_fwd=ROUNDS * LAYERS)
    for r in range(ROUNDS):
        print(
            f"serve round {r}: plan {res.plan_ms[r]:.1f} ms | prefill {res.prefill_ms[r]:.1f} ms "
            f"({BATCH * PROMPT / res.prefill_ms[r] * 1e3:.0f} tok/s) | decode {res.decode_ms[r]:.1f} ms "
            f"({res.decode_tok_s(BATCH, NEW_TOKENS)[r]:.1f} tok/s, {res.decode_ms[r] / NEW_TOKENS:.2f} ms/step)"
        )
    print(f"serve launches: {launches} (expected {expect})")
    print(
        f"serve MoE stats: routed {res.routed:.0f}, admitted {res.admitted:.0f}, dropped {res.dropped:.0f} "
        f"(table caps {res.table.caps[0].tolist()}, envelope {list(res.table.envelope)})"
    )
    if launches != expect:
        fail(f"serving path launches {launches}, expected {expect}")
    if res.tokens.shape != (ROUNDS, BATCH, NEW_TOKENS) or int(res.tokens.min()) < 0 or int(res.tokens.max()) >= cfg.vocab_size:
        fail(f"generated tokens out of range or misshapen: {tuple(res.tokens.shape)}")
    if res.first_logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(res.first_logits).all():
        fail("prefill logits misshapen or non-finite")
    if not 0 < res.admitted <= res.routed or res.dropped < 0:
        fail(f"MoE stats inconsistent: routed {res.routed}, admitted {res.admitted}, dropped {res.dropped}")

    # kernel path vs plain path on the card: the same prompts through prefill
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)

    def prefill_logits():
        caches = model.init_cache(BATCH, PROMPT)
        return model.prefill(prompts, caches, schedule=res.table)[0].float()

    kernel_logits = prefill_logits()

    def plain_flash(q, k, v, *, causal=True, window=None):
        return k4.flash_attention_plain(q * (q.shape[-1] ** -0.5), k, v, causal=causal, window=window)

    with mock.patch.object(k1, "moe_gemm", k1.moe_gemm_plain), mock.patch.object(k4, "flash_attention", plain_flash):
        plain_logits = prefill_logits()
    rel = ((kernel_logits - plain_logits).norm(dim=-1) / plain_logits.norm(dim=-1)).max().item()
    max_abs = (kernel_logits - plain_logits).abs().max().item()
    same_top1 = int((kernel_logits.argmax(-1) == plain_logits.argmax(-1)).sum())
    print(
        f"prefill logits kernel vs plain path: max row rel L2 {rel:.3g} (tol {LOGITS_REL_TOL}), "
        f"max abs {max_abs:.3g}, same argmax {same_top1}/{BATCH}"
    )
    if not torch.isfinite(kernel_logits).all() or rel > LOGITS_REL_TOL:
        fail(f"prefill logits of the kernel path differ from the plain path: rel L2 {rel:.3g}")

    del model, prompts, kernel_logits, plain_logits
    torch.cuda.empty_cache()

    # 7. one train step at 1 layer, full width: kernel path vs plain path
    tcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="phase_pipelined", use_pallas=True))
    from repro_torch.data import DataConfig, SyntheticStream

    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batch = {key: torch.from_numpy(val).to(dev) for key, val in stream.batch(0).items()}
    one = Model(dataclasses.replace(tcfg, n_layers=1), device=dev, param_dtype=torch.float32, requires_grad=True, seed=1)
    one_table = plan_table(one.cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, virtual_ranks=VIRTUAL_RANKS, device=dev)

    def loss_and_grads():
        for prm in one.parameters():
            prm.grad = None
        loss = one.loss(batch, schedule=one_table)
        loss.backward()
        return loss.item(), {n: prm.grad.detach().clone() for n, prm in one.named_parameters()}

    reset_counts()
    k_loss, k_grads = loss_and_grads()
    step_counts = read_counts()
    with mock.patch.object(k1, "_forward", k1.moe_gemm_plain), mock.patch.object(k1, "_backward", k1.moe_gemm_bwd_plain):
        p_loss, p_grads = loss_and_grads()
    worst = max(
        ((k_grads[n] - p_grads[n]).norm() / p_grads[n].norm().clamp_min(1e-30)).item() for n in p_grads
    )
    print(
        f"train step, 1 layer, kernel vs plain path: loss {k_loss:.6f} vs {p_loss:.6f}, "
        f"max leaf rel L2 {worst:.3g} (tol {GRAD_REL_TOL}), kernel-path launches {step_counts}"
    )
    if not (math.isfinite(k_loss) and abs(k_loss - p_loss) <= GRAD_REL_TOL * abs(p_loss)) or not worst <= GRAD_REL_TOL:
        fail(f"1-layer train step: kernel path differs from the plain path (loss {k_loss} vs {p_loss}, grad rel L2 {worst})")
    if step_counts["moe_gemm_grouped"] != 2 or step_counts["moe_gemm_grouped_dgrad"] != 1 or step_counts["moe_gemm_grouped_wgrad"] != 1:
        fail(f"1-layer train step launches {step_counts}: expected K1 twice (remat) and K2/K3 once")
    del one, k_grads, p_grads
    torch.cuda.empty_cache()

    # 8. train full-width Mixtral-8x7B cut to 2 layers (the slice's main path)
    mcfg = dataclasses.replace(tcfg, n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    model = Model(mcfg, device=dev, param_dtype=torch.float32, requires_grad=True, seed=0)
    torch.cuda.synchronize()
    n_params = sum(prm.numel() for prm in model.parameters())
    print(f"train model: {mcfg.name} {TRAIN_LAYERS} layers, {n_params / 1e9:.3f} B params (f32 masters), "
          f"remat {mcfg.remat}, init {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tres = train(model, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, virtual_ranks=VIRTUAL_RANKS,
                 peak_lr=PEAK_LR, warmup=WARMUP)
    train_launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, (ls, gn, ms, tps) in enumerate(zip(tres.losses, tres.grad_norms, tres.step_ms, tres.tokens_per_s())):
        print(f"train step {i}: loss {ls:.4f} | grad norm {gn:.4f} | {ms:.1f} ms | {tps:.0f} tok/s")
    print(f"train peak memory allocated: {peak_gb:.2f} GB | table caps {tres.table.caps[0].tolist()}, "
          f"envelope {list(tres.table.envelope)}")
    expect = dict.fromkeys(COUNTED, 0)
    expect.update(
        moe_gemm_grouped=2 * TRAIN_LAYERS * TRAIN_STEPS,  # forward + remat recompute
        moe_gemm_grouped_dgrad=TRAIN_LAYERS * TRAIN_STEPS, moe_gemm_grouped_wgrad=TRAIN_LAYERS * TRAIN_STEPS,
    )
    print(f"train launches: {train_launches} (expected {expect})")
    if train_launches != expect:
        fail(f"training path launches {train_launches}, expected {expect}")
    if not all(math.isfinite(v) for v in tres.losses):
        fail(f"non-finite training loss: {tres.losses}")
    if not (tres.losses[-1] + tres.losses[-2]) / 2 < tres.losses[0]:
        fail(f"training loss did not fall: {tres.losses}")

    # where the time of one more train step goes: a torch.profiler trace of
    # the device's kernels (one stream, so their times add up to busy time)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = train(model, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ, virtual_ranks=VIRTUAL_RANKS, peak_lr=PEAK_LR, warmup=WARMUP)
    kernel_us: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernel_us.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    busy_ms = sum(sum(v) for v in kernel_us.values()) / 1e3
    step_ms = traced.step_ms[0]
    if kernel_us:
        print(f"train step trace: {step_ms:.1f} ms wall, device busy {busy_ms:.1f} ms ({100 * busy_ms / step_ms:.1f}%), "
              f"{sum(len(v) for v in kernel_us.values())} kernel launches")
        groups = {  # first match wins: the wgrad kernels' names contain K1's
            "K2/K3 silu_grads": ("silu_grads_kernel",), "K2 dgrad": ("dgrad_kernel",),
            "K3 wgrad": ("wgrad_gate_up_kernel", "wgrad_down_kernel"), "K1 gate_up": ("gate_up_kernel",),
            "K1 down": ("down_kernel",), "cuBLAS GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
            "elementwise and reductions": ("elementwise", "reduce", "copy", "Fill", "index", "scatter", "gather",
                                           "sort", "softmax", "cumsum", "cat", "where"),
        }
        totals: dict[str, list] = {}
        for name, v in kernel_us.items():
            group = next((g for g, keys in groups.items() if any(k in name for k in keys)), "other")
            totals.setdefault(group, []).extend(v)
        for group, v in sorted(totals.items(), key=lambda kv: -sum(kv[1])):
            print(f"  {sum(v) / 1e3:8.2f} ms  x{len(v):<5d} {group}")
    else:
        print(f"train step trace: {step_ms:.1f} ms wall, device busy not measured (the profiler recorded no device events)")
    del model
    torch.cuda.empty_cache()

    # 9. the kernels line, then the result line
    path_launches = {name: {"serve": launches[name], "train": train_launches[name]} for name in COUNTED}
    kernels = [
        dict(
            name="moe_gemm_grouped", route="cuda", source="src/repro_torch/csrc/moe_gemm.cu",
            replaces="src/repro/kernels/moe_gemm/kernel.py:101",
            launches=launches["moe_gemm_grouped"] + train_launches["moe_gemm_grouped"],
            launches_by_path=path_launches["moe_gemm_grouped"],
            **{key: k1_rows["prefill"][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            shape=k1_rows["prefill"]["shape"], decode=k1_rows["decode"],
        ),
        dict(
            name="flash_attention_fwd", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:77", launches=launches["flash_attention_fwd"],
            launches_by_path=path_launches["flash_attention_fwd"],
            **{key: k4_row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            shape=k4_row["shape"],
        ),
        *(
            dict(
                name=f"moe_gemm_grouped_{name}", route="cuda", source="src/repro_torch/csrc/moe_gemm_bwd.cu",
                replaces=f"src/repro/kernels/moe_gemm/kernel.py:{line}",
                launches=train_launches[f"moe_gemm_grouped_{name}"],
                launches_by_path=path_launches[f"moe_gemm_grouped_{name}"],
                **{key: k23_rows[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
            )
            for name, line in (("dgrad", 272), ("wgrad", 327))
        ),
        dict(
            name="moe_gemm_ungrouped", route="cuda", source="src/repro_torch/csrc/moe_gemm.cu",
            replaces="src/repro/kernels/moe_gemm/kernel.py:394", launches=k3b_path["moe_gemm_ungrouped"],
            launches_by_path={"ungrouped forward + backward": k3b_path["moe_gemm_ungrouped"], "serve": 0, "train": 0},
            **{key: k3b_row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        ),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()

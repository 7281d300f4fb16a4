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
5. serve full-width Mixtral-8x7B cut to 4 layers (random weights from a
   seed) through the scheduled MoE path: plan a table, prefill, greedy
   decode, 2 rounds; the kernels' launch counts are reset just before and
   read just after, and the prefill logits of the kernel path are held
   against the plain path on the card.

It prints a ``kernels`` JSON line, then, last, ``{"ok": true, "device":
...}``.  Any failure exits non-zero before that line.
"""

from __future__ import annotations

import dataclasses
import json
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
LOGITS_REL_TOL = 2e-2  # per-row relative L2 error of the 4-layer prefill logits, kernel vs plain path

# serving shape: the slice's main path
BATCH, PROMPT, NEW_TOKENS, ROUNDS, LAYERS, VIRTUAL_RANKS = 4, 256, 32, 2, 4, 8


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

    def close(out, ref, what: str) -> float:
        out, ref = out.float(), ref.float()
        if not torch.isfinite(out).all():
            fail(f"{what}: non-finite output")
        err = (out - ref).abs()
        worst = float((err - BF16_TOL * ref.abs()).max())
        if worst > BF16_TOL:
            fail(f"{what}: max |kernel - plain| {float(err.max()):.4g} beyond {BF16_TOL} + {BF16_TOL}*|plain|")
        return float(err.max())

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
    del wg, wu, wd, x, out
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

    # 5. serve: full-width Mixtral-8x7B, 4 layers, scheduled MoE path
    mcfg = dataclasses.replace(
        cfg, n_layers=LAYERS, moe=dataclasses.replace(cfg.moe, dispatch="phase_pipelined", use_pallas=True)
    )
    t0 = time.perf_counter()
    model = Model(mcfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {mcfg.name} {LAYERS} layers, {n_params / 1e9:.2f} B params, init {time.perf_counter() - t0:.1f} s")

    k1.moe_gemm.launches = 0
    k4.flash_attention.launches = 0
    res = serve(
        model, batch=BATCH, prompt_len=PROMPT, new_tokens=NEW_TOKENS, rounds=ROUNDS,
        controller=True, virtual_ranks=VIRTUAL_RANKS, seed=0,
    )
    launches = {"moe_gemm_grouped": k1.moe_gemm.launches, "flash_attention_fwd": k4.flash_attention.launches}
    expect = {"moe_gemm_grouped": ROUNDS * (1 + NEW_TOKENS) * LAYERS, "flash_attention_fwd": ROUNDS * LAYERS}
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
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was never launched on the serving path")
        if n != expect[name]:
            fail(f"{name} launched {n} times on the serving path, expected {expect[name]}")
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

    # 6. the kernels line, then the result line
    kernels = [
        dict(
            name="moe_gemm_grouped", route="cuda", source="src/repro_torch/csrc/moe_gemm.cu",
            replaces="src/repro/kernels/moe_gemm/kernel.py:101", launches=launches["moe_gemm_grouped"],
            **{key: k1_rows["prefill"][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            shape=k1_rows["prefill"]["shape"], decode=k1_rows["decode"],
        ),
        dict(
            name="flash_attention_fwd", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:77", launches=launches["flash_attention_fwd"],
            **{key: k4_row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            shape=k4_row["shape"],
        ),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this
file; imports nothing of JAX or of the JAX package.  Phases, in order:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print each kernel's registers, stack, spills
   and static shared memory from ``ptxas -v`` (a spill in a wgmma kernel
   fails the run);
3. K1 (grouped SwiGLU) and 4. K4 (flash attention) against their plain
   PyTorch versions at the serving path's full-width shapes, with the
   kernel's time beside the plain version's, one PyTorch library call's
   and the least time the card could take (``bound``), and K1's host time
   per call at decode with the cost of one tensor-map encode; K4 also as
   the model calls it (the wrapper on the
   transposed [B, S, H, D] views with the pre-scaled q, ``prescale``
   inside) beside SDPA called the same way, with both calls' host time;
5. K2 (dgrad) and K3 (wgrad) at the training shape, the same way, each
   of their launches (recompute, dgrad, wgrad) timed alone (the dgrad
   launch beside ``torch.baddbmm`` on the same da/du and its own bound), and K3b (the
   ungrouped forward): its own path, forward and backward through
   autograd, counted and held against the plain versions;
5b. the knee (``repro_torch.launch.simulate``): K1's device time (CUDA
   events over back-to-back launches, rotating over 4 copies of the
   weights) and per-call time (a synchronize after each call, the median)
   against the tokens b on one of 8 virtual ranks of Mixtral-8x7B (1
   expert of 4096 x 14336), DBRX (2 of 6144 x 10752) and Qwen3-MoE (16 of
   4096 x 1536), b = 1 ... 16384, each fitted with ``fit_knee``; it fails
   on a time that is not finite and positive, on a fit whose slope is
   not positive, and unless K1 holds against its plain version at each
   router's b = 4096 point; then Mixtral's Fig. 3 (``mmlu``) and Fig. 4
   (``speed``) tables under the fitted device-time model and under the
   paper's ``knee_model()``, with fig3's two ratios;
6. serve full-width Mixtral-8x7B cut to 4 layers (random weights from a
   seed) through the scheduled MoE path: the controller plans a table
   (drift "none": a cold plan in round 0, kept in round 1), prefill,
   greedy decode, 2 rounds; the kernels' launch counts are reset just
   before and read just after; then, on three prompt sets, K1 and K4 are held
   against their plain versions on every layer's own inputs inside a bf16
   prefill and the prefill logits of the kernel path against the plain
   path within the larger of ``LOGITS_REL_TOL`` and twice the bf16 noise
   floor measured in the same run on the same prompts (a prompt set whose
   floor alone exceeds ``LOGITS_REL_TOL`` is marked uninformative); then
   the same prefill of the seeded model in f32 on the three prompt sets,
   K1 and K4 on bf16-rounded inputs in both paths and the plain path's
   routing replayed in the kernel path, within ``LOGITS_REL_TOL``
   (this check comes after 6b);
6b. serve the same model under drift (``shift``, ``hotspot``, ``skew``;
   4 rounds of 8 new tokens each), the controller re-planning between
   rounds: after each round the device table must equal a host runtime's
   fed the same estimates, a swap inside the envelope must keep the
   table's tensors (``data_ptr``), ``shift`` and ``hotspot`` must
   re-plan after round 0, K1 must launch rounds x (1 + new tokens) x
   layers times and K4 rounds x layers times (every other kernel 0);
   then, under ``shift``'s last table, the bf16 check of 6 (K1 and K4
   held per layer, logits kernel vs plain path);
6c. serve the same model through ``repro_torch.serve.ServeEngine`` (the
   JAX drift run's knobs: 8 decode slots, buckets 64/128/256, a 4-entry
   regime library): three phases of 24 requests (prompts of 17-257 tokens
   from two token pools probed on the seeded layer-0 router, 8-24 new
   tokens, one arrival a decode step), A, then ``capture_regime``, B, A2.
   Decode is one CUDA graph under the device controller.  It fails unless
   every request completes unrejected; one graph serves the whole run and
   all three buckets are prefilled; a CPU twin of the controller, fed the
   routing the engine copied to the host, ends each phase in the same
   state (integer and bool leaves exactly, f32 within 1e-6); a cold
   re-plan fires on the card; the replay equals the eager step function on
   copies of its inputs, bit for bit, at each phase's first step, until
   the first re-plan and at the step after the first cold re-plan, with K1
   held against its plain version in every layer of those eager steps; the
   first batch-1 prefill of each bucket, run again with K1 and K4 held in
   every layer, gives the served row bit for bit; 8 slots at ragged
   depths through one [B]-step decode equal each row's scalar decode at
   the same width (its cache in every slot) bit for bit; and K1 launches
   layers x (prefills + decode steps + the capture's warm-up step), K4
   layers x prefills, every other kernel 0 (a replay counts the launches
   its capture recorded).  It prints
   each phase's serving numbers, decode ms/step (graph) beside eager steps
   on the same inputs, prefill ms per bucket, the controller's metrics and
   each re-plan's ms;
6d. serve full-width Qwen3-MoE-235B-A22B (128 experts top-8, F 1536,
   head_dim 128 over d 4096, 64/4 heads) and DBRX-132B (16 experts top-4,
   F 10752, d 6144, 48/8 heads), each cut to 2 layers, through ``serve``
   (batch 4, prompt 256, 8 new tokens, 2 rounds, controller on,
   ``phase_pipelined``): launch counts exact, tokens in range, logits
   finite, a cold plan in round 0 kept in round 1 and equal to a host
   runtime's, and K1 and K4 held against their plain versions on every
   layer's own inputs inside a bf16 prefill; each model freed before the
   next.  Then one full-width Mixtral MoE layer (4 x 256 tokens) under the
   serving controller's first table row with ``wire_dtype`` bf16, fp8 and
   int8: K1 held on the layer's own (dequantized) slots, the layer's
   kernel path within K1's tolerance and one codec step of its plain
   path, the routing and drop stats equal to the bf16 wire's bit for bit,
   slots on the wire, and an error against the bf16 wire above 0 and
   within ``WIRE_REL_TOL`` of the bf16 output's max magnitude; it prints
   the QDQ's time beside K1's on the packed buffer and the dispatch bytes
   a token (8192, 4100, 4100);
7. one training step of full-width Mixtral at 1 layer, kernel path
   against plain path: loss and every gradient;
8. train full-width Mixtral-8x7B cut to 2 layers (f32 masters, bf16
   compute, remat per block, AdamW) for a few steps of synthetic data
   under the launcher's lossless table; counts reset just before and read
   just after; the loss must be finite and fall; then one more step runs
   under ``torch.profiler`` and its device time is printed by kernel group;
   then K4's and SDPA's device times at the prefill shape,
   one more 4-layer Mixtral prefill, and 6c's engine on the same model (a
   short run, graph replays, one prefill per bucket), each from a trace
   (kept after the timed serving and training: a profiler session slows
   the host's later launches);
8b. (run between 7 and 8) the fault-tolerant loop, ``train_loop``, on
   full-width Mixtral-8x7B cut to 1 layer at 1 x 2048 tokens (so the
   chunked attention runs): the fused device-controller step under
   ``plan_controller``'s controller, ef8, AdamW (peak 3e-4, warmup 2,
   cosine over 10 steps), checkpoints every 5 steps keeping 1 in a
   temporary directory under memory-backed ``/dev/shm`` where the machine
   has one (three 27.4 GB checkpoints outrun a 45 GiB disk-write budget;
   removed at the end; its free space, and the host memory it lives in,
   must hold two checkpoints + 10%), one fault injected at step 7, then a second call
   resuming to step 12.  Before the loop, ``attn_chunked`` is held
   against ``attn_full`` on layer 0's inputs (output and gradients, f32
   and bf16) and ef8 on the card against the CPU bit for bit on a slice
   of one step's gradients.  It fails unless: one failure; the history's
   steps unique, sorted and complete; final steps 10 and 12; the
   checkpoints on disk those steps; the resumed parameters equal the
   checkpoint's arrays bit for bit; replayed steps 5-6 give the first
   pass's losses wherever their tables were the same (the controller's
   cooldown is 10 steps, so they are), and at least one replayed step
   was compared (the count is printed); the losses finite and
   falling; K1/K2/K3 launched 2/1/1 times for every executed step
   (replays included), every other kernel 0; peak memory under 80 GB.
   It prints each step's ms and tokens/s, each checkpoint's blocking
   snapshot ms and background write s and GB/s, each restore's s, the
   controller's re-plans and drop fraction, and the phase's wall time;
   one more fused ef8 step of this model is traced after phase 8's trace;
9. K5 (the WKV6 recurrence) against its plain version at the RWKV6-7B
   prefill shape (r/k/v [4, 64, 1024, 64] bf16) from S = 0, and at T = 1
   and T = 37 from a carried state, with its time, the plain version's
   and the bound (5 D^2 f32 FLOP per step and head; no PyTorch call
   computes it: library none);
10. serve full-width RWKV6-7B at all 32 layers (random weights from a
   seed; no MoE, so no table): prefill and greedy decode, 2 rounds;
   launch counts reset just before and read just after (K5 once per layer
   per prefill and per decode step, every other kernel 0 times); then, at
   a shorter prompt, K5 held against its plain version on every layer's
   own inputs inside the bf16 prefill, the bf16 logits of the kernel path
   held against the plain path within twice the bf16 noise floor measured
   in the same run, one more
   prefill and 8 decode steps under ``torch.profiler`` (device time by
   kernel group), and the prefill logits of the kernel path held against
   the plain path on the same seeded model in f32.

It prints K4's extra numbers and K2's/K3's per-launch times (with the
dgrad launch's library time and bound) one a line beside the card's name
and power limit, a ``kernels`` JSON line, then,
last, ``{"ok": true, "device":
...}``.  Any failure exits non-zero before that line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
from unittest import mock

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core peak, f32 peak outside the tensor cores, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
BF16_TOL = 2e-2  # kernel vs plain, |diff| <= TOL + TOL * |plain| (both f32-accumulated; bf16 rounding)
# K3 (wgrad) vs plain: relative L2 per output <= WGRAD_REL_L2 and max |diff| <= WGRAD_MAX_REL * max |plain|.
# Kernel and plain version each round their own f32 da/du/h to bf16 before the products; the two f32
# accumulation orders put 0.4-0.6% of those elements one bf16 ulp apart (up to 0.03 at |da| ~ 8), and
# a flipped element times |x| up to ~4 moves a weight gradient of |p| ~ 1 by ~0.13, so the elementwise
# bound above does not hold for K3 at this shape (measured: rel L2 5.8e-4, max |diff| 0.5 at max |plain| 100).
WGRAD_REL_L2, WGRAD_MAX_REL = 2e-3, 2e-2
# Mixtral prefill logits, kernel vs plain path, per-row relative L2 (4 layers, bf16).  A changed f32 sum order
# in K1 can flip one bf16 rounding and with it a top-2 routing choice, which moves the logits by far more than
# the kernel's own error; so K1 is held against its plain version on each layer's own inputs, and the logits
# within the larger of LOGITS_REL_TOL and MIXTRAL_BF16_NOISE_MULT times the noise floor measured in the same
# run: the plain path against itself with the f32 down product scaled by 1 + 1e-7 N(0, 1) before its rounding.
LOGITS_REL_TOL = 2e-2
MIXTRAL_BF16_NOISE_MULT = 2.0
MIXTRAL_EXTRA_PROMPT_SEEDS = (5, 6)  # the check runs on the serving generator's prompts and on these two seeds
# RWKV6 prefill logits, kernel vs plain path, per-row relative L2.  In f32 only the order of the 64-term sums
# inside the recurrence differs (measured 4.04e-5 at 32 layers).  In bf16 one flipped rounding spreads through
# all 32 random-weight layers, so the kernel path is held to a multiple of the noise floor measured in the
# same run: the plain path against itself with y scaled by 1 + 1e-7 N(0, 1), a sum-order-sized change.
RWKV_F32_LOGITS_TOL = 1e-3
RWKV_BF16_NOISE_MULT = 2.0

# K4's numbers beyond the common keys: device times from a trace, the call as attn_flash makes it, host time
K4_EXTRA_KEYS = (
    "device_ms", "library_device_ms", "model_call_ms", "model_call_library_ms", "host_us_per_call",
    "library_host_us_per_call",
)

GRAD_REL_TOL = 2e-2  # per-leaf relative L2 of the 1-layer train-step gradients, kernel vs plain path

# serving shape: the first slice's path
BATCH, PROMPT, NEW_TOKENS, ROUNDS, LAYERS, VIRTUAL_RANKS = 4, 256, 32, 2, 4, 8
# serving under drift: the controller's path, the same model, 4 rounds of 8 new tokens per scenario
DRIFT_KINDS, DRIFT_ROUNDS, DRIFT_NEW_TOKENS = ("shift", "hotspot", "skew"), 4, 8
# training shape: the second slice's path (C = round8(ceil(2048 * 2 / 8 * 1.25)) = 640 slots per expert)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAYERS, TRAIN_STEPS, TRAIN_C = 8, 256, 2, 8, 640
PEAK_LR, WARMUP = 3e-4, 2
# RWKV6-7B serving shape: the third slice's path, full width and all 32 layers
RWKV_BATCH, RWKV_PROMPT, RWKV_NEW, RWKV_ROUNDS, RWKV_CHECK_PROMPT = 4, 1024, 32, 2, 256
# K5 vs plain: both f32 throughout (bf16 r/k/v widened first); only the order of the 64-term sums differs
WKV_TOL = 1e-4
# serving through the engine (phase 6c): the knobs of the JAX drift run (tests/test_serve.py, _drift_run) at
# full width; per phase 24 requests, prompts of 17-257 tokens (all three buckets), 8-24 new tokens, one arrival
# a decode step on average; prompts from two token pools of the seeded router
ENGINE_KW = dict(
    decode_slots=8, max_len=320, buckets=(64, 128, 256), n_ranks=8, regime_slots=4, regime_threshold=0.3,
    drop_tolerance=0.01, hysteresis_steps=1, cooldown=2, ema=0.8, host_observe_every=14,
    plan_overrides=dict(quantum=1, min_cap=1, slack=1.0),
)
ENGINE_REQUESTS, ENGINE_PROMPT, ENGINE_NEW, ENGINE_SEED = 24, (17, 258), (8, 25), 6
ENGINE_HOT, ENGINE_POOL = (6, 7), 64
ENGINE_SLOT_PROMPTS = (17, 40, 63, 96, 129, 170, 220, 257)  # the per-slot check's ragged depths (prompt lengths)
# the fault-tolerant train loop (phase 8b): full-width Mixtral-8x7B cut to 1 layer, 1 x 2048 tokens (so the
# chunked attention runs; the MoE shape of phases 5 and 7: C = 640), the fused device-controller step with ef8,
# checkpoints every 5 steps keeping 1, one injected fault at step 7, then a second call resuming to step 12
LOOP_BATCH, LOOP_SEQ, LOOP_LAYERS, LOOP_STEPS, LOOP_RESUME_STEPS = 1, 2048, 1, 10, 12
LOOP_CKPT_EVERY, LOOP_KEEP, LOOP_FAULT_AT, LOOP_SEED = 5, 1, 7, 3
# the device controller's cooldown in steps: it re-plans at step 1 (the primed plan does not fit the
# random-weight router), and a 10-step cooldown keeps the checkpoint-to-fault window (steps 5-6) and its
# replay under one table, so the replay check compares like with like (the default 5 re-planned at step 6)
LOOP_COOLDOWN = 10
# attn_chunked vs attn_full on one layer's inputs, relative L2 of the output and of each gradient: in f32
# only the sum order differs; in bf16 (the training dtype) the two round p at different points (unnormalized
# in blocks vs normalized), so the bf16 check takes GRAD_REL_TOL
CHUNKED_F32_TOL = 1e-5
LOOP_PEAK_GB = 80.0

# phase 6d: Qwen3-MoE-235B-A22B and DBRX-132B at full width, ARCH_LAYERS layers, batch and prompt of phase 6
ARCHS, ARCH_LAYERS, ARCH_NEW = ("qwen3-moe-235b-a22b", "dbrx-132b"), 2, 8
# the wire codecs' error against the bf16 wire, relative to the bf16 output's max magnitude.  It is the codecs'
# rounding on both legs: fp8 e4m3 keeps 3 mantissa bits (half an ulp is 2^-4 relative), int8 half a step of a
# slot's amax / 127 with amax ~4 sigma over 4096 features; measured 0.049 / 0.013 on a 1024-wide layer on the
# CPU, so the limits leave about 2x
WIRE_REL_TOL = {"fp8": 0.1, "int8": 0.03}
# the knee (phase 5b): the routers whose virtual rank K1 is profiled at full width (8 ranks: 1 expert of
# 4096 x 14336, 2 of 6144 x 10752, 16 of 4096 x 1536), the batch at which K1 is held against its plain version
KNEE_ROUTERS, KNEE_CHECK_B = ("mixtral-8x7b", "dbrx", "qwen3-moe"), 4096

# the engine's traced run (after the timed phases): 8 requests at once, prompts in all three buckets
ENGINE_TRACE_PROMPTS, ENGINE_TRACE_NEW, ENGINE_TRACE_REPLAYS = (40, 100, 200, 60, 120, 240, 30, 250), 16, 5


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """Least time in ms for the work: the larger of bytes over the memory
    rate and operations over the peak for their type (default bf16)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tables_equal(a, b) -> bool:
    """Two ScheduleTables hold the same leaves (compared on the host) and envelope."""
    return a.envelope == b.envelope and all(
        getattr(a, name).cpu().equal(getattr(b, name).cpu()) for name in ("perms", "caps", "valid", "offsets", "n_phases")
    )


def kernel_ident(name: str) -> str:
    """The function name of a profiler kernel event: ``k4_flash_fwd_kernel``
    from ``void (anonymous namespace)::k4_flash_fwd_kernel<128>(CUtensorMap_st, ...)``;
    the whole name if it has no argument list."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return m.group(1) if m else name


def tensor_map_encode_us(t, reps: int = 2000) -> float:
    """Host microseconds of one ``cuTensorMapEncodeTiled`` (the driver's,
    through ctypes, so a little more than from C) for the 3-D bf16 map with
    128-byte swizzle that ``csrc/moe_gemm.cu`` makes of the [E, C, d] tensor ``t``."""
    import ctypes

    enc = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    enc.argtypes = [ctypes.c_void_p, ctypes.c_int, u32, ctypes.c_void_p, ctypes.POINTER(u64), ctypes.POINTER(u64),
                    ctypes.POINTER(u32), ctypes.POINTER(u32), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    enc.restype = ctypes.c_int
    raw = ctypes.create_string_buffer(128 + 64)  # a CUtensorMap is 128 bytes, 64-byte aligned
    e, c, d = t.shape
    args = (
        (ctypes.addressof(raw) + 63) & ~63, 9, 3, t.data_ptr(),  # CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank 3
        (u64 * 3)(d, c, e), (u64 * 2)(d * 2, c * d * 2), (u32 * 3)(64, 128, 1), (u32 * 3)(1, 1, 1),
        0, 3, 3, 0,  # no interleave, 128-byte swizzle, 256-byte L2 promotion, zero fill
    )
    if enc(*args) != 0:
        fail("cuTensorMapEncodeTiled refused the K1 map")
    t0 = time.perf_counter()
    for _ in range(reps):
        enc(*args)
    return (time.perf_counter() - t0) / reps * 1e6


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
    from repro_torch.kernels.rwkv_wkv import ops as k5
    from repro_torch.core import ComputeModel, ScheduleRuntime, knee_model, make_serving_controller
    from repro_torch.core.schedule import TABLE_LEAVES
    from repro_torch.launch import simulate
    from repro_torch.launch.serve import controller_line, demand_estimate, serve
    from repro_torch.launch.train import plan_table, train
    from repro_torch.models import Model
    from repro_torch.models import moe as moe_layer
    from repro_torch.core.cost_models import MIN_SLOPE_US, wire_bytes_per_token
    from repro_torch.parallel.fabric import DenseFabric, FabricContext, get_codec

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
    wgmma_kernels = ("k1_", "k23_", "k2_", "k3_", "k4_")  # the warp-specialised wgmma kernels
    for name in build.SOURCES:
        for k in build.ptxas_kernels(name):
            print(f"  {name}: {k['kernel']}: {k['registers']} registers, {k.get('stack_frame', 0)} B stack, "
                  f"{k.get('spill_stores', 0)} B spill stores, {k.get('spill_loads', 0)} B spill loads, "
                  f"{k['static_smem']} B static shared memory")
            if k["kernel"].startswith(wgmma_kernels) and (k.get("spill_stores", 0) or k.get("spill_loads", 0)):
                fail(f"{k['kernel']} spills registers")
        for line in build.ptxas_report(name).splitlines():
            if re.search(r"\(C75\d\d\)", line):
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

    def graph_ms(fn, reps: int) -> float:
        """ms a call of ``fn`` with the host's launch cost out of the way:
        ``reps`` calls captured as one CUDA graph (after two on a side
        stream), timed with CUDA events around a replay after an untimed one."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) / reps

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    elementwise = ("elementwise", "reduce", "copy", "Fill", "index", "scatter", "gather", "sort", "softmax",
                   "cumsum", "cat", "where")
    cublas = ("gemm", "nvjet", "cutlass", "xmma")

    def device_ms(fn, reps: int = 20) -> tuple[float | None, list]:
        """Device time per call of ``fn`` from a trace: every kernel it
        launches, summed (a library call may launch more than one), and the
        names of those kernels."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        names = sorted({kernel_ident(ev.name) for ev in evs})
        return (sum(ev.time_range.elapsed_us() for ev in evs) / reps / 1e3 if evs else None), names

    def trace_report(prof, wall_ms: float, what: str, groups: dict) -> dict:
        """Print the device busy share and device time by kernel group;
        returns group -> kernel times in us.  A group names its kernels
        exactly (a set of function names, ``kernel_ident``) or by
        substrings of the full name (a tuple); exact names match first,
        then the first group with a matching substring."""
        kernel_us: dict[str, list] = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                kernel_us.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
        if not kernel_us:
            print(f"{what}: {wall_ms:.1f} ms wall, device busy not measured (the profiler recorded no device events)")
            return {}
        busy_ms = sum(sum(v) for v in kernel_us.values()) / 1e3
        print(f"{what}: {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
              f"{sum(len(v) for v in kernel_us.values())} kernel launches")
        totals: dict[str, list] = {}
        for name, v in kernel_us.items():
            ident = kernel_ident(name)
            group = next((g for g, keys in groups.items() if isinstance(keys, set) and ident in keys), None) or next(
                (g for g, keys in groups.items() if isinstance(keys, tuple) and any(k in name for k in keys)), "other")
            totals.setdefault(group, []).extend(v)
        for group, v in sorted(totals.items(), key=lambda kv: -sum(kv[1])):
            print(f"  {sum(v) / 1e3:8.2f} ms  x{len(v):<5d} {group}")
        return totals

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
        "moe_gemm_ungrouped": k1.moe_gemm_ungrouped, "wkv6": k5.wkv6,
    }

    def reset_counts():
        for fn in COUNTED.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in COUNTED.items()}

    def rel_l2(a, b) -> float:
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def train_loop_phase(tcfg) -> dict:
        """Phase 8b: ``train_loop`` on the card (checks and numbers in the module doc); returns its launches."""
        import logging
        import shutil
        import tempfile

        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.data import DataConfig, SyntheticStream
        from repro_torch.launch.train import plan_controller
        from repro_torch.models import attention
        from repro_torch.models.layers import embed, rmsnorm
        from repro_torch.optim import ef_int8_compress, ef_int8_init
        from repro_torch.train import TrainLoopConfig, train_loop

        t_phase = time.perf_counter()
        lcfg = dataclasses.replace(tcfg, n_layers=LOOP_LAYERS)
        model = Model(lcfg, device=dev, param_dtype=torch.float32, requires_grad=True, seed=LOOP_SEED)
        n_params = sum(prm.numel() for prm in model.parameters())
        print(f"train loop model: {lcfg.name} {LOOP_LAYERS} layer, {n_params / 1e9:.3f} B params (f32 masters), "
              f"batch {LOOP_BATCH} x {LOOP_SEQ}, remat {lcfg.remat} ({card})")
        data = DataConfig(vocab_size=lcfg.vocab_size, seq_len=LOOP_SEQ, global_batch=LOOP_BATCH)
        batch0 = {key: torch.from_numpy(val).to(dev) for key, val in SyntheticStream(data).batch(0).items()}
        _, ctrl, cstate = plan_controller(lcfg, batch=LOOP_BATCH, seq=LOOP_SEQ, virtual_ranks=VIRTUAL_RANKS, device=dev,
                                          cooldown=LOOP_COOLDOWN)
        table0 = ctrl.table_of(cstate)
        print(f"train loop controller: table caps {table0.caps[0].tolist()}, envelope {list(table0.envelope or [])}")

        # attn_chunked against attn_full on layer 0's inputs: output and gradients
        att, cgen = model.layers[0].mixer, torch.Generator(device=dev).manual_seed(4)
        for dtype, tol in ((torch.float32, CHUNKED_F32_TOL), (torch.bfloat16, GRAD_REL_TOL)):
            with torch.no_grad():
                h = rmsnorm(embed(model.embed, batch0["tokens"], dtype), model.layers[0].ln1, eps=lcfg.norm_eps)
            ct = torch.randn(h.shape, generator=cgen, device=dev).to(dtype)
            outs = {}
            for name, fn in (("chunked", attention.attn_chunked), ("full", attention.attn_full)):
                x = h.detach().clone().requires_grad_(True)
                for prm in att.parameters():
                    prm.grad = None
                y = fn(att, lcfg, x)
                y.backward(ct)
                outs[name] = [y.detach(), x.grad, *(getattr(att, n).grad.clone() for n in "qkvo")]
            errs = [rel_l2(a, b) for a, b in zip(outs["chunked"], outs["full"])]
            finite = all(bool(torch.isfinite(t).all()) for t in outs["chunked"])
            print(f"attn_chunked vs attn_full at {LOOP_SEQ} tokens, {str(dtype)[6:]}: rel L2 output {errs[0]:.3g}, "
                  f"dx {errs[1]:.3g}, dWq/k/v/o {', '.join(f'{e_:.3g}' for e_ in errs[2:])} (tol {tol}) ({card})")
            if not finite or max(errs) > tol:
                fail(f"attn_chunked differs from attn_full in {dtype}: rel L2 {errs} (tol {tol})")
            del outs, h, ct
        for prm in att.parameters():
            prm.grad = None

        # ef8 on the card against the CPU on a slice of one step's gradients (two steps, so the
        # residual carries), then the time of one compression of every gradient
        # (and whether one step's loss and gradients repeat bit for bit: what the replay check rests on)
        runs = []
        for _ in range(2):
            for prm in model.parameters():
                prm.grad = None
            loss = model.loss(batch0, schedule=table0)
            loss.backward()
            runs.append((loss.detach().clone(), {n: prm.grad.clone() for n, prm in model.named_parameters()}))
        differ = [n for n in runs[0][1] if not torch.equal(runs[0][1][n], runs[1][1][n])]
        print(f"train step twice on the same state and table: loss equal {torch.equal(runs[0][0], runs[1][0])}, "
              f"gradient leaves differing {differ or 'none'}")
        del runs
        names = ("layers.0.ffn.w_gate", "layers.0.ffn.router", "layers.0.ln1", "head")
        grads = {n: model.get_parameter(n).grad for n in names}
        sl = {n: g.detach().reshape(-1)[: 1 << 22].clone() for n, g in grads.items()}
        ef_card, ef_host = ef_int8_init(sl), ef_int8_init({n: g.to("cpu", copy=True) for n, g in sl.items()})
        mism = 0
        for scale_ in (1.0, 0.5):
            g_card = {n: g * scale_ for n, g in sl.items()}
            g_host = {n: g.to("cpu", copy=True) for n, g in g_card.items()}
            ef_int8_compress(g_card, ef_card)
            ef_int8_compress(g_host, ef_host)
            mism += sum(int((g_card[n].cpu() != g_host[n]).sum()) + int((ef_card[n].cpu() != ef_host[n]).sum()) for n in sl)
        print(f"ef8 card vs CPU on {sum(t.numel() for t in sl.values())} gradient elements of {len(sl)} leaves, "
              f"2 steps: {mism} elements differ")
        if mism:
            fail(f"ef8 on the card differs from the CPU in {mism} elements")
        all_grads = {n: prm.grad for n, prm in model.named_parameters()}
        ef_all = ef_int8_init(all_grads)
        ef_ms = cuda_ms(lambda: ef_int8_compress(all_grads, ef_all, model.reference_groups()), reps=3, warmup=1)
        print(f"ef8 compression of all {n_params / 1e9:.3f} B gradients: {ef_ms:.2f} ms ({card})")
        del sl, ef_card, ef_host, ef_all, all_grads, grads, loss
        for prm in model.parameters():
            prm.grad = None
        torch.cuda.empty_cache()

        # the card's machine takes at most 45 GiB of disk writes a call, and the phase writes three
        # 27.4 GB checkpoints: they go to memory-backed /dev/shm where the machine has it (room: the
        # host memory available), else to the temporary directory
        shm = Path("/dev/shm")
        in_memory = shm.is_dir() and os.access(shm, os.W_OK)
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=str(shm) if in_memory else None)
        try:
            ckpt_bytes = 4 * 4 * n_params  # f32 params, two moments, ef state
            need = (LOOP_KEEP + 1) * ckpt_bytes * 1.1
            free = shutil.disk_usage(ckpt_dir).free
            if in_memory:
                meminfo = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
                free = min(free, int(meminfo["MemAvailable"].split()[0]) * 1024)
            print(f"train loop checkpoints in {ckpt_dir} ({'memory' if in_memory else 'disk'}): "
                  f"{free / 1e9:.1f} GB free, need {need / 1e9:.1f} GB "
                  f"(keep + 1 = {LOOP_KEEP + 1} checkpoints of {ckpt_bytes / 1e9:.2f} GB, + 10%)")
            if free < need:
                fail(f"train loop: {free / 1e9:.1f} GB free for checkpoints, {need / 1e9:.1f} GB needed")
            seen, plans, fired, resumed = [], {}, [], {}

            class Losses(logging.Handler):
                def emit(self, record):
                    if record.msg.startswith("step %d loss"):
                        seen.append(record.args[:2])

            def hook(step):
                plans.setdefault(step, []).append(
                    tuple(getattr(cstate, n).cpu().numpy().tobytes() for n in ("perms", "caps", "valid", "n_phases")))
                if step == LOOP_FAULT_AT and not fired:
                    fired.append(step)
                    raise RuntimeError("injected fault")

            def check_resume(step):
                if not resumed:
                    resumed.update(step=step, **{n: model.get_parameter(n).detach().to("cpu", copy=True) for n in leaf_names})

            leaf_names = ("embed", "layers.0.ffn.w_gate", "layers.0.mixer.q", "ln_f")
            logger = logging.getLogger("repro_torch.train")
            handler = Losses(logging.INFO)
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
            mgrs = [CheckpointManager(ckpt_dir, keep=LOOP_KEEP) for _ in range(2)]
            lkw = dict(ckpt_dir=ckpt_dir, ckpt_every=LOOP_CKPT_EVERY, keep=LOOP_KEEP, peak_lr=PEAK_LR, warmup=WARMUP,
                       log_every=1, grad_compress="ef8")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            try:
                t0 = time.perf_counter()
                res = train_loop(model, data, TrainLoopConfig(steps=LOOP_STEPS, **lkw), failure_hook=hook,
                                 device_controller=ctrl, device_ctrl_state=cstate, manager=mgrs[0])
                run_s = [time.perf_counter() - t0]
                on_disk = [CheckpointManager(ckpt_dir).steps()]
                with np.load(Path(ckpt_dir) / f"step_{LOOP_STEPS:08d}" / "arrays.npz") as z:
                    saved = {n: torch.from_numpy(z[f"params/{n}"]) for n in leaf_names}
                t0 = time.perf_counter()
                res2 = train_loop(model, data, TrainLoopConfig(steps=LOOP_RESUME_STEPS, **lkw),
                                  failure_hook=check_resume, device_controller=ctrl, device_ctrl_state=cstate,
                                  manager=mgrs[1])
                run_s.append(time.perf_counter() - t0)
                on_disk.append(CheckpointManager(ckpt_dir).steps())
            finally:
                logger.removeHandler(handler)
            counts = read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

        hist = res["history"] + res2["history"]
        for h_ in hist:
            print(f"train loop step {h_['step']}: loss {h_['loss']:.4f} | {h_['dt_s'] * 1e3:.1f} ms | "
                  f"{LOOP_BATCH * LOOP_SEQ / h_['dt_s']:.0f} tok/s | device re-plans {h_['device_replans']}, "
                  f"drop fraction {h_['drop_fraction']:.4f} ({card})")
        saves = mgrs[0].saves + mgrs[1].saves
        for rec in saves:
            print(f"train loop checkpoint step {rec['step']}: snapshot {rec['snapshot_s'] * 1e3:.1f} ms blocking "
                  f"({rec['nbytes'] / 1e9:.2f} GB to the host), background write {rec['write_s']:.1f} s "
                  f"({rec['nbytes'] / 1e9 / rec['write_s']:.2f} GB/s) ({card})")
        for rec in mgrs[0].restores + mgrs[1].restores:
            print(f"train loop restore step {rec['step']}: {rec['s']:.1f} s ({card})")
        ms = sorted(h_["dt_s"] * 1e3 for h_ in hist)
        print(f"train loop: {len(hist)} logged steps, step median {ms[len(ms) // 2]:.1f} ms "
              f"({LOOP_BATCH * LOOP_SEQ / (ms[len(ms) // 2] / 1e3):.0f} tok/s), runs {run_s[0]:.1f} + {run_s[1]:.1f} s, "
              f"peak memory {peak_gb:.2f} GB | controller {res2['controller']} ({card})")

        # recovery, checkpoints, restore
        steps1, steps2 = [h_["step"] for h_ in res["history"]], [h_["step"] for h_ in res2["history"]]
        if res["failures"] != 1 or res2["failures"] != 0:
            fail(f"train loop failures {res['failures']} then {res2['failures']}, expected 1 then 0")
        if steps1 != sorted(set(steps1)) or steps1 != list(range(LOOP_STEPS)) or steps2 != [LOOP_STEPS, LOOP_STEPS + 1]:
            fail(f"train loop history steps {steps1} then {steps2}")
        if (res["final_step"], res2["final_step"], resumed.get("step")) != (LOOP_STEPS, LOOP_RESUME_STEPS, LOOP_STEPS):
            fail(f"train loop final steps {res['final_step']}, {res2['final_step']}, resumed at {resumed.get('step')}")
        if on_disk != [[LOOP_STEPS], [LOOP_RESUME_STEPS]]:
            fail(f"train loop checkpoints on disk {on_disk}, expected [[{LOOP_STEPS}], [{LOOP_RESUME_STEPS}]]")
        bad = [n for n in leaf_names if not torch.equal(resumed[n], saved[n])]
        print(f"train loop restore: {', '.join(leaf_names)} equal the step-{LOOP_STEPS} checkpoint bit for bit: {not bad}")
        if bad:
            fail(f"train loop: resumed parameters {bad} differ from the checkpoint's arrays")
        # replayed steps: the first pass's losses wherever the tables were the same (this step's and
        # those of the replayed steps before it, whose updates it starts from)
        first, replay = dict(seen[:LOOP_FAULT_AT]), dict(seen[LOOP_FAULT_AT:LOOP_FAULT_AT + 2])
        same_so_far, compared = True, 0
        for s_ in sorted(replay):
            same_so_far &= plans[s_][0] == plans[s_][1]
            compared += same_so_far
            print(f"train loop replay step {s_}: loss {replay[s_]!r} vs first pass {first[s_]!r}, "
                  f"same tables {same_so_far}, equal {replay[s_] == first[s_]}")
            if same_so_far and replay[s_] != first[s_]:
                fail(f"train loop: replayed step {s_} gives loss {replay[s_]!r}, the first pass {first[s_]!r}")
        if sorted(replay) != list(range(LOOP_FAULT_AT - 2, LOOP_FAULT_AT)):
            fail(f"train loop: replayed steps {sorted(replay)}")
        print(f"train loop replay: {compared} of {len(replay)} replayed steps compared with the first pass "
              f"(a step is compared while its table and those of the replayed steps before it are the first pass's)")
        if compared == 0:
            fail("train loop: no replayed step ran under the first pass's tables, so the replay compared nothing")
        losses = [h_["loss"] for h_ in hist]
        if not all(math.isfinite(v) for v in losses) or not (losses[-1] + losses[-2]) / 2 < losses[0]:
            fail(f"train loop losses not finite or not falling: {losses}")
        executed = LOOP_FAULT_AT + (LOOP_STEPS - LOOP_CKPT_EVERY) + (LOOP_RESUME_STEPS - LOOP_STEPS)
        expect = dict.fromkeys(COUNTED, 0)
        expect.update(moe_gemm_grouped=2 * LOOP_LAYERS * executed, moe_gemm_grouped_dgrad=LOOP_LAYERS * executed,
                      moe_gemm_grouped_wgrad=LOOP_LAYERS * executed)
        print(f"train loop launches over {executed} executed steps: {counts} (expected {expect})")
        if counts != expect:
            fail(f"train loop launches {counts}, expected {expect}")
        if peak_gb >= LOOP_PEAK_GB:
            fail(f"train loop peak memory {peak_gb:.2f} GB, over {LOOP_PEAK_GB} GB")
        print(f"train loop phase: {time.perf_counter() - t_phase:.1f} s wall ({card})")
        del model, ctrl, cstate, table0
        torch.cuda.empty_cache()
        return counts

    def train_loop_step_trace(tcfg) -> None:
        """Where the time of one fused ef8 step of phase 8b goes (a fresh seeded model; one warm-up step)."""
        from repro_torch.data import DataConfig, SyntheticStream
        from repro_torch.launch.train import plan_controller
        from repro_torch.optim import AdamW, cosine_schedule
        from repro_torch.train import make_train_step

        lcfg = dataclasses.replace(tcfg, n_layers=LOOP_LAYERS)
        model = Model(lcfg, device=dev, param_dtype=torch.float32, requires_grad=True, seed=LOOP_SEED)
        _, ctrl, cstate = plan_controller(lcfg, batch=LOOP_BATCH, seq=LOOP_SEQ, virtual_ranks=VIRTUAL_RANKS, device=dev,
                                          cooldown=LOOP_COOLDOWN)
        step = make_train_step(model, AdamW(lr=cosine_schedule(PEAK_LR, WARMUP, LOOP_STEPS)), grad_compress="ef8",
                               controller=ctrl)
        stream = SyntheticStream(DataConfig(vocab_size=lcfg.vocab_size, seq_len=LOOP_SEQ, global_batch=LOOP_BATCH))
        float(step(stream.batch(0), cstate)["loss"])
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            float(step(stream.batch(1), cstate)["loss"])
            wall = (time.perf_counter() - t0) * 1e3
        trace_report(prof, wall, f"train loop step trace (fused ef8 step, 1 layer, 1 x {LOOP_SEQ}) ({card})", {
            "K2/K3 silu_grads": {"k23_silu_grads_kernel"}, "K2 dgrad": {"k2_dgrad_kernel"},
            "K3 wgrad": {"k3_wgrad_gate_up_kernel", "k3_wgrad_down_kernel"}, "K1 gate_up": {"k1_gate_up_kernel"},
            "K1 down": {"k1_down_kernel"}, "cuBLAS GEMM": cublas, "elementwise and reductions": elementwise,
        })
        del model, step, ctrl, cstate
        torch.cuda.empty_cache()

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

        if out[~occ].abs().max().item() != 0.0:
            fail(f"K1 {label}: dark tiles are not exact zeros")
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
        r["tflops"] = flops / r["ms"] / 1e9
        print(
            f"K1 {label}: {r['shape']} | max_abs_err {err:.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|) | kernel {r['ms']:.3f} ms | "
            f"plain {r['plain_ms']:.3f} ms | torch.bmm SwiGLU {r['library_ms']:.3f} ms | "
            f"bound {b_ms:.3f} ms ({b_by}) | {r['tflops']:.1f} TFLOP/s, {100 * b_ms / r['ms']:.1f}% of bound"
        )
    # K1's host cost at decode, where the host sets the pace: the wrapper
    # (checks, scratch, five tensor-map encodes, two launches) per call, and
    # one encode alone, as the C entry point makes it
    n_calls = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        k1._launch(x, wg, wu, wd, rv)
    k1_host_us = (time.perf_counter() - t0) / n_calls * 1e6
    torch.cuda.synchronize()
    encode_us = tensor_map_encode_us(x)
    k1_rows["decode"].update(host_us_per_call=k1_host_us, map_encode_us=encode_us)
    print(f"K1 decode host time: {k1_host_us:.1f} us per wrapper call; one cuTensorMapEncodeTiled {encode_us:.2f} us "
          f"(through ctypes), five per call")
    del x, out  # the expert weights stay for K2, K3 and K3b
    torch.cuda.empty_cache()

    # 4. K4 at the prefill shape
    b, h, kh, s, hd = BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, cfg.resolved_head_dim
    q, k, v = randn((b, h, s, hd), 1.0), randn((b, kh, s, hd), 1.0), randn((b, kh, s, hd), 1.0)
    qs = q * (hd**-0.5)  # the JAX wrapper's scaling (the kernel scales q itself); the plain version and SDPA take qs
    out = k4.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = close(out, k4.flash_attention_plain(qs, k, v, causal=True), "K4 prefill")
    pairs = b * h * s * (s + 1) / 2  # causal (query, key) pairs
    b_ms, b_by = bound(4.0 * hd * pairs, 2 * (2 * b * h * s * hd + 2 * b * kh * s * hd))

    def sdpa():
        return F.scaled_dot_product_attention(qs, k, v, is_causal=True, scale=1.0, enable_gqa=True)

    def k4_call():
        return k4._launch(q, k, v, causal=True, window=None)

    k4_row = {
        "shape": f"q[{b},{h},{s},{hd}] kv[{b},{kh},{s},{hd}] causal",
        "max_abs_err": err,
        "ms": cuda_ms(k4_call, 50),
        "plain_ms": cuda_ms(lambda: k4.flash_attention_plain(qs, k, v, causal=True), 10),
        "library_ms": cuda_ms(sdpa, 50),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    print(
        f"K4 prefill: {k4_row['shape']} | max_abs_err {err:.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|) | "
        f"kernel {k4_row['ms']:.4f} ms | plain {k4_row['plain_ms']:.4f} ms | SDPA {k4_row['library_ms']:.4f} ms | bound {b_ms:.4f} ms ({b_by})"
    )
    # as the model calls it (attn_flash): the [B, S, H, D] projections handed over
    # as [B, H, S, D] views, q pre-scaled by D^-0.5 (as _qkv returns it) and undone
    # with `prescale` inside the kernel, the output's transpose reshaped for the o
    # projection; SDPA called on the same views with the pre-scaled q and scale 1
    qm, km, vm = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))  # [B, S, H, D] storage
    qm = qm * (hd**-0.5)  # keeps the transposed layout
    out = k4.flash_attention(qm, km, vm, causal=True, prescale=hd**0.5)
    torch.cuda.synchronize()
    if not all(k4.kernel_readable(t) and not t.is_contiguous() for t in (qm, km, vm)) \
            or not out.transpose(1, 2).is_contiguous():
        fail("K4 as the model calls it: the views are not the model's, or the output's [B, S, H, D] transpose is not dense")
    err_m = close(out, k4.flash_attention_plain((qm * hd**0.5) * hd**-0.5, km, vm, causal=True),
                  "K4 as the model calls it")

    def model_k4():
        return k4.flash_attention(qm, km, vm, causal=True, prescale=hd**0.5).transpose(1, 2).reshape(b, s, -1)

    def model_sdpa():
        out = F.scaled_dot_product_attention(qm, km, vm, is_causal=True, scale=1.0, enable_gqa=True)
        return out.transpose(1, 2).reshape(b, s, -1)

    k4_row.update(model_call_ms=cuda_ms(model_k4, 50), model_call_library_ms=cuda_ms(model_sdpa, 50),
                  model_call_max_abs_err=err_m)

    def host_us(fn, n_calls: int = 400) -> float:
        """Host microseconds per call, the launch's enqueue included (no wait on the card; warmed up first)."""
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        us = (time.perf_counter() - t0) / n_calls * 1e6
        torch.cuda.synchronize()
        return us

    k4_row.update(
        host_us_per_call=host_us(lambda: k4.flash_attention(qm, km, vm, causal=True, prescale=hd**0.5)),
        library_host_us_per_call=host_us(
            lambda: F.scaled_dot_product_attention(qm, km, vm, is_causal=True, scale=1.0, enable_gqa=True)),
    )
    k4_host_us, library_host_us = k4_row["host_us_per_call"], k4_row["library_host_us_per_call"]
    print(f"K4 as the model calls it (transposed [B, S, H, D] views, prescale inside, output reshaped to "
          f"[B, S, H*D]): max_abs_err {err_m:.4g} | wrapper {k4_row['model_call_ms']:.4f} ms | SDPA the same way "
          f"{k4_row['model_call_library_ms']:.4f} ms | host {k4_host_us:.1f} us per wrapper call, "
          f"{library_host_us:.1f} us per SDPA call")
    # back to back, the host's work per call can outlast these small kernels; their device
    # times come from a trace, taken after the training run (a profiler session leaves the
    # host's later launches slower, and the serving and training phases are timed on the host)
    k4_inputs = (q, k, v, qs)
    del out, qm, km, vm

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
        r["tflops"] = (10.0 if name == "dgrad" else 12.0) * d * f * rows / r["ms"] / 1e9
        tol = f"tol {BF16_TOL} + {BF16_TOL}*|plain|" if name == "dgrad" else f"tol {WGRAD_MAX_REL}*max|plain|, rel L2 {WGRAD_REL_L2}"
        print(
            f"K{2 if name == 'dgrad' else 3} {name}: {shape} | max_abs_err {err:.4g} ({tol}) | "
            f"kernel {r['ms']:.3f} ms | plain {r['plain_ms']:.3f} ms | torch.bmm chain {r['library_ms']:.3f} ms | "
            f"bound {b_ms:.3f} ms ({b_by}) | {r['tflops']:.1f} TFLOP/s, {100 * b_ms / r['ms']:.1f}% of bound"
        )
    # each launch alone, so the next redesign sees which one sets the pace; the
    # dgrad launch beside one library call on the same da/du (it computes dark
    # rows too) and its own bound: 4 d F FLOP a row, da/du and the live
    # experts' wg/wu read once, dx written once
    rvb, (da, du, hh) = k1._launch_silu_grads(go, x, wg, wu, wd, rv)
    launch_ms = {
        "silu_grads": cuda_ms(lambda: k1._launch_silu_grads(go, x, wg, wu, wd, rv), 5),
        "dgrad": cuda_ms(lambda: k1._launch_dgrad(x, wg, wu, rvb, da, du), 5),
        "wgrad": cuda_ms(lambda: k1._launch_wgrad(go, x, wg, rvb, da, du, hh), 5),
    }
    launch_flops = {"silu_grads": 6.0 * d * f * rows, "dgrad": 4.0 * d * f * rows, "wgrad": 6.0 * d * f * rows}
    dgrad_lib_ms = cuda_ms(lambda: torch.baddbmm(torch.bmm(da, wg.transpose(1, 2)), du, wu.transpose(1, 2)), 5)
    dgrad_b_ms, dgrad_b_by = bound(4.0 * d * f * rows, 2 * rows * f * 2 + live_experts * 2 * d * f * 2 + e * c + e * c * d * 2)
    for name in k23_rows:
        k23_rows[name]["launch_ms"] = {key: launch_ms[key] for key in ("silu_grads", name)}
    k23_rows["dgrad"].update(launch_library_ms=dgrad_lib_ms, launch_bound_ms=dgrad_b_ms, launch_bound_by=dgrad_b_by)
    print("K2/K3 launches alone: " + " | ".join(
        f"{key} {ms:.3f} ms ({launch_flops[key] / ms / 1e9:.1f} TFLOP/s)" for key, ms in launch_ms.items()
    ) + f" | dgrad's torch.baddbmm(torch.bmm(da, wg^T), du, wu^T) {dgrad_lib_ms:.3f} ms, dgrad bound "
        f"{dgrad_b_ms:.3f} ms ({dgrad_b_by}), {100 * dgrad_b_ms / launch_ms['dgrad']:.1f}% of bound")
    del da, du, hh, rvb

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
    del leaves, out, leaf, want
    k3b_flops = 6.0 * d * f * e * c
    b_ms, b_by = bound(k3b_flops, 2 * e * c * d * 2 + e * 3 * d * f * 2)

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
    k3b_row["tflops"] = k3b_flops / k3b_row["ms"] / 1e9
    print(
        f"K3b ungrouped: {k3b_row['shape']} | max_abs_err {err3b:.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|) | "
        f"kernel {k3b_row['ms']:.3f} ms | plain {k3b_row['plain_ms']:.3f} ms | torch.bmm SwiGLU {k3b_row['library_ms']:.3f} ms | "
        f"bound {b_ms:.3f} ms ({b_by}) | {k3b_row['tflops']:.1f} TFLOP/s, {100 * b_ms / k3b_row['ms']:.1f}% of bound | "
        f"its path's launches {k3b_path}"
    )
    del x, go, wg, wu, wd, rv, all_live
    torch.cuda.empty_cache()

    # 5b. the knee: K1's device and per-call time against the tokens on one virtual rank of each router, at
    # full width, fitted with fit_knee; K1 held against its plain version at b = KNEE_CHECK_B; the paper's
    # Fig. 3/4 tables for Mixtral under the fitted device-time model and under the paper's knee_model()
    t_phase = time.perf_counter()
    reset_counts()
    knee = {}
    for name in KNEE_ROUTERS:
        prof = simulate.profile_knee(name, device=dev)
        for line in simulate.knee_lines(prof):
            print(f"{line} ({card})")
        if not all(math.isfinite(t) and t > 0 for t in prof.device_us + prof.call_us):
            fail(f"knee {name}: a time is non-finite or not positive: {prof.device_us} {prof.call_us}")
        for what, fit in (("device", prof.device_fit), ("per-call", prof.call_fit)):
            if not fit.per_token_us > MIN_SLOPE_US:  # fit_knee's slope when the tail's is not positive
                fail(f"knee {name}: the {what} fit's slope is not positive ({fit.per_token_us})")
        w0 = simulate.rank_weights(name, device=dev)[0]  # the first of the copies profile_knee timed
        x, rv = simulate.rank_batch(name, KNEE_CHECK_B, device=dev)
        out = k1._launch(x, *w0, rv)  # a comparison launch: not counted
        err = close(out, k1.moe_gemm_plain(x, *w0, rv), f"K1 knee {name} b={KNEE_CHECK_B}")
        print(f"K1 knee {name} b={KNEE_CHECK_B}: x{list(x.shape)} w[{prof.experts},{x.shape[2]},{w0[0].shape[2]}] "
              f"max_abs_err {err:.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|)")
        knee[name] = {
            "experts": prof.experts, "batches": prof.batches, "device_us": prof.device_us, "call_us": prof.call_us,
            "device_fit": [prof.device_fit.floor_us, prof.device_fit.per_token_us],
            "call_fit": [prof.call_fit.floor_us, prof.call_fit.per_token_us], "max_abs_err": err,
        }
        del w0, x, rv, out
        torch.cuda.empty_cache()
    knee_launches = read_counts()
    prof = knee["mixtral-8x7b"]
    models = {"the measured device-time knee": ComputeModel(*prof["device_fit"], name="h100-k1-device"),
              "the paper's knee_model()": knee_model()}
    for line in simulate.table_lines("mixtral-8x7b", models):
        print(f"{line} ({card})")
    print(f"knee phase: {time.perf_counter() - t_phase:.1f} s wall, launches {knee_launches} ({card})")

    # 6. serve: full-width Mixtral-8x7B, 4 layers, scheduled MoE path
    mcfg = mcfg_serve = dataclasses.replace(
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
    # drift "none": round 0 plans cold from the estimate, round 1 keeps that table
    print(f"serve {controller_line(res.controller[-1])} ({card}) | decisions "
          f"{[(d.changed, d.replanned, d.actions) for d in res.decisions]}")
    host_rt, host_scen = make_serving_controller(mcfg, n_ranks=VIRTUAL_RANKS, drift="none", rounds=ROUNDS, device="cpu")
    host_rt.observe(demand_estimate(mcfg, float(BATCH * PROMPT * cfg.moe.top_k), host_scen, 0))
    if [d.actions for d in res.decisions] != [("miss",), ("keep",)] or not all(
        tables_equal(t, host_rt.table()) for t in res.tables
    ):
        fail(f"serving tables: decisions {res.decisions}, expected a cold plan in round 0 kept in round 1")

    # kernel path vs plain path on the card: the same prompts through prefill,
    # with K1 and K4 held against their plain versions on every layer's own
    # inputs, on three prompt sets (the first from the serving generator)
    prompt_sets = [torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)]
    for seed in MIXTRAL_EXTRA_PROMPT_SEEDS:
        pgen = torch.Generator(device=dev).manual_seed(seed)
        prompt_sets.append(torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=pgen, device=dev))
    prompts = prompt_sets[0]  # the prefill trace below reuses them

    def prefill_logits(p, m=None, table=None):
        m = model if m is None else m
        caches = m.init_cache(BATCH, PROMPT)
        return m.prefill(p, caches, schedule=res.table if table is None else table)[0].float()

    def row_rel(a, b) -> float:
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()

    k1_layer_errs, k4_layer_errs = [], []

    def held_k1(x, w_gate, w_up, w_down, row_valid):
        out = k1._launch(x, w_gate, w_up, w_down, row_valid)  # a comparison launch: not counted
        n = len(k1_layer_errs)
        k1_layer_errs.append(close(out, k1.moe_gemm_plain(x, w_gate, w_up, w_down, row_valid), f"K1 in layer {n}"))
        dark = out[~k1.tile_occupancy(row_valid)]
        if dark.numel() and dark.abs().max().item() != 0.0:
            fail(f"K1 in layer {n}: dark tiles are not exact zeros")
        return out

    def plain_flash(q, k, v, *, causal=True, window=None, prescale=1.0):
        return k4.flash_attention_plain((q * prescale) * (q.shape[-1] ** -0.5), k, v, causal=causal, window=window)

    def held_k4(q, k, v, *, causal=True, window=None, prescale=1.0):
        out = k4._launch(q, k, v, causal=causal, window=window, prescale=prescale)  # a comparison launch: not counted
        ref = plain_flash(q, k, v, causal=causal, window=window, prescale=prescale)
        k4_layer_errs.append(close(out, ref, f"K4 in layer {len(k4_layer_errs)}"))
        return out

    ngen = torch.Generator(device=dev).manual_seed(4)

    def perturbed_k1(x, w_gate, w_up, w_down, row_valid):
        """moe_gemm_plain with its f32 down product scaled by 1 + 1e-7 N(0, 1) before the bf16 rounding."""
        xf = x.float()
        hh = (F.silu(torch.bmm(xf, w_gate.float())) * torch.bmm(xf, w_up.float())).to(x.dtype)
        down = torch.bmm(hh.float(), w_down.float())
        out = (down * (1 + 1e-7 * torch.randn(down.shape, generator=ngen, device=dev))).to(x.dtype)
        return torch.where(k1.tile_occupancy(row_valid)[..., None], out, torch.zeros((), dtype=out.dtype, device=dev))

    def bf16_prefill_check(p, label: str, table) -> None:
        """K1 and K4 held on every layer's own inputs inside a bf16 prefill
        under ``table``, and the logits of the kernel path against the plain
        path within the larger of LOGITS_REL_TOL and twice the noise floor."""
        k1_layer_errs.clear()
        k4_layer_errs.clear()
        with mock.patch.object(k1, "moe_gemm", held_k1), mock.patch.object(k4, "flash_attention", held_k4):
            kernel_logits = prefill_logits(p, table=table)
        if len(k1_layer_errs) != LAYERS or len(k4_layer_errs) != LAYERS or not torch.isfinite(kernel_logits).all():
            fail(f"Mixtral bf16 prefill ({label}): K1 held in {len(k1_layer_errs)} and K4 in {len(k4_layer_errs)} "
                 f"of {LAYERS} layers, or non-finite logits")
        print(f"{label}: K1 inside the {LAYERS}-layer bf16 prefill, on each layer's own packed inputs: max_abs_err "
              f"{max(k1_layer_errs):.4g}; K4 on each layer's own strided q/k/v: max_abs_err {max(k4_layer_errs):.4g} "
              f"(tol {BF16_TOL} + {BF16_TOL}*|plain|)")
        with mock.patch.object(k4, "flash_attention", plain_flash):
            with mock.patch.object(k1, "moe_gemm", k1.moe_gemm_plain):
                plain_logits = prefill_logits(p, table=table)
            with mock.patch.object(k1, "moe_gemm", perturbed_k1):
                noise_logits = prefill_logits(p, table=table)
        rel, floor = row_rel(kernel_logits, plain_logits), row_rel(noise_logits, plain_logits)
        logits_tol = max(LOGITS_REL_TOL, MIXTRAL_BF16_NOISE_MULT * floor)
        max_abs = (kernel_logits - plain_logits).abs().max().item()
        same_top1 = int((kernel_logits.argmax(-1) == plain_logits.argmax(-1)).sum())
        # where the perturbation alone moves the logits past LOGITS_REL_TOL (a flipped
        # routing choice), the limit admits a change of that size: the reading is
        # printed but is no evidence about the kernels (the f32 check below is)
        verdict = "informative" if floor <= LOGITS_REL_TOL else (
            f"uninformative: the noise floor alone exceeds {LOGITS_REL_TOL}")
        print(
            f"{label}: prefill logits kernel vs plain path: max row rel L2 {rel:.3g} (tol {logits_tol:.3g}: the larger "
            f"of {LOGITS_REL_TOL} and {MIXTRAL_BF16_NOISE_MULT} x the noise floor), max abs {max_abs:.3g}, same argmax "
            f"{same_top1}/{BATCH}; the noise floor, plain vs plain with the down product * (1 + 1e-7 N(0, 1)): {floor:.3g} "
            f"({verdict})"
        )
        if not torch.isfinite(plain_logits).all() or rel > logits_tol:
            fail(f"prefill logits of the kernel path differ from the plain path ({label}): rel L2 {rel:.3g}, "
                 f"tol {logits_tol:.3g}")

    for i, p in enumerate(prompt_sets):
        label = "prompt set 0 (serving generator)" if i == 0 else f"prompt seed {MIXTRAL_EXTRA_PROMPT_SEEDS[i - 1]}"
        bf16_prefill_check(p, label, res.table)

    # 6b. serve under drift: the same model, the controller re-planning between
    # rounds; each round's device table is held against a host runtime fed the
    # same estimates, and a swap inside the envelope must reuse the tensors
    real_table, table_ptrs = ScheduleRuntime.table, []

    def recording_table(runtime):
        table = real_table(runtime)
        if runtime.device.type == "cuda":
            table_ptrs.append((runtime.table_rebuilds, [getattr(table, name).data_ptr() for name in TABLE_LEAVES]))
        return table

    drift_launches = dict.fromkeys(COUNTED, 0)
    drift_table = None
    for kind in DRIFT_KINDS:
        table_ptrs.clear()
        reset_counts()
        with mock.patch.object(ScheduleRuntime, "table", recording_table):
            dres = serve(model, batch=BATCH, prompt_len=PROMPT, new_tokens=DRIFT_NEW_TOKENS, rounds=DRIFT_ROUNDS,
                         controller=True, virtual_ranks=VIRTUAL_RANKS, drift=kind, seed=0)
        got = read_counts()
        expect = dict.fromkeys(COUNTED, 0)
        expect.update(moe_gemm_grouped=DRIFT_ROUNDS * (1 + DRIFT_NEW_TOKENS) * LAYERS,
                      flash_attention_fwd=DRIFT_ROUNDS * LAYERS)
        if len(table_ptrs) != DRIFT_ROUNDS:
            fail(f"drift {kind}: {len(table_ptrs)} table fetches for {DRIFT_ROUNDS} rounds")
        host_rt, host_scen = make_serving_controller(mcfg, n_ranks=VIRTUAL_RANKS, drift=kind, rounds=DRIFT_ROUNDS,
                                                     device="cpu")
        for r in range(DRIFT_ROUNDS):
            d, m, t = dres.decisions[r], dres.controller[r], dres.tables[r]
            admitted, dropped, routed = dres.moe_by_round[r]
            print(f"drift {kind} round {r}: changed {d.changed} replanned {d.replanned} actions {d.actions} | "
                  f"{m['warm_hits']} warm / {m['cold_plans']} cold plans so far | observe "
                  f"{m['observe_us_per_step']:.0f} us/round | table n_phases {t.n_phases[0].item()} caps "
                  f"{t.caps[0].tolist()} envelope {list(t.envelope)} | table_rebuilds {m['table_rebuilds']} | "
                  f"routed {routed:.0f} admitted {admitted:.0f} dropped {dropped:.0f} | plan {dres.plan_ms[r]:.2f} ms "
                  f"prefill {dres.prefill_ms[r]:.1f} ms decode {dres.decode_ms[r]:.1f} ms "
                  f"({dres.decode_ms[r] / DRIFT_NEW_TOKENS:.2f} ms/step) ({card})")
            hd = host_rt.observe(demand_estimate(mcfg, float(BATCH * PROMPT * cfg.moe.top_k), host_scen, r))
            if (hd.changed, hd.replanned, hd.key, hd.actions) != (d.changed, d.replanned, d.key, d.actions) or \
                    not tables_equal(t, host_rt.table()):
                fail(f"drift {kind} round {r}: the device table or decision differs from the host runtime's")
            if r and table_ptrs[r][0] == table_ptrs[r - 1][0] and table_ptrs[r][1] != table_ptrs[r - 1][1]:
                fail(f"drift {kind} round {r}: a swap inside the envelope moved the table's storage")
        print(f"drift {kind}: {controller_line(dres.controller[-1])} ({card}), launches {got} (expected {expect})")
        if got != expect:
            fail(f"drift {kind}: serving path launches {got}, expected {expect}")
        if kind in ("shift", "hotspot") and not any(d.replanned for d in dres.decisions[1:]):
            fail(f"drift {kind}: the controller never re-planned after round 0")
        if not 0 < dres.admitted <= dres.routed or not torch.isfinite(dres.first_logits).all():
            fail(f"drift {kind}: MoE stats inconsistent or non-finite logits")
        for name in COUNTED:
            drift_launches[name] += got[name]
        if kind == "shift":
            drift_table = dres.table
    # the shift scenario's last (re-planned) table: K1 and K4 held per layer, logits kernel vs plain
    bf16_prefill_check(prompt_sets[0], "after drift shift, its last table", drift_table)

    def serve_engine_phase(model) -> dict:
        """Phase 6c (see the module doc).  Returns the main path's launches
        per kernel."""
        from repro_torch.core import DeviceController
        from repro_torch.models.layers import rmsnorm
        from repro_torch.serve import Request, ServeEngine

        eng = ServeEngine(mcfg, model, **ENGINE_KW)
        ctrl = eng._ctrl
        # the prompts' token pools, probed on layer 0's router (its input taken
        # as the normed embedding): pool A routes top-2 into HOT, pool B avoids it
        blk = model.layers[0]
        top = torch.topk(rmsnorm(model.embed.float(), blk.ln2, eps=mcfg.norm_eps) @ blk.ffn.router.float(),
                         mcfg.moe.top_k, dim=-1).indices
        in_hot = torch.isin(top, torch.tensor(ENGINE_HOT, device=dev))
        pools = {"A": torch.nonzero(in_hot.all(-1)).flatten()[:ENGINE_POOL].cpu().numpy(),
                 "B": torch.nonzero(~in_hot.any(-1)).flatten()[:ENGINE_POOL].cpu().numpy()}
        if min(len(v) for v in pools.values()) < 8:
            fail(f"engine phase: token pools too small ({ {k: len(v) for k, v in pools.items()} })")
        rng = np.random.default_rng(ENGINE_SEED)

        def trace(pool):
            """bench_serve's trace shape: exponential gaps at 1 request a decode step."""
            arrivals = np.floor(np.cumsum(rng.exponential(1.0, ENGINE_REQUESTS))).astype(int)
            return [Request(prompt=rng.choice(pool, int(rng.integers(*ENGINE_PROMPT))),
                            max_new_tokens=int(rng.integers(*ENGINE_NEW)), arrival=float(a)) for a in arrivals]

        # a CPU twin of the controller, fed the routing the engine copies to the host, step for step
        twin, twin_state = DeviceController(ctrl.cfg, device="cpu"), eng._state.clone("cpu")
        fed: list = []
        # each call of the step function, by kind: captured (a replay launches what the
        # capture recorded; replays do not pass the wrappers' counters), the capture's
        # warm-up step (a real decode step on copies), or a comparison (graph vs eager)
        real_step, kinds, comparing = ServeEngine._step, {}, [False]

        def counted_step(self, *args):
            before = read_counts()
            out = real_step(self, *args)
            kind = "captured" if torch.cuda.is_current_stream_capturing() else (
                "comparison" if comparing[0] else "warmup")
            calls = kinds.setdefault(kind, {"calls": 0, **dict.fromkeys(COUNTED, 0)})
            calls["calls"] += 1
            for name, n in read_counts().items():
                calls[name] += n - before[name]
            return out

        real_decode, real_prefill = eng._decode_once, eng._prefill_row
        steps, prefill_ms, held, first_fire_held = [], {}, [], [False]
        # K1 and K4 held against their plain versions at the shapes this path gives
        # them: batch-1 prefill per bucket, decode under the controller's tables
        k_held = {"prefill": {}, "decode": [], "after_cold": None}

        def kernels_held(what: str, fn, k4_layers: int):
            """``fn()`` with every layer's K1 (and K4 in ``k4_layers`` layers)
            held against its plain version (comparison launches, not counted)."""
            k1_layer_errs.clear()
            k4_layer_errs.clear()
            with mock.patch.object(k1, "moe_gemm", held_k1), mock.patch.object(k4, "flash_attention", held_k4):
                out = fn()
            if len(k1_layer_errs) != LAYERS or len(k4_layer_errs) != k4_layers:
                fail(f"engine {what}: K1 held in {len(k1_layer_errs)} and K4 in {len(k4_layer_errs)} layers, expected "
                     f"{LAYERS} and {k4_layers}")
            return out, (max(k1_layer_errs), max(k4_layer_errs, default=None))

        def held_decode():
            """Hold the replay against the eager step on copies (with K1 held in
            every layer) at each phase's first step, at every step until the
            first re-plan has been held, and at the step after the first cold
            re-plan, the first under a table the auction planned on the card."""
            after_cold = k_held["after_cold"] is None and bool(steps) and steps[-1]["fire"] and \
                eng.replan_log[-1]["kind"] == "cold"
            hold = not steps or steps[-1]["phase"] != phase[0] or not first_fire_held[0] or after_cold
            if hold:
                comparing[0] = True
                ref, errs = kernels_held(f"decode step {len(steps) + 1}", eng.step_on_copies, 0)
                comparing[0] = False
                k_held["decode"].append((len(steps) + 1, errs[0]))
                if after_cold:
                    k_held["after_cold"] = len(steps) + 1
            t0 = time.perf_counter()
            nxt = real_decode()
            ms = (time.perf_counter() - t0) * 1e3
            out = eng.split_outputs(eng.last_outputs)
            fed.append((out["routing"].copy(), out["dropped"].copy()))
            steps.append({"phase": phase[0], "ms": ms, "fire": out["fire"]})
            if hold:
                live = torch.from_numpy(np.flatnonzero(eng.batcher.live)).to(dev)
                same = np.array_equal(eng.last_outputs, ref["outputs"]) and all(
                    torch.equal(mine[key][live], theirs[key][live])
                    for mine, theirs in zip(eng._caches, ref["caches"]) for key in mine
                ) and all(torch.equal(leaf, ref["state"].leaves()[name]) for name, leaf in eng._state.leaves().items())
                held.append((phase[0], len(steps), out["fire"]))
                if not same:
                    fail(f"engine phase {phase[0]} decode step {len(steps)}: the graph replay differs from the "
                         f"eager step function on copies of its inputs")
                first_fire_held[0] |= out["fire"]
            return nxt

        def timed_prefill(req, bucket):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            row, plen = real_prefill(req, bucket)
            torch.cuda.synchronize()
            if plen > 0:
                prefill_ms.setdefault(bucket, []).append((time.perf_counter() - t0) * 1e3)
            if plen > 0 and bucket not in k_held["prefill"]:
                # the same prefill again with K1 and K4 held: it must also give the served row
                again, k_held["prefill"][bucket] = kernels_held(
                    f"prefill bucket {bucket}", lambda: real_prefill(req, bucket), LAYERS)
                if not all(torch.equal(a[key], b[key]) for a, b in zip(row, again[0]) for key in a):
                    fail(f"engine prefill bucket {bucket}: the row differs from the same prefill with K1 and K4 held")
            return row, plen

        eng._decode_once, eng._prefill_row = held_decode, timed_prefill
        phase, snaps = [None], {}
        reset_counts()
        with mock.patch.object(ServeEngine, "_step", counted_step):
            for name, pool in (("A", "A"), ("B", "B"), ("A2", "A")):
                phase[0] = name
                reqs = trace(pools[pool])
                before = eng.metrics()["serve"]  # the engine's counters run on across phases
                t0 = time.perf_counter()
                out = eng.run(reqs)
                wall = time.perf_counter() - t0
                for routing, dropped in fed:
                    twin.step(twin_state, routing, dropped)
                fed.clear()
                snaps[name] = out
                s, c = out["serve"], out["compile"]
                n_steps = s["decode_steps"] - before["decode_steps"]
                rejected = s["requests"]["rejected"] - before["requests"]["rejected"]
                done = sum(r.done for r in reqs)
                tokens = sum(len(r.tokens) for r in reqs)
                wait = np.percentile([r.admit_step - r.arrival for r in reqs], (50, 99))
                print(f"engine phase {name}: completed {done}/{len(reqs)}, rejected {rejected} | decode steps {n_steps}, "
                      f"occupancy {tokens / (n_steps * ENGINE_KW['decode_slots']):.3f} | queue wait p50/p99 "
                      f"{wait[0]:.1f}/{wait[1]:.1f} steps | {tokens} tokens in {wall:.2f} s, {tokens / wall:.1f} tok/s "
                      f"| compile {c} ({card})")
                if done != len(reqs) or rejected:
                    fail(f"engine phase {name}: {done} of {len(reqs)} completed, {rejected} rejected")
                if c["decode_executables"] != 1:
                    fail(f"engine phase {name}: {c['decode_executables']} decode graphs, expected one for the run")
                # the card's controller state against the CPU twin's after the same routing
                m, tm = out["controller"], twin.metrics(twin_state)
                for leaf_name, leaf in eng._state.leaves().items():
                    mine, theirs = leaf.cpu(), twin_state.leaves()[leaf_name]
                    ok = torch.allclose(mine, theirs, rtol=1e-6, atol=0) if mine.is_floating_point() else \
                        torch.equal(mine, theirs)
                    if not ok:
                        fail(f"engine phase {name}: controller leaf {leaf_name} differs from the CPU twin's")
                if (m["device_replans"], m["regime_warm_swaps"]) != (tm["device_replans"], tm["regime_warm_swaps"]):
                    fail(f"engine phase {name}: re-plans {m} against the CPU twin's {tm}")
                print(f"engine phase {name}: controller {m} | the CPU twin fed the same routing agrees "
                      f"(integer and bool leaves exactly, f32 within 1e-6)")
                if name == "A":
                    eng.capture_regime()
                    twin.load_regimes(twin_state, eng._bank_tables, eng._bank_refs)
        counted = read_counts()
        del eng._decode_once, eng._prefill_row  # the class's own again (and no cycle through the wrappers)
        if snaps["A2"]["compile"]["prefill_executables"] != len(ENGINE_KW["buckets"]):
            fail(f"engine: {snaps['A2']['compile']['prefill_executables']} bucket shapes prefilled, "
                 f"expected {len(ENGINE_KW['buckets'])}")
        cold = [e["ms"] for e in eng.replan_log if e["kind"] == "cold"]
        warm = [e["ms"] for e in eng.replan_log if e["kind"] == "warm"]
        if not cold:
            fail("engine: no cold re-plan fired on the card")
        print(f"engine re-plans: cold {len(cold)} ({', '.join(f'{v:.1f}' for v in cold)} ms, the batched auction on "
              f"the card), warm {len(warm)} ({', '.join(f'{v:.2f}' for v in warm)} ms) ({card})")
        print(f"engine held graph vs eager exactly at {len(held)} steps (phase, step, fired): {held} ({card})")
        if sorted(k_held["prefill"]) != sorted(ENGINE_KW["buckets"]) or k_held["after_cold"] is None:
            fail(f"engine: K1/K4 held in prefill buckets {sorted(k_held['prefill'])}, K1 after a cold re-plan at step "
                 f"{k_held['after_cold']}")
        print(f"engine K1 and K4 held against their plain versions in every layer (tol {BF16_TOL} + {BF16_TOL}*|plain|;"
              f" the replays equal these eager steps): batch-1 prefill, bucket: (K1, K4 max_abs_err) "
              f"{ {b: tuple(f'{v:.4g}' for v in e) for b, e in sorted(k_held['prefill'].items())} }; decode, step: K1 "
              f"max_abs_err {[(n, f'{v:.4g}') for n, v in k_held['decode']]}, step {k_held['after_cold']} the first "
              f"under a cold re-plan's table ({card})")

        # launches of the main path: the wrappers' counts, less the capture's (no
        # launch) and the comparisons', plus each replay's recorded launches
        captured, warmup = kinds["captured"], kinds.get("warmup", dict.fromkeys(COUNTED, 0) | {"calls": 0})
        comparison = kinds.get("comparison", dict.fromkeys(COUNTED, 0))
        if captured["calls"] != 1:
            fail(f"engine: {captured['calls']} captures")
        main = {name: counted[name] - captured[name] - comparison[name] + eng.graph_replays * captured[name]
                for name in COUNTED}
        n_prefill, n_decode = sum(len(v) for v in prefill_ms.values()), len(steps)
        expect = dict.fromkeys(COUNTED, 0)
        expect.update(moe_gemm_grouped=LAYERS * (n_prefill + n_decode + warmup["calls"]),
                      flash_attention_fwd=LAYERS * n_prefill)
        print(f"engine launches: {main} (expected {expect}: K1 layers x (prefills {n_prefill} + decode steps "
              f"{n_decode} + the capture's warm-up step {warmup['calls']}), K4 layers x prefills; {eng.graph_replays} "
              f"replays of one graph recording {captured['moe_gemm_grouped']} K1 launches)")
        if main != expect or eng.graph_replays != n_decode:
            fail(f"engine launches {main}, expected {expect}")

        # timings: decode steps by host clock (each ends in its device-to-host copy),
        # prefill per bucket, then graph replay vs the eager step on the same inputs
        plain = [st["ms"] for st in steps if not st["fire"]]
        print(f"engine decode ms/step (graph, host clock, {len(plain)} steps without a re-plan): median "
              f"{float(np.median(plain)):.2f}, mean {float(np.mean(plain)):.2f} ({card})")
        for bucket, v in sorted(prefill_ms.items()):
            print(f"engine prefill bucket {bucket}: {len(v)} prefills, median {float(np.median(v)):.2f} ms, "
                  f"mean {float(np.mean(v)):.2f} ms ({card})")
        caches = [{k: v.clone() for k, v in c.items()} for c in eng._caches]
        state = eng._state.clone()
        table = ctrl.table_of(state)
        eager_ms = cuda_ms(lambda: eng._step(eng._inputs, caches, state, table), 5, warmup=1)
        replay_ms = cuda_ms(eng._graph.replay, 5, warmup=1)
        print(f"engine decode step on the same inputs (CUDA events): graph replay {replay_ms:.3f} ms, eager "
              f"{eager_ms:.3f} ms ({card})")
        del caches, state, table

        # per-slot decode: 8 rows at ragged depths through one [B]-step decode,
        # against each row's own scalar decode at the batch's width (its cache in
        # all 8 slots), so that every GEMM runs at the same M and sums in the same
        # order: the logits must be equal bit for bit.  A row decoded alone runs
        # its GEMMs at M = 1, where cuBLAS sums in another order; that difference
        # is printed, and it is no check of the per-slot path
        pgen = torch.Generator(device=dev).manual_seed(ENGINE_SEED)
        slots = ENGINE_KW["decode_slots"]
        rows, alone, wide, last = [], [], [], []
        for plen in ENGINE_SLOT_PROMPTS:
            toks = torch.randint(0, mcfg.vocab_size, (1, plen), generator=pgen, device=dev)
            cache = model.init_cache(1, ENGINE_KW["max_len"])
            model.prefill(toks[:, :-1], cache)
            rows.append([{k: v.clone() for k, v in c.items()} for c in cache])
            replicated = [{k: torch.cat([v] * slots) for k, v in c.items()} for c in cache]
            wide.append(model.decode_step(toks[:, -1].repeat(slots), replicated, plen - 1)[0][0])
            alone.append(model.decode_step(toks[:, -1], cache, plen - 1)[0][0])
            last.append(toks[0, -1])
        batched = [{k: torch.cat([r[l][k] for r in rows]) for k in rows[0][l]} for l in range(LAYERS)]
        depth = torch.tensor([p - 1 for p in ENGINE_SLOT_PROMPTS], dtype=torch.int32, device=dev)
        got, wide = model.decode_step(torch.stack(last), batched, depth)[0], torch.stack(wide)
        if not torch.isfinite(got).all() or not torch.equal(got, wide):
            fail(f"per-slot decode: the [B]-step logits differ from per-row scalar decode at the same width by "
                 f"{float((got - wide).abs().max()):.4g}")
        print(f"per-slot decode, {slots} slots at depths {depth.tolist()}: [B]-step logits equal per-row scalar decode "
              f"at the same width bit for bit (each row decoded alone, M = 1 GEMMs, differs from M = {slots} by max "
              f"abs {float((wide - torch.stack(alone)).abs().max()):.4g})")
        del eng, rows, batched
        gc.collect()  # the engine's graph and caches, before the next phases' memory
        torch.cuda.empty_cache()
        return main, pools["A"]

    # 6c. serve through the engine: the same model behind ServeEngine (the
    # JAX drift run's knobs), continuous batching over 8 slots at ragged
    # depths, the decode step one CUDA graph under the device controller
    engine_launches, engine_pool = serve_engine_phase(model)

    del model, drift_table, dres
    torch.cuda.empty_cache()

    # 6d. Qwen3-MoE-235B-A22B and DBRX-132B at full width, cut to ARCH_LAYERS layers, through serve (the
    # controller plans at 16 and 2 experts a virtual rank), with K1 and K4 held per layer in a bf16 prefill;
    # then one full-width Mixtral MoE layer under a table row with the fp8 and int8 wire codecs
    t_phase = time.perf_counter()
    arch_launches, arch_rows = {}, {}
    for arch in ARCHS:
        acfg = get_config(arch)
        scfg = dataclasses.replace(acfg, n_layers=ARCH_LAYERS,
                                   moe=dataclasses.replace(acfg.moe, dispatch="phase_pipelined", use_pallas=True))
        t0 = time.perf_counter()
        amodel = Model(scfg, device=dev, seed=0)
        torch.cuda.synchronize()
        a_params = sum(prm.numel() for prm in amodel.parameters())
        print(f"model: {arch} {ARCH_LAYERS} layers, {a_params / 1e9:.2f} B params ({2 * a_params / 1e9:.2f} GB bf16), "
              f"{scfg.moe.n_experts} experts top-{scfg.moe.top_k} F {scfg.moe.d_ff_expert}, heads "
              f"{scfg.n_heads}/{scfg.n_kv_heads} of {scfg.resolved_head_dim}, init {time.perf_counter() - t0:.1f} s")
        reset_counts()
        ares = serve(amodel, batch=BATCH, prompt_len=PROMPT, new_tokens=ARCH_NEW, rounds=ROUNDS, controller=True,
                     virtual_ranks=VIRTUAL_RANKS, seed=0)
        arch_launches[arch] = got = read_counts()
        expect = dict.fromkeys(COUNTED, 0)
        expect.update(moe_gemm_grouped=ROUNDS * (1 + ARCH_NEW) * ARCH_LAYERS, flash_attention_fwd=ROUNDS * ARCH_LAYERS)
        for r in range(ROUNDS):
            print(f"{arch} serve round {r}: plan {ares.plan_ms[r]:.1f} ms | prefill {ares.prefill_ms[r]:.1f} ms "
                  f"({BATCH * PROMPT / ares.prefill_ms[r] * 1e3:.0f} tok/s) | decode {ares.decode_ms[r]:.1f} ms "
                  f"({ares.decode_ms[r] / ARCH_NEW:.2f} ms/step) ({card})")
        print(f"{arch} serve: launches {got} (expected {expect}) | MoE routed {ares.routed:.0f}, admitted "
              f"{ares.admitted:.0f}, dropped {ares.dropped:.0f} | table n_phases {ares.tables[-1].n_phases[0].item()} "
              f"caps {ares.tables[-1].caps[0].tolist()} envelope {list(ares.tables[-1].envelope)} | "
              f"{controller_line(ares.controller[-1])}")
        if got != expect:
            fail(f"{arch} serving path launches {got}, expected {expect}")
        if ares.tokens.shape != (ROUNDS, BATCH, ARCH_NEW) or int(ares.tokens.min()) < 0 \
                or int(ares.tokens.max()) >= scfg.vocab_size:
            fail(f"{arch}: generated tokens out of range or misshapen: {tuple(ares.tokens.shape)}")
        if ares.first_logits.shape != (BATCH, scfg.vocab_size) or not torch.isfinite(ares.first_logits).all():
            fail(f"{arch}: prefill logits misshapen or non-finite")
        if not 0 < ares.admitted <= ares.routed or ares.dropped < 0:
            fail(f"{arch}: MoE stats inconsistent: routed {ares.routed}, admitted {ares.admitted}, dropped {ares.dropped}")
        host_rt, host_scen = make_serving_controller(scfg, n_ranks=VIRTUAL_RANKS, drift="none", rounds=ROUNDS,
                                                     device="cpu")
        host_rt.observe(demand_estimate(scfg, float(BATCH * PROMPT * scfg.moe.top_k), host_scen, 0))
        if [d_.actions for d_ in ares.decisions] != [("miss",), ("keep",)] or not all(
                tables_equal(t, host_rt.table()) for t in ares.tables):
            fail(f"{arch} serving tables: decisions {ares.decisions}, expected a cold plan in round 0 kept in round 1 "
                 "equal to a host runtime's")
        k1_layer_errs.clear()
        k4_layer_errs.clear()
        agen = torch.Generator(device=dev).manual_seed(11)
        aprompts = torch.randint(0, scfg.vocab_size, (BATCH, PROMPT), generator=agen, device=dev)
        first = {}  # layer 0's K1 and K4 inputs, timed below at this config's shapes

        def held_k1_first(*args):
            first.setdefault("k1", args)
            return held_k1(*args)

        def held_k4_first(q, k, v, **kw):
            first.setdefault("k4", (q, k, v, kw))
            return held_k4(q, k, v, **kw)

        with mock.patch.object(k1, "moe_gemm", held_k1_first), mock.patch.object(k4, "flash_attention", held_k4_first):
            held_logits = prefill_logits(aprompts, amodel, ares.table)
        if len(k1_layer_errs) != ARCH_LAYERS or len(k4_layer_errs) != ARCH_LAYERS or not torch.isfinite(held_logits).all():
            fail(f"{arch} bf16 prefill: K1 held in {len(k1_layer_errs)} and K4 in {len(k4_layer_errs)} of "
                 f"{ARCH_LAYERS} layers, or non-finite logits")
        xa, wga, wua, wda, rva = first["k1"]
        ea, ca, da_ = xa.shape
        fa = wga.shape[-1]
        occ = k1.tile_occupancy(rva)
        rows, live_e = int(occ.sum()), int(occ.any(dim=1).sum())
        b_ms, b_by = bound(6.0 * da_ * fa * rows, rows * da_ * 2 + live_e * 3 * da_ * fa * 2 + ea * ca + ea * ca * da_ * 2)
        k1_arch = {
            "shape": f"x[{ea},{ca},{da_}] w[{ea},{da_},{fa}] occupied rows {rows}, live experts {live_e}",
            "max_abs_err": max(k1_layer_errs), "ms": graph_ms(lambda: k1._launch(xa, wga, wua, wda, rva), 20),
            "plain_ms": cuda_ms(lambda: k1.moe_gemm_plain(xa, wga, wua, wda, rva), 2, warmup=1),
            "library_ms": graph_ms(lambda: torch.bmm(F.silu(torch.bmm(xa, wga)) * torch.bmm(xa, wua), wda), 20),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        qa, ka, va, kwa = first["k4"]
        bq, hq, sq, dq = qa.shape
        kvh = ka.shape[1]
        b_ms, b_by = bound(4.0 * dq * bq * hq * sq * (sq + 1) / 2, 2 * (2 * bq * hq * sq * dq + 2 * bq * kvh * sq * dq))
        k4_arch = {
            "shape": f"q[{bq},{hq},{sq},{dq}] kv[{bq},{kvh},{sq},{dq}] causal, GQA group {hq // kvh}, the model's views",
            "max_abs_err": max(k4_layer_errs), "ms": graph_ms(lambda: k4._launch(qa, ka, va, **kwa), 50),
            "plain_ms": cuda_ms(lambda: plain_flash(qa, ka, va, **kwa), 10),
            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                qa, ka, va, is_causal=True, scale=kwa.get("prescale", 1.0) * dq**-0.5, enable_gqa=True), 50),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        arch_rows[arch] = {"moe_gemm_grouped": k1_arch, "flash_attention_fwd": k4_arch}
        for name, row in (("K1", k1_arch), ("K4", k4_arch)):
            print(f"{arch}: {name} inside the {ARCH_LAYERS}-layer bf16 prefill, on each layer's own inputs: "
                  f"max_abs_err {row['max_abs_err']:.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|) | layer 0's "
                  f"{row['shape']}: kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.3f} ms | "
                  f"{'torch.bmm SwiGLU' if name == 'K1' else 'SDPA'} {row['library_ms']:.4f} ms | bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {100 * row['bound_ms'] / row['ms']:.1f}% of bound "
                  f"({card})")
        del first, xa, wga, wua, wda, rva, qa, ka, va
        del amodel, ares, held_logits, host_rt
        gc.collect()
        torch.cuda.empty_cache()

    # the wire codecs on the virtual fabric: one full-width Mixtral MoE layer (the serving shape, B x S tokens)
    # under the serving controller's first table row, with wire_dtype bf16, fp8 and int8
    wcfg = dataclasses.replace(cfg, n_layers=1, moe=dataclasses.replace(cfg.moe, dispatch="phase_pipelined",
                                                                         use_pallas=True))
    wgen = torch.Generator(device=dev).manual_seed(7)
    wlayer = moe_layer.moe_init(wcfg, gen=wgen, device=dev, dtype=torch.bfloat16)
    xw = torch.randn((BATCH, PROMPT, cfg.d_model), generator=wgen, device=dev).to(torch.bfloat16)
    wrt, wscen = make_serving_controller(wcfg, n_ranks=VIRTUAL_RANKS, drift="none", device=dev)
    wrt.observe(demand_estimate(wcfg, float(BATCH * PROMPT * cfg.moe.top_k), wscen, 0))
    wrow = wrt.table().row(0)
    reset_counts()
    wire_out = {}
    for wire in ("bf16", "fp8", "int8"):
        c_ = dataclasses.replace(wcfg, moe=dataclasses.replace(wcfg.moe, wire_dtype=wire))
        y, st = moe_layer.moe_apply(wlayer, c_, xw, schedule=wrow, return_stats=True)  # the kernel path, counted
        k1_layer_errs.clear()
        k1_max = []

        def held_k1_max(*args):
            out = held_k1(*args)
            k1_max.append(float(out.abs().max()))
            return out

        with mock.patch.object(k1, "moe_gemm", held_k1_max):  # K1 on the layer's own (dequantized) slots
            y_held = moe_layer.moe_apply(wlayer, c_, xw, schedule=wrow)
        if not torch.equal(y_held, y):
            fail(f"wire {wire}: the held run differs from the kernel path")
        # kernel vs plain path with the combine leg's codec left out of both: K1's and its plain version's
        # outputs differ by a rounding, which the combine leg's codec can move across a whole step, so the layer
        # is held at K1's tolerance before wire_decode (the dispatch leg's codec runs in both, on the same x)
        with mock.patch.object(DenseFabric, "wire_decode", lambda self, ctx, packed, y_slots: y_slots):
            with mock.patch.object(k1, "moe_gemm", held_k1):
                y_pre = moe_layer.moe_apply(wlayer, c_, xw, schedule=wrow)
            with mock.patch.object(k1, "moe_gemm", k1.moe_gemm_plain):
                y_plain_pre = moe_layer.moe_apply(wlayer, c_, xw, schedule=wrow)
        x2 = xw.reshape(-1, cfg.d_model)
        idx, gates = moe_layer._router(wlayer, c_, x2)
        packed = DenseFabric().pack(FabricContext(cfg=c_, schedule=wrow), x2, idx, gates)
        share = float(packed.wire.sum() / packed.live.sum())
        step = get_codec(wire).max_step_over_amax * max(k1_max)
        diff = (y_pre.float() - y_plain_pre.float()).abs()
        worst = float((diff - BF16_TOL * y_plain_pre.float().abs()).max())
        print(f"wire {wire}: K1 on the layer's slots max_abs_err {k1_layer_errs[0]:.4g} (tol {BF16_TOL} + "
              f"{BF16_TOL}*|plain|) | layer kernel vs plain path before the combine leg's codec max "
              f"{float(diff.max()):.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|; the codec's largest step at the "
              f"largest expert output {step:.4g}) | slots on the wire {share:.4f} of the live | "
              f"dispatch {wire_bytes_per_token(cfg.d_model, wire):.0f} bytes a token")
        if not torch.isfinite(y).all() or worst > BF16_TOL:
            fail(f"wire {wire}: the layer's kernel path differs from its plain path beyond K1's tolerance")
        if wire == "bf16":
            if packed.wire is None or share <= 0:
                fail("wire: the table row marks no slot as crossing the virtual wire")
            ref_y, ref_st = y, st
        else:
            for key in ("routing", "dropped", "admitted"):
                if not torch.equal(st[key], ref_st[key]):
                    fail(f"wire {wire}: stats {key} differ from the bf16 wire's")
            err = float((y.float() - ref_y.float()).abs().max())
            tol = WIRE_REL_TOL[wire] * float(ref_y.float().abs().max())
            print(f"wire {wire}: vs the bf16 wire max abs {err:.4g} (tol {WIRE_REL_TOL[wire]} x max|bf16 output| = "
                  f"{tol:.4g}), stats routing/dropped/admitted equal the bf16 wire's bit for bit")
            if not 0 < err <= tol:
                fail(f"wire {wire}: error against the bf16 wire {err:.4g}, expected above 0 and at most {tol:.4g}")
            codec = get_codec(wire)
            qdq_ms = graph_ms(lambda: codec.apply(packed.buf, packed.wire), 50)
            gemm_ms = graph_ms(lambda: k1._launch(packed.buf, wlayer.w_gate, wlayer.w_up, wlayer.w_down, packed.live), 20)
            wire_out[wire] = {"max_err_vs_bf16": err, "qdq_ms": qdq_ms, "k1_ms": gemm_ms, "wire_share": share,
                              "bytes_per_token": wire_bytes_per_token(cfg.d_model, wire)}
            print(f"wire {wire}: QDQ of the packed buffer {list(packed.buf.shape)} {qdq_ms:.4f} ms (one leg) beside K1 "
                  f"on it {gemm_ms:.4f} ms ({card})")
    wire_launches = read_counts()
    print(f"wire codec layer launches (kernel path, one call a wire): {wire_launches}")
    if wire_launches["moe_gemm_grouped"] != 3:
        fail(f"wire codec layer: K1 launched {wire_launches['moe_gemm_grouped']} times, expected 3")
    del wlayer, xw, wrt, wrow, packed, y, y_held, y_pre, y_plain_pre, ref_y
    torch.cuda.empty_cache()
    print(f"phase 6d: {time.perf_counter() - t_phase:.1f} s wall ({card})")

    # the same prefill in f32, on all three prompt sets: the seeded model with f32
    # weights and activations.  K1 and K4 take bf16, so in both paths each runs on its
    # inputs rounded to bf16 and its output is widened again; the kernel path replays
    # the plain path's routing (top-k choices and gates), so no flipped choice stands
    # between the logits and the kernels.  What separates the paths is the bf16
    # roundings (of h, p and the outputs) that the kernels' f32 sum order flips, and
    # the later roundings those flips move: measured 5.8e-3 (PERF.md §6), so the
    # limit is the bf16 check's LOGITS_REL_TOL, now without a routing flip's excuse
    model32 = Model(mcfg, device=dev, dtype=torch.float32, seed=0)
    bf16 = torch.bfloat16

    def k1_island(gemm):
        def run(x, w_gate, w_up, w_down, row_valid):
            return gemm(x.to(bf16), w_gate.to(bf16), w_up.to(bf16), w_down.to(bf16), row_valid).float()
        return run

    def k4_island(attn):
        def run(q, k, v, *, causal=True, window=None, prescale=1.0):
            return attn(q.to(bf16), k.to(bf16), v.to(bf16), causal=causal, window=window, prescale=prescale).float()
        return run

    real_router, routes, moved = moe_layer._router, [], []

    def recording_router(p, cfg_, x):
        routes.append(real_router(p, cfg_, x))
        return routes[-1]

    def replaying_router(p, cfg_, x):
        idx, gates = routes[len(moved)]
        own = real_router(p, cfg_, x)[0]
        moved.append(int((own.sort(-1).values != idx.sort(-1).values).sum()))  # choices the kernel path would change
        return idx, gates

    f32_errs = []
    for i, p in enumerate(prompt_sets):
        label = "prompt set 0 (serving generator)" if i == 0 else f"prompt seed {MIXTRAL_EXTRA_PROMPT_SEEDS[i - 1]}"
        routes.clear()
        moved.clear()
        with mock.patch.object(moe_layer, "_router", recording_router), \
                mock.patch.object(k1, "moe_gemm", k1_island(k1.moe_gemm_plain)), \
                mock.patch.object(k4, "flash_attention", k4_island(plain_flash)):
            plain32 = prefill_logits(p, model32)
        with mock.patch.object(moe_layer, "_router", replaying_router), \
                mock.patch.object(k1, "moe_gemm", k1_island(k1._launch)), \
                mock.patch.object(k4, "flash_attention", k4_island(k4._launch)):  # comparison launches: not counted
            kernel32 = prefill_logits(p, model32)
        if len(routes) != LAYERS or len(moved) != LAYERS or not (torch.isfinite(plain32).all() and torch.isfinite(kernel32).all()):
            fail(f"Mixtral f32 prefill ({label}): routing replayed in {len(moved)} of {LAYERS} layers, or non-finite logits")
        f32_errs.append(row_rel(kernel32, plain32))
        print(f"{label}: f32 prefill logits kernel vs plain path (K1 and K4 on bf16-rounded inputs, routing replayed): "
              f"max row rel L2 {f32_errs[-1]:.3g} (tol {LOGITS_REL_TOL}); top-k choices the kernel path's own "
              f"routing would have changed: {sum(moved)} of {LAYERS * BATCH * PROMPT * cfg.moe.top_k}")
        if f32_errs[-1] > LOGITS_REL_TOL:
            fail(f"f32 prefill logits of the kernel path differ from the plain path ({label}): rel L2 "
                 f"{f32_errs[-1]:.3g}, tol {LOGITS_REL_TOL}")
    del model32, plain32, kernel32, prompt_sets, routes
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

    # 8b (run before 8, so no profiler session precedes its timing). the
    # fault-tolerant train loop: full-width Mixtral-8x7B cut to 1 layer
    # through train_loop (fused device-controller step, ef8, chunked
    # attention, checkpoints, one injected fault, a resumed second call)
    loop_launches = train_loop_phase(tcfg)

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
    with torch.profiler.profile(activities=activities) as prof:
        traced = train(model, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ, virtual_ranks=VIRTUAL_RANKS, peak_lr=PEAK_LR, warmup=WARMUP)
    trace_report(prof, traced.step_ms[0], "train step trace", {
        "K2/K3 silu_grads": {"k23_silu_grads_kernel"}, "K2 dgrad": {"k2_dgrad_kernel"},
        "K3 wgrad": {"k3_wgrad_gate_up_kernel", "k3_wgrad_down_kernel"}, "K1 gate_up": {"k1_gate_up_kernel"},
        "K1 down": {"k1_down_kernel"}, "cuBLAS GEMM": cublas, "elementwise and reductions": elementwise,
    })
    del model
    torch.cuda.empty_cache()
    train_loop_step_trace(tcfg)

    # K4's and SDPA's device times at the prefill shape, and where the time of
    # one more bf16 Mixtral prefill goes (the serving model again, its table)
    q, k, v, qs = k4_inputs  # sdpa() and k4_call() read them
    (k4_dev, k4_names), (sdpa_dev, sdpa_names) = device_ms(k4_call), device_ms(sdpa)
    k4_row.update(device_ms=k4_dev, library_device_ms=sdpa_dev)
    print(f"K4 prefill device time in a trace: kernel {k4_dev} ms ({', '.join(k4_names)}), "
          f"SDPA {sdpa_dev} ms ({', '.join(sdpa_names)}) (bound {k4_row['bound_ms']:.4f} ms)")
    del q, k, v, qs, k4_inputs
    model = Model(mcfg_serve, device=dev, seed=0)
    caches = model.init_cache(BATCH, PROMPT)
    model.prefill(prompts, caches, schedule=res.table)
    caches = model.init_cache(BATCH, PROMPT)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        model.prefill(prompts, caches, schedule=res.table)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    serve_groups = {
        "K1 gate_up": {"k1_gate_up_kernel"}, "K1 down": {"k1_down_kernel"}, "K4 flash": {"k4_flash_fwd_kernel"},
        "cuBLAS GEMM": cublas, "elementwise and reductions": elementwise,
    }
    trace_report(prof, wall, "mixtral prefill trace", serve_groups)
    del caches, prompts

    # where the engine's time goes (6c's path on the same seeded model): one
    # short run traced whole (8 requests at once, pool A), then graph replays
    # of its last decode step, then one prefill per bucket
    from repro_torch.serve import Request, ServeEngine

    def traced(what: str, fn) -> dict:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return trace_report(prof, wall, f"{what} ({card})", serve_groups)

    trng = np.random.default_rng(ENGINE_SEED)
    prompts_ = [trng.choice(engine_pool, n) for n in ENGINE_TRACE_PROMPTS]
    eng = ServeEngine(mcfg_serve, model, **ENGINE_KW)
    eng.run([Request(prompt=p_, max_new_tokens=ENGINE_TRACE_NEW) for p_ in prompts_])  # captures the graph
    steps0, replans0 = eng.metrics()["serve"]["decode_steps"], len(eng.replan_log)
    traced(f"engine run trace ({len(prompts_)} requests of {ENGINE_TRACE_NEW} new tokens at once)",
           lambda: eng.run([Request(prompt=p_, max_new_tokens=ENGINE_TRACE_NEW) for p_ in prompts_]))
    print(f"  engine run trace: {eng.metrics()['serve']['decode_steps'] - steps0} decode steps, "
          f"{len(eng.replan_log) - replans0} re-plans, {len(prompts_)} prefills")
    k1_us = traced(f"engine decode graph, {ENGINE_TRACE_REPLAYS} replays",
                   lambda: [eng._graph.replay() for _ in range(ENGINE_TRACE_REPLAYS)])
    k1_replay = [v for g in ("K1 gate_up", "K1 down") for v in k1_us.get(g, [])]
    print(f"  engine decode graph: K1 {sum(k1_replay) / 1e3 / ENGINE_TRACE_REPLAYS:.4f} ms a replay "
          f"({len(k1_replay)} kernels in {ENGINE_TRACE_REPLAYS} replays; 0 means the trace shows no kernel "
          f"inside a replay) ({card})")
    for bucket in ENGINE_KW["buckets"]:
        req = next(r for r in (Request(prompt=p_, max_new_tokens=1) for p_ in prompts_)
                   if eng.queue.bucket_of(r.prefill_len) == bucket)
        traced(f"engine prefill bucket {bucket} (prompt {len(req.prompt)}, batch 1)",
               lambda: eng._prefill_row(req, bucket))
    del eng, model
    torch.cuda.empty_cache()

    # 9. K5 at the RWKV6-7B prefill shape from S = 0 (two decay draws: the
    # model's range exp(-exp(-2 + noise)) and the JAX test's 0.45-0.95),
    # then T = 1 and T = 37 from the carried state
    rcfg = get_config("rwkv6-7b")
    hd5, h5, b5 = rcfg.rwkv_head_dim, rcfg.d_model // rcfg.rwkv_head_dim, RWKV_BATCH
    wgen = torch.Generator(device=dev).manual_seed(2)

    def wkv_inputs(t: int, wide_w: bool):
        shape = (b5, h5, t, hd5)
        r, k, v = (torch.randn(shape, generator=wgen, device=dev).to(torch.bfloat16) for _ in range(3))
        noise = torch.randn(shape, generator=wgen, device=dev)
        w = torch.sigmoid(noise) * 0.5 + 0.45 if wide_w else torch.exp(-torch.exp(-2.0 + 0.5 * noise))
        return r, k, v, w

    def close_f32(out, ref, what: str) -> float:
        if not torch.isfinite(out).all():
            fail(f"{what}: non-finite output")
        err = (out - ref).abs()
        if float((err - WKV_TOL * ref.abs()).max()) > WKV_TOL:
            fail(f"{what}: max |kernel - plain| {float(err.max()):.4g} beyond {WKV_TOL} + {WKV_TOL}*|plain|")
        return float(err.max())

    def wkv_cost(t: int, carried: bool) -> tuple[float, str]:
        n = b5 * h5 * t * hd5
        state = b5 * h5 * hd5 * hd5 * 4
        nbytes = 3 * n * 2 + n * 4 + h5 * hd5 * 4 + n * 4 + state * (2 if carried else 1)
        # 5 D^2 FLOP per (b, h, t) is the least this recurrence takes in f32: w * s + k * v (a MUL and an
        # FMA) for the state and r * s (an FMA) for y, once the u term is one scalar per step (c_t v_j)
        return bound(5.0 * hd5 * hd5 * b5 * h5 * t, nbytes, PEAK_F32_FLOPS)

    u5 = torch.randn((h5, hd5), generator=wgen, device=dev) * 0.1
    k5_err, k5_rows = 0.0, {}
    for label, wide in (("0.45-0.95 w", True), ("model-range w", False)):  # the model-range inputs stay for timing
        r, k, v, w = wkv_inputs(RWKV_PROMPT, wide)
        y, s_carried = k5.wkv6(r, k, v, w, u5)  # the wrapper, as the model calls it
        torch.cuda.synchronize()
        y_ref, s_ref = k5.wkv6_plain(r, k, v, w, u5)
        err = max(close_f32(y, y_ref, f"K5 prefill ({label}) y"), close_f32(s_carried, s_ref, f"K5 prefill ({label}) S"))
        k5_err = max(k5_err, err)
        print(f"K5 prefill ({label}): y and S_final max_abs_err {err:.3g} (tol {WKV_TOL} + {WKV_TOL}*|plain|), "
              f"max |y| {float(y_ref.abs().max()):.4g}")
    b_ms, b_by = wkv_cost(RWKV_PROMPT, False)
    k5_rows["prefill"] = {
        "shape": f"r/k/v[{b5},{h5},{RWKV_PROMPT},{hd5}] bf16, w f32, S from 0",
        "ms": cuda_ms(lambda: k5._launch(r, k, v, w, u5, None), 20),
        "plain_ms": cuda_ms(lambda: k5.wkv6_plain(r, k, v, w, u5), 2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    for t in (1, 37):
        r, k, v, w = wkv_inputs(t, False)
        y, s_fin = k5.wkv6(r, k, v, w, u5, s_carried)
        torch.cuda.synchronize()
        y_ref, s_ref = k5.wkv6_plain(r, k, v, w, u5, s_carried)
        err = max(close_f32(y, y_ref, f"K5 T={t} carried y"), close_f32(s_fin, s_ref, f"K5 T={t} carried S"))
        k5_err = max(k5_err, err)
        print(f"K5 T={t} from the carried state: y and S_final max_abs_err {err:.3g} (tol {WKV_TOL} + {WKV_TOL}*|plain|)")
    b_ms, b_by = wkv_cost(1, True)
    k5_rows["decode"] = {
        "shape": f"r/k/v[{b5},{h5},1,{hd5}] bf16, w f32, S carried",
        "ms": cuda_ms(lambda: k5._launch(r[:, :, :1], k[:, :, :1], v[:, :, :1], w[:, :, :1], u5, s_carried), 200),
        "plain_ms": cuda_ms(lambda: k5.wkv6_plain(r[:, :, :1], k[:, :, :1], v[:, :, :1], w[:, :, :1], u5, s_carried), 50),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    for label, row in k5_rows.items():
        print(f"K5 {label}: {row['shape']} | kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
              f"library: none | bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    del r, k, v, w, y, y_ref, s_fin, s_ref, s_carried, u5

    # 10. serve full-width RWKV6-7B at all 32 layers: the third slice's main path
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    rmodel = Model(rcfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(prm.numel() for prm in rmodel.parameters())
    param_gb = sum(prm.numel() * prm.element_size() for prm in rmodel.parameters()) / 1e9
    print(f"rwkv model: {rcfg.name} {rcfg.n_layers} layers, {n_params / 1e9:.3f} B params ({param_gb:.2f} GB; "
          f"{before_gb:.2f} GB was allocated before), init {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rres = serve(rmodel, batch=RWKV_BATCH, prompt_len=RWKV_PROMPT, new_tokens=RWKV_NEW, rounds=RWKV_ROUNDS,
                 controller=True, seed=0)
    rwkv_launches = read_counts()
    rpeak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = dict.fromkeys(COUNTED, 0)
    expect["wkv6"] = RWKV_ROUNDS * (1 + RWKV_NEW) * rcfg.n_layers
    for r in range(RWKV_ROUNDS):
        print(
            f"rwkv serve round {r}: prefill {rres.prefill_ms[r]:.1f} ms "
            f"({RWKV_BATCH * RWKV_PROMPT / rres.prefill_ms[r] * 1e3:.0f} tok/s) | decode {rres.decode_ms[r]:.1f} ms "
            f"({rres.decode_tok_s(RWKV_BATCH, RWKV_NEW)[r]:.1f} tok/s, {rres.decode_ms[r] / RWKV_NEW:.2f} ms/step)"
        )
    print(f"rwkv serve peak memory allocated: {rpeak_gb:.2f} GB ({rpeak_gb - before_gb:.2f} GB above what was "
          f"allocated before the model)")
    print(f"rwkv serve launches: {rwkv_launches} (expected {expect})")
    if rwkv_launches != expect:
        fail(f"RWKV serving path launches {rwkv_launches}, expected {expect}")
    if rres.table is not None or (rres.admitted, rres.dropped, rres.routed) != (0.0, 0.0, 0.0):
        fail(f"RWKV serving planned a table or counted MoE choices: {rres.admitted}, {rres.dropped}, {rres.routed}")
    if rres.tokens.shape != (RWKV_ROUNDS, RWKV_BATCH, RWKV_NEW) or int(rres.tokens.min()) < 0 \
            or int(rres.tokens.max()) >= rcfg.vocab_size:
        fail(f"RWKV generated tokens out of range or misshapen: {tuple(rres.tokens.shape)}")
    if rres.first_logits.shape != (RWKV_BATCH, rcfg.vocab_size) or not torch.isfinite(rres.first_logits).all():
        fail("RWKV prefill logits misshapen or non-finite")

    # kernel path vs plain path, prefill at a shorter prompt.  In bf16 the 32
    # random-weight layers amplify any difference in the recurrence's f32
    # sum order through flipped bf16 roundings (a 1e-7 relative change of y
    # moves the logits by ~0.1), so (a) K5 is held against its plain version
    # on every layer's own inputs inside the bf16 prefill, (b) the bf16
    # logits gap is held within RWKV_BF16_NOISE_MULT times that noise floor,
    # measured here, and (c) the logits are held kernel vs plain on the same
    # seeded model in f32.
    rprompts = torch.randint(0, rcfg.vocab_size, (RWKV_BATCH, RWKV_CHECK_PROMPT), generator=wgen, device=dev)

    def rwkv_prefill_logits(m):
        return m.prefill(rprompts, m.init_cache(RWKV_BATCH, RWKV_CHECK_PROMPT, m.dtype))[0].float()

    layer_errs = []

    def held_wkv6(r, k, v, w, u, s0=None):
        y, s_fin = k5._launch(r, k, v, w, u, s0)  # a comparison launch: not counted
        y_ref, s_ref = k5.wkv6_plain(r, k, v, w, u, s0)
        n = len(layer_errs)
        layer_errs.append(max(close_f32(y, y_ref, f"K5 in layer {n} y"), close_f32(s_fin, s_ref, f"K5 in layer {n} S")))
        return y, s_fin

    with mock.patch.object(k5, "wkv6", held_wkv6):
        kernel_logits = rwkv_prefill_logits(rmodel)
    if len(layer_errs) != rcfg.n_layers or not torch.isfinite(kernel_logits).all():
        fail(f"RWKV bf16 prefill: K5 held in {len(layer_errs)} of {rcfg.n_layers} layers, or non-finite logits")
    print(f"K5 inside the {rcfg.n_layers}-layer bf16 prefill (prompt {RWKV_CHECK_PROMPT}), on each layer's own "
          f"strided inputs: max_abs_err {max(layer_errs):.3g} (tol {WKV_TOL} + {WKV_TOL}*|plain|)")
    with mock.patch.object(k5, "wkv6", k5.wkv6_plain):
        plain_logits = rwkv_prefill_logits(rmodel)
    ngen = torch.Generator(device=dev).manual_seed(3)

    def perturbed_plain(*args):
        y, s_fin = k5.wkv6_plain(*args)
        return y * (1 + 1e-7 * torch.randn(y.shape, generator=ngen, device=dev)), s_fin

    with mock.patch.object(k5, "wkv6", perturbed_plain):
        noise_logits = rwkv_prefill_logits(rmodel)
    rel, floor = row_rel(kernel_logits, plain_logits), row_rel(noise_logits, plain_logits)
    print(f"rwkv bf16 prefill logits (prompt {RWKV_CHECK_PROMPT}): kernel vs plain path max row rel L2 {rel:.3g} "
          f"(tol {RWKV_BF16_NOISE_MULT} x the noise floor), same argmax "
          f"{int((kernel_logits.argmax(-1) == plain_logits.argmax(-1)).sum())}/{RWKV_BATCH}; the noise floor, plain "
          f"vs plain with y * (1 + 1e-7 N(0, 1)): {floor:.3g}")
    if not torch.isfinite(plain_logits).all() or rel > RWKV_BF16_NOISE_MULT * floor:
        fail(f"RWKV bf16 prefill logits of the kernel path differ from the plain path by {rel:.3g}, more than "
             f"{RWKV_BF16_NOISE_MULT} x the noise floor {floor:.3g}")
    del kernel_logits, plain_logits, noise_logits

    # where RWKV serving time goes: one more prefill, then 8 decode steps, each traced
    rwkv_groups = {"K5 wkv6": {"wkv6_kernel"}, "cuBLAS GEMM": cublas, "elementwise and reductions": elementwise}
    caches = rmodel.init_cache(RWKV_BATCH, RWKV_PROMPT + 8)
    prompts = torch.randint(0, rcfg.vocab_size, (RWKV_BATCH, RWKV_PROMPT), generator=wgen, device=dev)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        logits, caches = rmodel.prefill(prompts, caches)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    trace_report(prof, wall, "rwkv prefill trace", rwkv_groups)
    token = torch.argmax(logits, dim=-1)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(8):
            logits, caches = rmodel.decode_step(token, caches, RWKV_PROMPT + i)
            token = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    k5_us = trace_report(prof, wall, "rwkv decode trace (8 steps)", rwkv_groups).get("K5 wkv6", [])
    # back to back, the wrapper's host work outlasts this small kernel, so the
    # CUDA-event time above is the host's; the trace gives the device's own
    k5_rows["decode"]["device_ms_in_trace"] = sum(k5_us) / len(k5_us) / 1e3 if k5_us else None
    if k5_us:
        print(f"K5 decode device time in the trace: {sum(k5_us) / len(k5_us) / 1e3:.4f} ms per launch "
              f"({len(k5_us)} launches; bound {k5_rows['decode']['bound_ms']:.4f} ms)")
    del rmodel, caches, logits
    torch.cuda.empty_cache()

    # the same seeded 32-layer model in f32 (30 GB): kernel path vs plain path
    fmodel = Model(rcfg, device=dev, dtype=torch.float32, seed=0)
    kernel_logits = rwkv_prefill_logits(fmodel)
    with mock.patch.object(k5, "wkv6", k5.wkv6_plain):
        plain_logits = rwkv_prefill_logits(fmodel)
    rel = row_rel(kernel_logits, plain_logits)
    same_top1 = int((kernel_logits.argmax(-1) == plain_logits.argmax(-1)).sum())
    print(f"rwkv f32 prefill logits kernel vs plain path ({rcfg.n_layers} layers, prompt {RWKV_CHECK_PROMPT}): "
          f"max row rel L2 {rel:.3g} (tol {RWKV_F32_LOGITS_TOL}), max abs {(kernel_logits - plain_logits).abs().max().item():.3g}, "
          f"same argmax {same_top1}/{RWKV_BATCH}")
    if not torch.isfinite(kernel_logits).all() or rel > RWKV_F32_LOGITS_TOL:
        fail(f"RWKV f32 prefill logits of the kernel path differ from the plain path: rel L2 {rel:.3g}")
    del fmodel, kernel_logits, plain_logits
    torch.cuda.empty_cache()

    # 11. the kernels line, then the result line
    path_launches = {
        name: {"serve": launches[name], "serve_drift": drift_launches[name], "serve_engine": engine_launches[name],
               **{f"serve_{arch}": arch_launches[arch][name] for arch in ARCHS}, "wire_codecs": wire_launches[name],
               "knee": knee_launches[name], "train": train_launches[name], "train_loop": loop_launches[name],
               "rwkv_serve": rwkv_launches[name]}
        for name in COUNTED
    }
    kernels = [
        dict(
            name="moe_gemm_grouped", route="cuda", source="src/repro_torch/csrc/moe_gemm.cu",
            replaces="src/repro/kernels/moe_gemm/kernel.py:101",
            launches=sum(path_launches["moe_gemm_grouped"].values()),
            launches_by_path=path_launches["moe_gemm_grouped"],
            **{key: k1_rows["prefill"][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops")},
            shape=k1_rows["prefill"]["shape"], decode=k1_rows["decode"], knee=knee, wire_codecs=wire_out,
            **{arch: arch_rows[arch]["moe_gemm_grouped"] for arch in ARCHS},
        ),
        dict(
            name="flash_attention_fwd", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:77",
            launches=sum(path_launches["flash_attention_fwd"].values()),
            launches_by_path=path_launches["flash_attention_fwd"],
            **{key: k4_row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            shape=k4_row["shape"],
            **{key: k4_row[key] for key in K4_EXTRA_KEYS + ("model_call_max_abs_err",)},
            **{arch: arch_rows[arch]["flash_attention_fwd"] for arch in ARCHS},
        ),
        *(
            dict(
                name=f"moe_gemm_grouped_{name}", route="cuda", source="src/repro_torch/csrc/moe_gemm_bwd.cu",
                replaces=f"src/repro/kernels/moe_gemm/kernel.py:{line}",
                launches=sum(path_launches[f"moe_gemm_grouped_{name}"].values()),
                launches_by_path=path_launches[f"moe_gemm_grouped_{name}"],
                **{key: k23_rows[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                                                        "tflops", "launch_ms")},
                **{key: k23_rows[name][key] for key in ("launch_library_ms", "launch_bound_ms", "launch_bound_by")
                   if key in k23_rows[name]},
            )
            for name, line in (("dgrad", 272), ("wgrad", 327))
        ),
        dict(
            name="moe_gemm_ungrouped", route="cuda", source="src/repro_torch/csrc/moe_gemm.cu",
            replaces="src/repro/kernels/moe_gemm/kernel.py:394", launches=k3b_path["moe_gemm_ungrouped"],
            launches_by_path={"ungrouped forward + backward": k3b_path["moe_gemm_ungrouped"],
                              **path_launches["moe_gemm_ungrouped"]},
            **{key: k3b_row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "tflops")},
        ),
        dict(
            name="wkv6", route="cuda", source="src/repro_torch/csrc/rwkv_wkv.cu",
            replaces="src/repro/kernels/rwkv_wkv/kernel.py:54", launches=sum(path_launches["wkv6"].values()),
            launches_by_path=path_launches["wkv6"], max_abs_err=k5_err, library_ms=None,
            **k5_rows["prefill"], decode=k5_rows["decode"],
        ),
    ]
    # this slice's new numbers, each on its own line beside the card
    for key in K4_EXTRA_KEYS:
        print(f"K4 {key}: {k4_row[key]} ({card})")
    for name, row in k23_rows.items():
        for launch, ms in row["launch_ms"].items():
            print(f"K{2 if name == 'dgrad' else 3} launch_ms {launch}: {ms} ({card})")
    for key in ("launch_library_ms", "launch_bound_ms"):
        print(f"K2 dgrad {key}: {k23_rows['dgrad'][key]} ({card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()

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
   router's b = 4096 point; beside K1, ``torch.bmm`` SwiGLU over the same
   live rows (ceil(b / E) an expert) at b = 1, 4, 16, 64 and 4096, timed
   the same way (the library call); then Mixtral's Fig. 3 (``mmlu``) and Fig. 4
   (``speed``) tables under the fitted device-time model and under the
   paper's ``knee_model()``, with fig3's two ratios;
6. serve full-width Mixtral-8x7B cut to 4 layers (random weights from a
   seed) through the scheduled MoE path: the controller plans a table
   (drift "none": a cold plan in round 0, kept in round 1), prefill,
   greedy decode, 2 rounds; the kernels' launch counts are reset just
   before and read just after; then, on three prompt sets, K1 and K4 are held
   against their plain versions on every layer's own inputs inside a bf16
   prefill (K4, wherever it is held, also to a relative L2 of ``K4_REL_L2``
   over each (b, head), printed beside the median |plain|) and the prefill logits of the kernel path against the plain
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
   layer's own inputs inside a bf16 prefill (``serve_and_hold``, which
   phase 12 shares); each model freed before the next.  Then one full-width Mixtral MoE layer (4 x 256 tokens) under the
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
   the plain path on the same seeded model in f32;
9b. (run after 9) K5b (the recurrence's backward, ``csrc/rwkv_wkv_bwd.cu``)
   against its plain version at the training shape r/k/v [4, 64, 1024, 64]:
   bf16 in the model's strided views from S = 0, f32 from a carried s0
   with a nonzero dS_final, and decays near 0 and near 1; each gradient
   within 1e-3 relative L2 and 1e-3 x max |plain| (printed), with K5b's
   time (its two launches: the sweep of the state and its gradient over
   the chunk edges, then each chunk's gradients) beside its bound (14 D^2
   f32 FLOP per step and head), the plain version's and K5's forward on
   the same inputs;
10b. the ``long_500k`` cell (``launch/shapes.py``) on the same 32-layer
   model: ``cell_applicable`` for every ported config (True for the
   ``subquadratic`` ones), then ``long_cell``: the RWKV state of
   ``init_cache(1, 524288)`` in the bytes of ``init_cache(1, 1024)``, a
   1024-token prompt at batch 1 prefilled once with K5 held against its
   plain version in every layer (the logits equal to the counted
   prefill's bit for bit), then 16 one-token decode steps at step
   524287 + i in ``input_specs``' shapes, with ms a step and exact K5
   launches (the cell is never prefilled at 524288 tokens);
11. train full-width RWKV6-7B: a train step at 1 layer, kernel path (K5,
   K5b) against the plain path (loss within 2e-2 relative, each gradient
   leaf within 2e-2 relative L2, K5 twice and K5b once); then 4 of 32
   layers (1.42 B parameters, f32 masters, bf16 compute, remat per
   block, AdamW) through ``launch/train.py``'s ``train`` at batch 4 x 1024
   for 8 steps, counts reset just before and read just after (K5 2 x
   layers x steps, K5b layers x steps, every other kernel 0); the losses
   must be finite and the mean of the last two below step 0's, peak memory
   under 80 GB; one more step traced by kernel group;
12. serve the seven configs the twelfth slice ports at full width with
   seeded weights through ``serve_and_hold`` (one round, the controller on), each
   freed before the next (``SLICE12``): Jamba-1.5-Large cut to layers 0-4
   (Mamba at 0-3 through K6, MoE at 1 and 3 through K1 under a planned
   table, attention at 4; batch 4 x 256, 8 new tokens), h2o-danube-3-4b
   at all 24 layers (batch 1 x a 4608-token prompt, past its 4096-token
   window, then 16 decode steps: K4 at head dim 120 with the window),
   qwen2-1.5b (tied, QKV bias), granite-3-8b, granite-34b cut to 8 layers
   (GELU, MQA: K4 at group 48), internvl2-26b and musicgen-large (256
   prefix embeddings from the seed; musicgen's sinusoidal positions), the
   dense ones at batch 4 x 256 with 8 new tokens.  Launch counts exact (K4
   once per attention layer, K6 and K1 once per Mamba / MoE layer for the
   prefill and each decode step, every other kernel 0); then K4, K6 (f32 on
   both sides, ``WKV_TOL``) and K1 held against their plain versions on
   every layer's own inputs inside a bf16 prefill of fresh prompts, and the
   logits of the kernel path against the plain path within the larger of
   ``LOGITS_REL_TOL`` and twice the noise floor (the plain path with K4's
   f32 output scaled by 1 + 1e-7 N(0, 1)); with a window, the plain
   version with the window's edge moved by one 64-key tile must read above
   ``K4_REL_L2``, so the per-head check can see such a fault; K4 (beside SDPA), K6 at prefill
   and at one decode step (in place on the carried state), and Jamba's K1
   (beside ``torch.bmm`` SwiGLU) timed at the shapes of the first layer
   that runs each, beside their plain versions and bounds (K6's the
   largest of bytes, f32 FLOPs and
   exponentials at 16 a clock an SM); each config's serving times, peak
   memory and the phase's wall time;
12b. (inside 12, on Jamba's and h2o-danube's models before they are
   freed) the model behind ``ServeEngine`` (``ENGINE_KW``: 8 slots,
   buckets 64/128/256, under h2o-danube's 4096 window; Jamba's device
   controller on, none for the dense config), 3 phases of 8 requests at
   once with prompts in all three buckets: every request completes, one
   decode graph serves the run, the replay equals the eager step on copies
   bit for bit at the first 2 steps of each phase, with K6 and K1 held
   against their plain versions in every layer of those eager steps; the
   first batch-1 prefill of each bucket run again with K4, K6 and K1 held
   in every layer must give the served row bit for bit; Jamba prefills at
   the exact prompt length (a recurrent state would absorb a bucket's
   padding), so one padded prompt's admitted slot must hold an
   exact-length prefill's recurrent leaves (every Mamba layer's ``h`` and
   conv tail) bit for bit, and the prefill shapes counted are the prompt
   lengths (h2o-danube's: the buckets); K4 (attention
   layers x prefills), K6 and K1 (Mamba / MoE layers x (prefills + decode
   steps + the capture's warm-up)) launch exactly, K6 and K1 among the
   capture's launches (at decode they run inside the replay);
10c. (inside 12, after 12b on the same models) the ``long_500k`` cell
   through 10b's ``long_cell``: h2o-danube's ``init_cache(1, 524288)`` in the bytes of
   ``init_cache(1, 4096)`` (the ring holds the window; the 1024-token
   prompt lies outside the window at 524287, so each step sees only the
   decoded tokens, which is what ``attn_full`` computes there), Jamba's
   Mamba state O(1) and its one attention layer at 524288 positions
   (printed), then a 1024-token prompt at batch 1 and 16 steps at
   524287 + i (Jamba's at 524272 + i, so they stay inside the cell's
   524288 positions, which its attention cache holds) with exact K4, K6
   and K1 launches, the prefill once more with K4, K6 and K1 held in every
   layer (its logits equal to the counted prefill's bit for bit);
13. training (``TRAIN13``): Jamba-1.5-Large cut to layer 0 (Mamba and the
   dense SwiGLU, 2.1 B parameters) and qwen2-1.5b at all 28 layers, each
   through ``launch/train.py``'s ``train`` at batch 4 x 1024 for 8 AdamW
   steps (f32 masters, bf16 compute, remat per block): losses finite and
   the mean of the last two below step 0's, peak memory under 80 GB, K6
   2 x Mamba layers x steps and K6b Mamba layers x steps (every other
   kernel 0); before Jamba's run, one train step of the kernel path (K6,
   K6b) against the plain path (loss within 2e-2 relative, each leaf within
   2e-2 relative L2), and K6b (``csrc/mamba_scan_bwd.cu``) held against
   ``selective_scan_bwd_plain`` on the inputs of that step's scan backward
   (each gradient within 1e-3 relative L2 and 1e-3 x max |plain|, two runs
   equal bit for bit), timed as a CUDA graph replay beside its bound (the
   function's least traffic, no checkpoints, or one exponential a state
   and step) and this design's own traffic (checkpoints, partial sums), the
   plain version; with ``K6B_OLD_SOURCE`` set (a directory holding an
   earlier design's ``mamba_scan_bwd.cu``, same C interface) that design
   too, held against the plain version and timed in turns (old, new, new,
   old) on the same inputs, and the run fails unless the current design is
   the faster; K6 on the same scan inputs held against its plain
   version (``WKV_TOL``) and timed without and with checkpoints beside its
   bound (the exponentials), its row under ``train`` in the kernels line;
   one more step of each traced by kernel group.  Phases 11 and 13 share
   ``train_step_vs_plain`` and ``train_and_check``.
14. expert parallelism across ranks (``parallel.sharding``,
   ``parallel.collectives``, the fabrics): 4 ranks spawned on the one
   card, gloo with CUDA tensors (NCCL refuses ranks sharing a card), the
   kernels built by this process first.  14a: one full-width Mixtral MoE
   layer (8 experts of 4096 x 14336, top-2, ``EP_CAPACITY`` as JAX's
   parity matrix), x [4, 2048, 4096] bf16 (2048 tokens a rank, 2 experts a
   rank), forward and backward on ``dense`` (its EP form), ``a2a``,
   ``ppermute`` (a max-weight plan of the real routing), ``phase_pipelined``
   and ``ragged_a2a`` (that plan's table row), ``hierarchical`` (the
   two-level plan of the same traffic, ``hierarchical_plan``: two pods of
   two, and one pod of four, where every pair is intra; each also under the
   fp8 wire, which must leave one pod's output and gradients bit for bit
   and engage for two pods within ``WIRE_REL_TOL`` of the bf16 wire's
   output) and ``faulty:phase_pipelined``
   (a dead link the plan made under its mask avoids: equal to the
   unwrapped fabric bit for bit; one the plan routes: refused with
   ``FabricFaultError``): each against one process's dense fabric on the
   whole layer (each rank computes it in turn; K1/K2/K3 in both): the
   output within K1's tolerance, each expert's gradients and the router's
   and the input's partial gradients summed over the ranks within
   ``GRAD_REL_TOL`` relative L2 (a fabric sums an expert's bf16 gradient
   over several launches, the reference rounds one sum); ``routing`` summed
   over the ranks equal to the reference's, nothing dropped, ``ragged_a2a``
   equal to ``phase_pipelined`` bit for bit, every K1 launch and every
   K2/K3 launch pair of every fabric call on every rank held against the
   plain versions on its own inputs afterwards, a rank at a time (K1 and
   K2 within ``BF16_TOL``, K3 within ``WGRAD_REL_L2``/``WGRAD_MAX_REL``,
   as in phase 5), K1/K2/K3 launches and holds exact on every rank, the slots each rank sent against the
   fabric's ``dispatch_tokens`` (``phase_pipelined``: its emulation's
   ``dispatch_tokens_padded``; ``hierarchical``: its intra child's padded
   count plus its inter child's exact one); ms a forward layer call.  14b: the launcher
   (``serve``) across the 4 ranks, 2-layer full-width Mixtral-8x7B under
   ``phase_pipelined`` with the controller (B = 4, prompt 256, 8 new
   tokens, 2 rounds, capacity 1.25): every rank's tokens and tables equal,
   decode on the dense fabric's EP form (the layer-call counter), K1 held
   per layer on rank 0 in a prefill of round 0 that must give the served
   logits bit for bit, K1/K4 launches exact, and the first prefill's
   logits against one process's run of the same seeded model with the
   EP run's sources (the sequence chunks) in its admission and a bucket
   that cuts nothing (``EP_CAPACITY``; neither run may cut a choice),
   within ``LOGITS_REL_TOL`` per row.  Every time is labelled as ranks sharing
   one card over gloo, staged through host memory: not a fabric's time.
   14c (one process; run right after 6c, on its model): the same 4-layer
   full-width Mixtral behind ``ServeEngine`` with ``dispatch="hierarchical"``
   (``HIER_POD_SIZE`` over 6c's 8 virtual ranks, ``HIER_ENGINE_KW``): the
   two-level device controller stepped inside the decode graph, two phases
   of ``HIER_REQUESTS`` requests from 6c's token pools; all complete, a CPU
   twin of both levels fed the routing the engine copied out ends each
   phase in the card's state, the replay equals the eager step on copies
   bit for bit at each phase's first step and after each re-plan (K1 held
   in every layer of those steps), one prefill a bucket again with K1 and
   K4 held must give the served row, launches exact; decode ms a step and
   prefill ms a bucket printed (``hier_engine`` in the kernels line).
15. training across ranks (``parallel.data_parallel``, the world path of
   ``train_loop`` and ``CheckpointManager``): ``TW_RANKS`` ranks spawned on
   the one card (gloo), laid out as (data, model) ``TW_LAYOUT``, train
   full-width Mixtral-8x7B cut to 1 layer (f32 masters, bf16 compute, remat
   per block, ``phase_pipelined`` under ``plan_table``'s lossless table over
   the model group; ``TW_BATCH`` x ``TW_SEQ`` tokens, each data group its
   rows) for ``TW_STEPS`` AdamW steps through ``train_loop``: the loss finite,
   falling and the same on every rank; a second run with a failure on rank
   ``TW_FAULT_RANK`` alone at step ``TW_FAULT_AT`` (first attempt), which
   every rank rolls back to the step-``TW_CKPT_EVERY`` checkpoint, ending at
   the clean run's final loss within ``TW_LOSS_RTOL`` (bit-equality of every
   step printed); then the latest checkpoint restored onto ``TW_LAYOUT_B``
   (``regroup``) for ``TW_MORE_STEPS`` more steps, losses finite.  Every K1
   launch and K2/K3 launch pair of each rank's first step is held against
   the plain versions (``_hold_in_turns``; the outputs kept on the host, each
   step's bf16 weight copies once), and K1/K2/K3 launch 2/1/1 times for
   every expert block of every executed step (the table's live phase slots
   and the local block); ``train_world`` in the kernels line.  Checkpoints
   (20.6 GB: the whole model's f32 parameters and moments) go to
   ``/dev/shm``, at most ``TW_KEEP`` on disk, removed at the end.  It prints
   per-rank peak memory, ms a step (gloo through host memory: not a
   fabric's time) and each save's and restore's seconds.  Right after the
   clean run, its state freed, the same world runs 2D expert sharding
   (``expert_2d``: a rank holds its 4 experts' half of the FFN width, 7168
   columns, and each expert block's tokens are gathered over the data group
   around K1 and reduce-scattered back) for ``TW_2D_STEPS`` steps from the
   same weights and batches, with no checkpoint: each step's loss within
   ``TW_2D_LOSS_RTOL`` of the clean run's same step and the same on every
   rank, the expert shapes, every K1 launch and K2/K3 launch pair of the
   first step held, launches exact (``train_world_2d`` in the kernels
   line), peak memory a rank printed and below the clean run's.

The script's wall time, the build included, is printed before the kernels
line.

It prints K4's extra numbers and K2's/K3's per-launch times (with the
dgrad launch's library time and bound) one a line beside the card's name
and power limit, phase 12's numbers a config a line, a ``kernels`` JSON
line (nine entries, K5b's, K6's and K6b's ``replaces`` naming the scans
the JAX model runs; phase 15's numbers under K1's ``train_world``, its 2D
run's under ``train_world["run_2d"]``), then,
last, ``{"ok": true, "device":
...}``.  Any failure exits non-zero before that line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import re
import subprocess
import sys
import time
import types
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

# K4 vs plain, per (b, head): relative L2 over the rows and columns of a head.  Each rounds its own p to bf16
# (the kernel against a running max) and its own output: this script read 0.81e-3 to 1.65e-3 in the served
# models on an H100, the largest at h2o-danube's q[1,32,4608,120] with its 4096 window, where the median |o| is
# 0.025 and the elementwise BF16_TOL is as large as a typical output.  The plain version with that window's
# edge moved by one 64-key tile read 1.75e-2 there; phase 12 fails unless such a move lies above the limit
K4_REL_L2 = 3e-3
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
# K5b vs plain, each gradient in f32 on both sides: relative L2 and max |diff| / max |plain| (sums over T and over
# 64 terms in another order)
WKV_BWD_TOL = 1e-3
# the long_500k cell (phase 10b) on the phase-10 model: a 1024-token prompt at batch 1, then 16 decode steps
LONG_PROMPT, LONG_STEPS = 1024, 16
# RWKV6-7B training (phase 11): full width cut to 4 of 32 layers, batch 4 x 1024 (K5 and K5b at the serving
# prefill's shape), f32 masters, bf16 compute, remat per block, AdamW, 8 steps
RWKV_TRAIN_LAYERS, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS = 4, 4, 1024, 8
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
# the two-level controller behind the engine (phase 14c): 6c's knobs with dispatch="hierarchical" at the JAX
# default pod size over the same 8 virtual ranks (no regime library: a flat-controller feature), two phases of
# 16 requests from 6c's token pools
HIER_POD_SIZE, HIER_REQUESTS = 2, 16
HIER_ENGINE_KW = {k: v for k, v in ENGINE_KW.items() if k not in ("regime_slots", "regime_threshold")}
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
KNEE_LIBRARY_B = (1, 4, 16, 64, 4096)  # the batches at which torch.bmm SwiGLU is timed beside K1

# phase 12: the seven configs the twelfth slice ports, served at full width with seeded weights through serve()
# (one round, the controller on: only Jamba has MoE to plan), each freed before the next: (arch, layers kept
# (None: all), batch, prompt, new tokens).  Jamba keeps layers 0-4 (Mamba at 0-3, MoE at 1 and 3, attention
# at 4; about 48 GB of bf16 weights), granite-34b 8 of 88; h2o-danube's 4608-token prompt is longer than its
# 4096-token window and no multiple of it, so the ring slots wrap before decode
SLICE12 = (
    ("jamba-1.5-large-398b", 5, 4, 256, 8),
    ("h2o-danube-3-4b", None, 1, 4608, 16),
    ("qwen2-1.5b", None, 4, 256, 8),
    ("granite-3-8b", None, 4, 256, 8),
    ("granite-34b", 8, 4, 256, 8),
    ("internvl2-26b", None, 4, 256, 8),
    ("musicgen-large", None, 4, 256, 8),
)
# phase 12b (the engine, ENGINE_KW) and 10c (the long_500k cell) run on these phase-12 models before they are
# freed: ENGINE12_PHASES phases of 8 requests (prompts ENGINE_TRACE_PROMPTS, 8-16 new tokens), the replay held
# against the eager step at the first ENGINE12_HELD decode steps of each
SLICE12_ENGINE, ENGINE12_PHASES, ENGINE12_HELD = ("jamba-1.5-large-398b", "h2o-danube-3-4b"), 3, 2
# phase 13: training the hybrid and a dense config at full width: Jamba-1.5-Large cut to layer 0 (Mamba and the
# dense SwiGLU of F 24576, 2.1 B parameters: its MoE layer 1 alone holds 9.66 B expert parameters, which one card
# cannot train with f32 masters and moments) and qwen2-1.5b at all 28 layers, each batch 4 x 1024, f32 masters,
# bf16 compute, remat per block, AdamW, 8 steps
TRAIN13 = (("jamba-1.5-large-398b", 1), ("qwen2-1.5b", None))
TRAIN13_BATCH, TRAIN13_SEQ, TRAIN13_STEPS = 4, 1024, 8
# K6b vs plain, each gradient in f32 on both sides: relative L2 and max |diff| / max |plain| (K5b's rule)
SCAN_BWD_TOL = 1e-3
# the special-function units' exponentials: 16 a clock an SM, 132 SMs, at the 1.98 GHz boost clock (H100 SXM)
EXP_PER_S = 16 * 132 * 1.98e9

# phase 14: expert parallelism across EP_RANKS ranks sharing the card over gloo.  14a: one full-width Mixtral MoE
# layer, x [EP_B, EP_S, 4096] (2048 tokens a rank) at JAX's parity-matrix capacity factor (tests/multidev_fabric.py),
# EP_TIMED forward calls timed a fabric; 14b: 2 full-width layers served (B, prompt, new tokens, rounds)
EP_RANKS, EP_B, EP_S, EP_CAPACITY, EP_TIMED, EP_SEED = 4, 4, 2048, 8.0, 2, 11
EP_SERVE = dict(batch=4, prompt_len=256, new_tokens=8, rounds=2)
EP_SERVE_LAYERS, EP_TIMEOUT_S = 2, 480
EP_LABEL = "4 ranks sharing one H100 over gloo, staged through host memory: not a fabric's time"

# phase 15: training across TW_RANKS ranks sharing the card over gloo: 1-layer full-width Mixtral-8x7B laid out as
# (data 2, model 2) under phase_pipelined with the launcher's lossless table, TW_BATCH rows of TW_SEQ tokens (2 rows
# a data group), TW_STEPS AdamW steps; a fault on rank TW_FAULT_RANK at TW_FAULT_AT (first attempt) rolled back to
# the checkpoint of step TW_CKPT_EVERY; then the latest checkpoint restored onto TW_LAYOUT_B for TW_MORE_STEPS steps.
# f32 master, grad and two moments are 16 B a parameter: 1.009 B parameters a rank (4 experts of 8 over 2 model
# ranks and the replicated rest) hold 16.1 GB, so the 4 ranks 64.6 GB; a checkpoint is the whole model's 1.713 B
# parameters and moments, 20.6 GB, in /dev/shm, at most TW_KEEP of them
TW_RANKS, TW_LAYOUT, TW_LAYOUT_B, TW_BATCH, TW_SEQ, TW_SEED = 4, (2, 2), (1, 4), 4, 256, 5
TW_STEPS, TW_MORE_STEPS, TW_CKPT_EVERY, TW_KEEP, TW_FAULT_RANK, TW_FAULT_AT = 6, 2, 3, 2, 1, 4
TW_LOSS_RTOL, TW_TIMEOUT_S = 1e-5, 900  # the fault run's final loss against the clean run's: JAX's bound
TW_LABEL = "4 ranks sharing one H100 over gloo, gradients staged through host memory: not a fabric's time"
# phase 15's 2D run (expert_2d): TW_2D_STEPS steps on the clean run's layout, weights and batches, no checkpoint; a
# rank holds 4 experts x F/2 (0.656 B parameters).  Each step's loss against the clean run's same step: splitting
# F adds one bf16 rounding of each partial output before the f32 sum over the data group (the train step's
# kernel-vs-plain bound is GRAD_REL_TOL = 2e-2)
TW_2D_STEPS, TW_2D_LOSS_RTOL = 3, 2e-3

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


# ---------------------------------------------------------------- phase 14 (the ranks' side)
def _bf16_err(out, ref, what: str) -> float:
    """max |out - ref|, raising past BF16_TOL + BF16_TOL * |ref| (K1's tolerance)."""
    out, ref = out.float(), ref.float()
    if not bool(out.isfinite().all()):
        raise AssertionError(f"{what}: non-finite")
    err = (out - ref).abs()
    if float((err - BF16_TOL * ref.abs()).max()) > BF16_TOL:
        raise AssertionError(f"{what}: max |diff| {float(err.max()):.4g} beyond {BF16_TOL} + {BF16_TOL}*|ref|")
    return float(err.max())


def _grad_rel(out, ref, what: str) -> float:
    """Relative L2 of a gradient leaf, raising past GRAD_REL_TOL (the train
    step's per-leaf rule): a fabric splits an expert's tokens over several
    K1/K3 launches whose bf16 gradients are summed, where the reference
    rounds one sum, so elementwise bounds do not hold where the parts cancel."""
    out, ref = out.float(), ref.float()
    if not bool(out.isfinite().all()):
        raise AssertionError(f"{what}: non-finite")
    rel = float((out - ref).norm() / ref.norm().clamp_min(1e-30))
    if rel > GRAD_REL_TOL:
        raise AssertionError(f"{what}: relative L2 {rel:.4g} beyond {GRAD_REL_TOL}")
    return rel


def _wgrad_err(out, ref, what: str) -> float:
    """K3 against its plain version, phase 5's per-launch rule: relative L2
    within WGRAD_REL_L2 and max |diff| within WGRAD_MAX_REL * max |ref|
    (so exact zeros where the plain version is all zero); the relative L2."""
    out, ref = out.float(), ref.float()
    if not bool(out.isfinite().all()):
        raise AssertionError(f"{what}: non-finite")
    rel = float((out - ref).norm() / ref.norm().clamp_min(1e-30))
    err = float((out - ref).abs().max())
    if rel > WGRAD_REL_L2 or err > WGRAD_MAX_REL * float(ref.abs().max()):
        raise AssertionError(f"{what}: rel L2 {rel:.3g} (tol {WGRAD_REL_L2}), max |diff| {err:.4g} "
                             f"(tol {WGRAD_MAX_REL} * max|plain| = {WGRAD_MAX_REL * float(ref.abs().max()):.4g})")
    return rel


def _hold_in_turns(world, records: list, what: str) -> dict:
    """Hold each recorded K1 launch and each K2/K3 launch pair of a fabric
    call against the plain versions on the same inputs, one rank at a time
    (the plain versions' f32 scratch on a [2, 16384, 14336] block is ~2 GB
    a tensor): per kernel the number held and the largest error (K1, K2:
    max |diff|; K3: relative L2)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.moe_gemm import ops as k1

    held = {"k1": [], "k2": [], "k3": []}
    for turn in range(world.n):
        if turn == world.me:
            with torch.no_grad():
                for i, (kind, args, out) in enumerate(records):
                    tag = f"{what}, launch {i}"
                    dev = args[0].device  # a recorder may keep the outputs on the host
                    if kind == "k1":
                        held["k1"].append(_bf16_err(out.to(dev), k1.moe_gemm_plain(*args), f"K1 vs plain, {tag}"))
                        continue
                    out = tuple(t.to(dev) for t in out)
                    held["k2"].append(_bf16_err(out[0], k1.moe_gemm_dgrad_plain(*args), f"K2 vs plain, {tag}"))
                    held["k3"].append(max(_wgrad_err(a, b, f"K3 {n} vs plain, {tag}") for a, b, n in
                                          zip(out[1:], k1.moe_gemm_wgrad_plain(*args), ("dwg", "dwu", "dwd"))))
            records.clear()
            torch.cuda.empty_cache()
        dist.barrier(group=world.model_group)
    return {k: {"n": len(v), "max": max(v, default=0.0)} for k, v in held.items()}


def _ep_layer_call(p, cfg, x, schedule, world, *, share: float, hold: str | None = None) -> dict:
    """One counted forward and backward of the MoE layer (loss ``share *
    sum(y**2)``): y, the gradients, stats, K1/K2/K3 launches, the slots
    sent and the layer calls by path.  With ``hold`` (the call's name)
    every K1 launch and every K2/K3 launch pair of the call is recorded
    and then held against the plain versions (``_hold_in_turns``)."""
    import torch
    from repro_torch.kernels.moe_gemm import ops as k1
    from repro_torch.models import moe as pmoe
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import ep_world

    x = x.detach().clone().requires_grad_(True)
    for name in ("router", "w_gate", "w_up", "w_down"):
        getattr(p, name).requires_grad_(True)
        getattr(p, name).grad = None
    counters = {"k1": k1.moe_gemm, "k2": k1.moe_gemm_dgrad, "k3": k1.moe_gemm_wgrad}
    records = []
    real_fwd, real_bwd = k1._forward, k1._backward

    # the counted launch, then its inputs (saved for the backward: autograd refuses an in-place change) and a
    # copy of its outputs (autograd may sum later gradients into them) kept for the hold
    def rec_fwd(*args):
        out = real_fwd(*args)
        records.append(("k1", args, out.clone()))
        return out

    def rec_bwd(*args):
        out = real_bwd(*args)
        records.append(("k2k3", args, tuple(t.clone() for t in out)))
        return out

    for fn in counters.values():
        fn.launches = 0
    col.SLOTS_SENT[0] = 0
    pmoe.PATH_CALLS.clear()
    with ep_world(world), mock.patch.object(k1, "_forward", rec_fwd if hold else real_fwd), \
            mock.patch.object(k1, "_backward", rec_bwd if hold else real_bwd):
        y, stats = pmoe.moe_apply(p, cfg, x, schedule=schedule, return_stats=True)
        slots = col.SLOTS_SENT[0]
        (share * (y.float() ** 2).sum()).backward()
    torch.cuda.synchronize()
    out = {"y": y.detach(), "dx": x.grad, "stats": {k: v.detach() for k, v in stats.items()}, "slots": slots,
           "launches": {k: fn.launches for k, fn in counters.items()}, "paths": dict(pmoe.PATH_CALLS)}
    for name in ("router", "w_gate", "w_up", "w_down"):
        out[name] = getattr(p, name).grad
        getattr(p, name).grad = None
        getattr(p, name).requires_grad_(False)
    if hold:
        out["held"] = _hold_in_turns(world, records, hold)
    return out


def _ep_layer(world) -> dict:
    """Phase 14a on this rank: the reference in turn, then every fabric."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import FabricFaultError, FaultScenario, ScheduleTable, decompose, hierarchical_plan, plan_schedule
    from repro_torch.models import moe as pmoe
    from repro_torch.parallel.fabric import FABRICS, wrap_faulty
    from repro_torch.parallel.sharding import ep_world

    dev, n, me = world.device, world.n, world.me
    base = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(base, n_layers=1, moe=dataclasses.replace(base.moe, capacity_factor=EP_CAPACITY))
    m = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(EP_SEED)
    full = pmoe.moe_init(cfg, gen=gen, device=dev, dtype=torch.bfloat16)
    x = torch.randn((EP_B, EP_S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    lo, hi = world.expert_range(m.n_experts)
    p = pmoe.moe_init(cfg, gen=None, device=dev, dtype=torch.bfloat16, experts=(lo, hi))
    with torch.no_grad():
        p.router.copy_(full.router)
        for name in ("w_gate", "w_up", "w_down"):
            getattr(p, name).copy_(getattr(full, name)[lo:hi])
    # the reference: one process's dense fabric on the whole layer, each rank in turn (it holds every expert
    # and the [8, C, F] scratch of C = 16384 slots), the loss share 1
    ref = None
    for turn in range(n):
        if turn == me:
            dcfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, dispatch="dense"))
            r = _ep_layer_call(full, dcfg, x, None, None, share=1.0)
            ref = {"y": r["y"], "dx": r["dx"].float(), "router": r["router"].float(),
                   "routing": r["stats"]["routing"].sum(0), "launches": r["launches"],
                   **{k: r[k][lo:hi].clone() for k in ("w_gate", "w_up", "w_down")}}
            del r
            torch.cuda.empty_cache()  # hand the reference's scratch back before the next rank's turn
        dist.barrier(group=world.model_group)
    del full
    torch.cuda.empty_cache()

    # the real routing's traffic (every rank routes every chunk, identically) and its max-weight plan
    s_loc = EP_S // n
    traffic = np.zeros((n, n))
    with torch.no_grad():
        for i in range(n):
            idx, _ = pmoe._router(p, cfg, x[:, i * s_loc:(i + 1) * s_loc].reshape(-1, cfg.d_model))
            np.add.at(traffic[i], (idx.cpu().numpy().ravel() // (m.n_experts // n)), 1)
    plan = plan_schedule(decompose(traffic, "maxweight"), slack=1.5)
    table = ScheduleTable.from_schedules([plan], k_max=n, clip=True, envelope="auto", device=dev)
    routed = next((i, int(plan.perms[k, i])) for k in range(plan.num_phases) for i in range(n) if plan.valid[k, i])
    seed = next(s for s in range(500)
                if FaultScenario("dead_link", n_ranks=n, onset=0, n_links=1, seed=s).dead_pairs == (routed,))
    scenario = FaultScenario("dead_link", n_ranks=n, onset=0, n_links=1, seed=seed)
    masked = plan_schedule(decompose(traffic, "maxweight", link_mask=scenario.link_mask(0)), slack=1.5)
    masked_row = ScheduleTable.from_schedules([masked], k_max=n, clip=True, envelope="auto", device=dev).row(0)
    faulty = wrap_faulty("phase_pipelined", scenario)
    # the two-level fabric: two pods of two and one pod of four (every pair intra), each also under the fp8 wire
    htabs = {pod: hierarchical_plan(traffic, pod, n_layers=1, slack=1.5, quantum=8, device=dev) for pod in (2, 4)}
    cases = {"dense": ("dense", None, {}), "a2a": ("a2a", None, {}), "ppermute": ("ppermute", plan, {}),
             "phase_pipelined": ("phase_pipelined", table.row(0), {}), "ragged_a2a": ("ragged_a2a", table.row(0), {}),
             faulty: (faulty, masked_row, {})}
    for pod, suffix in ((2, ""), (4, "_pod4")):
        for wire in ("bf16", "fp8"):
            cases[f"hierarchical{suffix}{'_fp8' if wire == 'fp8' else ''}"] = (
                "hierarchical", htabs[pod].row(0), {"pod_size": pod, "wire_dtype": wire})
    quantized = ("hierarchical_fp8", "hierarchical_pod4_fp8")  # held against their bf16-wire twins below
    # unequal loss shares summing to 1 (a wrong all-gather backward shows), powers of two so that each rank's
    # bf16 cotangent is the whole one scaled exactly: 1/2, 1/4, ..., the last two alike
    share = 2.0 ** -min(me + 1, n - 1)
    rows, kept = {}, {}
    try:
        for case, (dispatch, sched, moe_kw) in cases.items():
            ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, dispatch=dispatch, **moe_kw))
            what = f"phase 14a {case} rank {me}"
            r = _ep_layer_call(p, ccfg, x, sched, world, share=share, hold=what)
            row = {"slots": r["slots"], "launches": r["launches"], "paths": r["paths"], "held": r["held"]}
            if case in ("phase_pipelined", "ragged_a2a", faulty, "hierarchical_pod4", "hierarchical_pod4_fp8"):
                # copies: the all-reduce below sums the f32 router gradient in place
                kept[case] = {k: r[k].clone() for k in ("y", "dx", "router", "w_gate", "w_up", "w_down")}
            elif case in ("hierarchical", "hierarchical_fp8"):
                kept[case] = {"y": r["y"].clone()}
            # the wrapper runs the plan made under its mask, which clips the dead pair's choices: it is held
            # against the unwrapped fabric on that row below, not against the reference; a quantized wire is held
            # against its bf16 twin
            apart = case == faulty or case in quantized
            for name in (() if apart else ("w_gate", "w_up", "w_down")):
                row[f"d{name}_rel_l2"] = _grad_rel(r[name], ref[name], f"{what} d{name}")
                row[f"d{name}_err"] = float((r[name].float() - ref[name].float()).abs().max())
            if not apart:
                row["y_err"] = _bf16_err(r["y"], ref["y"], f"{what} output")
            for name in (() if apart else ("router", "dx")):
                part = r[name].float().contiguous()
                dist.all_reduce(part, group=world.model_group)
                row[f"d{name}_rel_l2"] = _grad_rel(part, ref[name], f"{what} d{name} summed over the ranks")
                row[f"d{name}_err"] = float((part - ref[name]).abs().max())
            st = r["stats"]
            if not torch.equal(st["routing"].sum(0), ref["routing"]):
                raise AssertionError(f"{what}: routing summed over the ranks differs from the reference's")
            if float(st["dropped"].sum()) != 0.0:
                raise AssertionError(f"{what}: {float(st['dropped'].sum())} admitted choices dropped")
            # ms a forward layer call: every rank starts together, the slowest sets the pace
            times = []
            with torch.no_grad(), ep_world(world):
                for _ in range(EP_TIMED):
                    dist.barrier(group=world.model_group)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pmoe.moe_apply(p, ccfg, x, schedule=sched)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            row["ms"] = float(np.median(times))
            rows[case] = row
            del r
            torch.cuda.empty_cache()
        for key, a in kept["ragged_a2a"].items():
            if not torch.equal(a, kept["phase_pipelined"][key]):
                raise AssertionError(f"phase 14a rank {me}: ragged_a2a's {key} differs from phase_pipelined's")
        # the fp8 wire crosses only the pod seam: one pod over every rank leaves every output and gradient bit for
        # bit; two pods quantize the inter slots, engaged and within the wire codecs' bound (phase 6d's 0.1 of the
        # bf16 output's max)
        for key, a in kept["hierarchical_pod4_fp8"].items():
            if not torch.equal(a, kept["hierarchical_pod4"][key]):
                raise AssertionError(f"phase 14a rank {me}: hierarchical_pod4 under fp8: {key} differs from the bf16 wire's")
        y_q, y_w = kept["hierarchical_fp8"]["y"].float(), kept["hierarchical"]["y"].float()
        q_err, q_top = float((y_q - y_w).abs().max()), float(y_w.abs().max())
        if not 0.0 < q_err <= WIRE_REL_TOL["fp8"] * q_top:
            raise AssertionError(f"phase 14a rank {me}: hierarchical under fp8 differs from the bf16 wire by {q_err:.4g} "
                                 f"(max |y| {q_top:.4g}; engaged and within {WIRE_REL_TOL['fp8']} of it expected)")
        rows["hierarchical_fp8"]["wire_err"] = q_err
        rows["hierarchical_fp8"]["wire_rel_err"] = q_err / q_top
        # the wrapper's pass through equals the unwrapped fabric on the same (masked) row, bit for bit
        pcfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, dispatch="phase_pipelined"))
        plain = _ep_layer_call(p, pcfg, x, masked_row, world, share=share)
        for key, a in kept[faulty].items():
            if not torch.equal(a, plain[key]):
                raise AssertionError(f"phase 14a rank {me}: {faulty}'s {key} differs from phase_pipelined's")
        rows[faulty]["masked_admitted"] = float(plain["stats"]["admitted"].sum())
        rows[faulty]["masked_routed"] = float(plain["stats"]["routing"].sum())
        del plain, kept
        # the routed dead pair: refused before anything moves
        fcfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, dispatch=faulty))
        try:
            with ep_world(world):
                pmoe.moe_apply(p, fcfg, x, schedule=table.row(0))
            raise AssertionError(f"phase 14a rank {me}: {faulty} ran a plan through a dark link")
        except FabricFaultError as e:
            refused = {"message": str(e), "backend": e.backend, "pair": e.pair, "phase": e.phase,
                       "next_fabric": e.next_fabric}
    finally:
        FABRICS.pop(faulty, None)
    e_local = m.n_experts // n
    levels = {}
    for pod, tab in htabs.items():
        row_ = tab.row(0)
        on_e = ((torch.arange(row_.inter.k_max, device=dev) < row_.inter.n_phases)[:, None] & row_.inter.valid).cpu().numpy()
        levels[pod] = {"merged_env_slots": row_.envelope_slots(e_local), "env_i": row_.intra.envelope_slots(e_local),
                       "env_e": row_.inter.envelope_slots(e_local), "inter_on": on_e}
    return {"rows": rows, "refused": refused, "routed": routed, "ref_launches": ref["launches"],
            "plan": plan, "envelope": table.envelope, "env_slots": table.envelope_slots(e_local),
            "t_local": EP_B * s_loc, "e_local": e_local, "levels": levels}


def _ep_serve(world) -> dict:
    """Phase 14b on this rank: ``serve`` across the world, then a prefill
    of round 0 with K1 held per layer (rank 0) that must give the served
    logits bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k4
    from repro_torch.kernels.moe_gemm import ops as k1
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    from repro_torch.models import moe as pmoe
    from repro_torch.parallel.sharding import ep_world

    dev, me = world.device, world.me
    base = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(base, n_layers=EP_SERVE_LAYERS, moe=dataclasses.replace(base.moe, dispatch="phase_pipelined"))
    model = Model(cfg, device=dev, seed=EP_SEED, expert_shard=(me, world.n))
    torch.cuda.synchronize()
    counters = {"moe_gemm_grouped": k1.moe_gemm, "flash_attention_fwd": k4.flash_attention,
                "moe_gemm_grouped_dgrad": k1.moe_gemm_dgrad, "moe_gemm_grouped_wgrad": k1.moe_gemm_wgrad}
    for fn in counters.values():
        fn.launches = 0
    pmoe.PATH_CALLS.clear()
    res = serve(model, controller=True, drift="none", world=world, **EP_SERVE)
    launches = {k: fn.launches for k, fn in counters.items()}
    paths = dict(pmoe.PATH_CALLS)
    # round 0's prefill again, K1 held against its plain version per layer on rank 0 (comparisons: not counted)
    held = []
    real = k1.moe_gemm

    def held_k1(xb, wg, wu, wd, rv):
        out = k1._launch(xb, wg, wu, wd, rv)
        held.append(_bf16_err(out, k1.moe_gemm_plain(xb, wg, wu, wd, rv), f"K1 in layer {len(held)} (rank 0)"))
        return out

    table0 = res.tables[0].clone(dev)
    prompts = res.prompts[0].to(dev)
    with ep_world(world), mock.patch.object(k1, "moe_gemm", held_k1 if me == 0 else real):
        logits, _, stats = model.prefill(prompts, model.init_cache(prompts.shape[0], prompts.shape[1]),
                                         schedule=table0, collect_stats=True)
    if not torch.equal(logits.cpu(), res.first_logits):
        raise AssertionError(f"phase 14b rank {me}: the held prefill's logits differ from the served round 0's")
    return {"tokens": res.tokens, "first_logits": res.first_logits, "prompts": res.prompts, "tables": res.tables,
            "prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms, "plan_ms": res.plan_ms,
            "moe_by_round": res.moe_by_round, "launches": launches, "paths": paths, "k1_held": held,
            "prefill_stats": {k: v.cpu() for k, v in stats.items()}, "table_envelope": table0.envelope}


def ep_rank(world) -> dict:
    """Phase 14 on one of the ranks ``spawn_world`` starts."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    layer = _ep_layer(world)
    torch.cuda.empty_cache()
    return {"layer": layer, "serve": _ep_serve(world)}


def ep_phase(dev, card: str, counted) -> tuple:
    """Phase 14 on this process's side: spawn the ranks (``ep_rank``), hold
    what they return, run 14b's one-process reference, print the phase's
    lines; returns (14a launches, 14b launches, 14a rows, K1/K2/K3's largest
    errors against their plain versions, 14b's numbers), launches keyed like ``counted``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.parallel.fabric import geometry as geom
    from repro_torch.parallel.fabric import get_fabric
    from repro_torch.parallel.sharding import spawn_world, world_backend

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    backend = world_backend(dev, EP_RANKS, torch.cuda.device_count())
    print(f"phase 14: {EP_RANKS} ranks on {torch.cuda.device_count()} card(s): backend {backend}; no collective is "
          f"staged by the port (gloo copies CUDA tensors through host memory itself) ({card})")
    try:
        ranks = spawn_world(ep_rank, EP_RANKS, device="cuda", timeout_s=EP_TIMEOUT_S, init_timeout_s=120)
    except Exception as e:  # a rank's failure (its traceback), a dead rank or the timeout
        fail(f"phase 14: {e}")
    t_world = time.perf_counter() - t_phase
    ep_layer_launches, ep_serve_launches = dict.fromkeys(counted, 0), dict.fromkeys(counted, 0)

    # 14a: launches, slots and the refusal, per rank
    lay0 = ranks[0]["layer"]
    e_local, plan, env_slots = lay0["e_local"], lay0["plan"], lay0["env_slots"]
    live = sum(1 for v in env_slots if v)
    faulty_name = next(c for c in lay0["rows"] if c.startswith("faulty:"))
    k1_per_call = {"dense": 1, "a2a": 1, "ppermute": 1, "phase_pipelined": live + 1, "ragged_a2a": live + 1,
                   faulty_name: live + 1}
    hier_cases = {"hierarchical": 2, "hierarchical_fp8": 2, "hierarchical_pod4": 4, "hierarchical_pod4_fp8": 4}
    for case, pod in hier_cases.items():  # the merged row's live phase slots, then the local block
        k1_per_call[case] = sum(1 for v in lay0["levels"][pod]["merged_env_slots"] if v) + 1
    for r, rank in enumerate(ranks):
        lay = rank["layer"]
        for case, row in lay["rows"].items():
            want = k1_per_call[case]
            if row["launches"] != {"k1": want, "k2": want, "k3": want}:
                fail(f"phase 14a {case} rank {r}: K1/K2/K3 launched {row['launches']}, expected {want} each")
            held_n = {k: v["n"] for k, v in row["held"].items()}
            if held_n != {"k1": want, "k2": want, "k3": want}:
                fail(f"phase 14a {case} rank {r}: K1/K2/K3 held against their plain versions {held_n} times, "
                     f"expected {want} each")
            path = "dense_ep" if case == "dense" else "hierarchical" if case in hier_cases else case
            if row["paths"] != {path: 1}:
                fail(f"phase 14a {case} rank {r}: layer calls {row['paths']}, expected one on {path}")
            for key, name in (("k1", "moe_gemm_grouped"), ("k2", "moe_gemm_grouped_dgrad"), ("k3", "moe_gemm_grouped_wgrad")):
                ep_layer_launches[name] += row["launches"][key]
        ref_ = lay["refused"]
        if (ref_["backend"], tuple(ref_["pair"]), ref_["next_fabric"]) != ("phase_pipelined", tuple(lay["routed"]), "a2a"):
            fail(f"phase 14a rank {r}: the routed dead link was refused as {ref_}")
    cap_pair = e_local * geom.round8(math.ceil(lay0["t_local"] * 2 / (EP_RANKS * e_local) * EP_CAPACITY))
    phase_caps = geom.round8(-(-plan.caps.astype(np.int64) // e_local))
    env = e_local * np.asarray(env_slots)
    models = {
        "dense": ("dispatch_tokens", get_fabric("dense").dispatch_tokens(n=EP_RANKS)),
        "a2a": ("dispatch_tokens", get_fabric("a2a").dispatch_tokens(n=EP_RANKS, cap_uniform=cap_pair)),
        "ppermute": ("dispatch_tokens", get_fabric("ppermute").dispatch_tokens(
            n=EP_RANKS, schedule=dataclasses.replace(plan, caps=e_local * phase_caps))),
        "phase_pipelined": ("dispatch_tokens_padded", get_fabric("phase_pipelined").dispatch_tokens_padded(
            n=EP_RANKS, envelope=env)),
        "ragged_a2a": ("dispatch_tokens", get_fabric("ragged_a2a").dispatch_tokens(n=EP_RANKS, schedule=plan, envelope=env)),
    }
    models[faulty_name] = ("none (the plan made under the link mask is not the modelled one)", None)
    for case, pod in hier_cases.items():  # intra phases on the dense per-phase emulation, inter phases ragged
        lv = lay0["levels"][pod]
        models[case] = ("intra dispatch_tokens_padded + inter dispatch_tokens",
                        get_fabric("phase_pipelined").dispatch_tokens_padded(
                            n=EP_RANKS, envelope=e_local * np.asarray(lv["env_i"]))
                        + get_fabric("ragged_a2a").dispatch_tokens(
                            n=EP_RANKS, schedule=types.SimpleNamespace(valid=lv["inter_on"]),
                            envelope=e_local * np.asarray(lv["env_e"])))
    ep_rows = {}
    for case in lay0["rows"]:
        rows_ = [rank["layer"]["rows"][case] for rank in ranks]
        sent = float(np.mean([row["slots"] for row in rows_]))
        kind, model_slots = models[case]
        if model_slots is not None and sent != model_slots:
            fail(f"phase 14a {case}: the ranks sent {sent} slots each on average, {kind} says {model_slots}")
        ep_rows[case] = {
            "ms": max(row["ms"] for row in rows_), "slots_sent_per_rank": sent, "model": kind, "model_slots": model_slots,
            **{key: max(row[key] for row in rows_) for key in rows_[0] if key.endswith(("_err", "_rel_l2"))},
        }
        e_ = ep_rows[case]
        if case in ("hierarchical_fp8", "hierarchical_pod4_fp8"):
            twin = "output and gradients bit for bit" if case == "hierarchical_pod4_fp8" else (
                f"max |diff| {e_['wire_err']:.4g} ({e_['wire_rel_err']:.3g} of the bf16 output's max; tol "
                f"{WIRE_REL_TOL['fp8']})")
            print(f"phase 14a {case}: {e_['ms']:.1f} ms a forward layer call (the slowest rank's median of {EP_TIMED}) | "
                  f"{sent:.0f} slots sent a rank ({kind} {model_slots:.0f}) | against its bf16-wire twin: {twin} | "
                  f"{EP_LABEL} ({card})")
            continue
        if case == faulty_name:
            print(f"phase 14a {case}: {e_['ms']:.1f} ms a forward layer call (the slowest rank's median of {EP_TIMED}) | "
                  f"{sent:.0f} slots sent a rank | {EP_LABEL} ({card})")
            continue
        print(f"phase 14a {case}: {e_['ms']:.1f} ms a forward layer call (the slowest rank's median of {EP_TIMED}) | "
              f"{sent:.0f} slots sent a rank ({kind} {model_slots:.0f}) | y max err {e_['y_err']:.4g} | gradients rel L2 "
              f"(max err): dx {e_['ddx_rel_l2']:.3g} ({e_['ddx_err']:.3g}), router {e_['drouter_rel_l2']:.3g} "
              f"({e_['drouter_err']:.3g}), w_gate {e_['dw_gate_rel_l2']:.3g} ({e_['dw_gate_err']:.3g}), w_up "
              f"{e_['dw_up_rel_l2']:.3g}, w_down {e_['dw_down_rel_l2']:.3g} | {EP_LABEL} ({card})")
    ep_held = {k: max(row["held"][k]["max"] for rank in ranks for row in rank["layer"]["rows"].values())
               for k in ("k1", "k2", "k3")}
    print(f"phase 14a: every K1 launch and K2/K3 launch pair of every fabric call on every rank held against the "
          f"plain versions on its inputs: K1 max err {ep_held['k1']:.4g}, K2 max err {ep_held['k2']:.4g} (tol "
          f"{BF16_TOL} + {BF16_TOL}*|plain|), K3 rel L2 {ep_held['k3']:.3g} (tol {WGRAD_REL_L2}, max |diff| "
          f"{WGRAD_MAX_REL}*max|plain|); ragged_a2a equal to phase_pipelined bit for bit; {faulty_name} with the masked plan equal to "
          f"phase_pipelined bit for bit (admitted {lay0['rows'][faulty_name]['masked_admitted']:.0f} of "
          f"{lay0['rows'][faulty_name]['masked_routed']:.0f} choices), the routed dead link {tuple(lay0['routed'])} refused: "
          f"{lay0['refused']['message'][:160]} ({card})")

    # 14b: every rank's tokens and tables, the paths, the launches, then the one-process run
    srv = [rank["serve"] for rank in ranks]
    s0 = srv[0]
    rounds_, new_, layers_ = EP_SERVE["rounds"], EP_SERVE["new_tokens"], EP_SERVE_LAYERS
    for r, sv in enumerate(srv):
        if not torch.equal(sv["tokens"], s0["tokens"]):
            fail(f"phase 14b: rank {r}'s tokens differ from rank 0's")
        for t_r, t0_ in zip(sv["tables"], s0["tables"]):
            if not tables_equal(t_r, t0_):
                fail(f"phase 14b: rank {r}'s table differs from rank 0's")
        if sv["paths"] != {"phase_pipelined": rounds_ * layers_, "dense_ep": rounds_ * new_ * layers_}:
            fail(f"phase 14b rank {r}: layer calls {sv['paths']}: prefill on the fabric, decode on the dense EP form expected")
        live_r = [sum(1 for v in t.envelope_slots(e_local) if v) for t in sv["tables"]]
        want_k1 = sum(layers_ * (lv + 1) for lv in live_r) + rounds_ * new_ * layers_
        want = {"moe_gemm_grouped": want_k1, "flash_attention_fwd": rounds_ * layers_,
                "moe_gemm_grouped_dgrad": 0, "moe_gemm_grouped_wgrad": 0}
        if sv["launches"] != want:
            fail(f"phase 14b rank {r}: launches {sv['launches']}, expected {want}")
        for name, v in sv["launches"].items():
            ep_serve_launches[name] += v
    live0 = sum(1 for v in s0["tables"][0].envelope_slots(e_local) if v)
    if len(s0["k1_held"]) != layers_ * (live0 + 1):
        fail(f"phase 14b: K1 held {len(s0['k1_held'])} times on rank 0, expected {live0 + 1} launches a layer")
    scfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=EP_SERVE_LAYERS,
                               moe=dataclasses.replace(get_config("mixtral-8x7b").moe, dispatch="phase_pipelined"))
    # the one-process run drops nothing either: its capacity-factor bucket spans all B x S tokens of an expert,
    # where an EP rank's buckets hold its own chunk (the parity matrix's factor; the seeded weights are the same)
    one = Model(dataclasses.replace(scfg, moe=dataclasses.replace(scfg.moe, capacity_factor=EP_CAPACITY)), device=dev,
                seed=EP_SEED)
    prompts0, table0 = s0["prompts"][0].to(dev), s0["tables"][0].clone(dev)
    bsz, seq = prompts0.shape
    real_adm = geom.admission_mask

    def ep_sources(idx, gates, row, n_experts, *, src):
        """The EP run's sources: token (b, s) on the rank whose sequence chunk holds s."""
        tok = torch.arange(idx.numel(), device=idx.device) // idx.shape[-1]
        return real_adm(idx, gates, row, n_experts, src=(tok % seq) // (seq // row.n))

    with mock.patch.object(geom, "admission_mask", ep_sources):
        one_logits, _, one_st = one.prefill(prompts0, one.init_cache(bsz, seq), schedule=table0, collect_stats=True)
    ep_st = s0["prefill_stats"]
    if float(ep_st["dropped"].sum()) or float(one_st["dropped"].sum()):
        fail(f"phase 14b: choices cut at the buckets (EP {ep_st['dropped'].sum(-1).tolist()}, one process "
             f"{one_st['dropped'].sum(-1).tolist()} a layer): the two runs are comparable only when neither cuts one")
    if not torch.equal(ep_st["routing"][0].sum(0), one_st["routing"][0].sum(0).cpu()) or \
            float(ep_st["admitted"][0].sum()) != float(one_st["admitted"][0].sum()):
        fail(f"phase 14b: layer 0's routing or admission differs from the one-process run's "
             f"(admitted {float(ep_st['admitted'][0].sum())} vs {float(one_st['admitted'][0].sum())})")
    a_, b_ = s0["first_logits"].to(dev).float(), one_logits.float()
    ep_rel = float(((a_ - b_).norm(dim=-1) / b_.norm(dim=-1)).max())
    if ep_rel > LOGITS_REL_TOL:
        fail(f"phase 14b: the first prefill's logits differ from the one-process run's by {ep_rel:.4g} per-row "
             f"relative L2 (tol {LOGITS_REL_TOL}); dropped a layer (EP) {ep_st['dropped'].sum(-1).tolist()}, (one "
             f"process) {one_st['dropped'].sum(-1).tolist()}; admitted {ep_st['admitted'].sum(-1).tolist()}, "
             f"{one_st['admitted'].sum(-1).tolist()}")
    del one, one_logits
    gc.collect()
    torch.cuda.empty_cache()
    ep_serve = {"prefill_ms": s0["prefill_ms"], "decode_ms_per_step": [ms / new_ for ms in s0["decode_ms"]],
                "plan_ms": s0["plan_ms"], "moe_by_round": s0["moe_by_round"], "k1_held_max_err": max(s0["k1_held"]),
                "logits_rel_l2_vs_one_process": ep_rel,
                "dropped_first_prefill": [float(ep_st["dropped"].sum()), float(one_st["dropped"].sum())]}
    print(f"phase 14b: {EP_SERVE_LAYERS}-layer full-width Mixtral-8x7B across {EP_RANKS} ranks (phase_pipelined, "
          f"controller): tokens and tables equal on every rank; decode on the dense EP form "
          f"({s0['paths']['dense_ep']} layer calls); K1 held per layer on rank 0 (max err {max(s0['k1_held']):.4g}); "
          f"first prefill's logits vs the one-process run with the EP sources: per-row rel L2 {ep_rel:.4g} (tol "
          f"{LOGITS_REL_TOL}); dropped (EP, one process) {ep_serve['dropped_first_prefill']}")
    print(f"phase 14b: prefill {[round(v, 1) for v in s0['prefill_ms']]} ms a round, decode "
          f"{[round(v, 2) for v in ep_serve['decode_ms_per_step']]} ms a step, plan {[round(v, 1) for v in s0['plan_ms']]}"
          f" ms | {EP_LABEL} ({card})")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s wall, the world {t_world:.1f} s ({card})")

    return ep_layer_launches, ep_serve_launches, ep_rows, ep_held, ep_serve


# ---------------------------------------------------------------- phase 15 (training across ranks)
def _tw_recorder(records: list, on: list):
    """K1's and K2/K3's launch functions that record each launch while
    ``on[0]`` is set, for ``_hold_in_turns``, with little device memory:
    the small inputs stay on the card, the outputs and the bf16 weight
    copies go to the host, each weight once (every launch of a step casts
    the same f32 masters: checked), and ``restore()`` moves the weights
    back before the hold."""
    import torch
    from repro_torch.kernels.moe_gemm import ops as k1

    real_fwd, real_bwd = k1._forward, k1._backward
    weights = {}  # "w_gate", "w_up", "w_down" -> [host copy, the records' placeholder]

    def keep(args, first: int) -> tuple:
        """``args`` with its three weights (from position ``first``) as placeholders."""
        out = list(args)
        for name, i in zip(("w_gate", "w_up", "w_down"), range(first, first + 3)):
            host = args[i].cpu()
            if name not in weights:
                weights[name] = [host, [None]]
            elif not torch.equal(weights[name][0], host):
                raise AssertionError(f"phase 15: two launches of the recorded step saw different {name}")
            out[i] = weights[name][1]
        return tuple(out)

    def rec_fwd(*args):  # (x, w_gate, w_up, w_down, row_valid)
        out = real_fwd(*args)
        if on[0]:
            records.append(("k1", keep(args, 1), out.cpu()))
        return out

    def rec_bwd(*args):  # (go, x, w_gate, w_up, w_down, row_valid)
        out = real_bwd(*args)
        if on[0]:
            records.append(("k2k3", keep(args, 2), tuple(t.cpu() for t in out)))
        return out

    def restore(dev):
        """The records with their weights on ``dev`` again."""
        for host, slot in weights.values():
            slot[0] = host.to(dev)
        records[:] = [(kind, tuple(a[0] if isinstance(a, list) else a for a in args), out)
                      for kind, args, out in records]
        weights.clear()

    return rec_fwd, rec_bwd, restore


class _NoCheckpoints:
    """A checkpoint manager that keeps nothing: phase 15's 2D run takes no
    checkpoint (``train_loop`` would write one at its last step)."""

    def __init__(self):
        self.saves, self.restores = [], []

    def restore_latest(self, template):
        return None, None

    def save_async(self, step, tree) -> None:
        pass

    def wait(self) -> None:
        pass


def _tw_run(world, cfg, ckpt_dir: str | None, steps: int, *, keep: int = 1, ckpt_every: int = 1, hook=None,
            hold: str | None = None) -> dict:
    """One ``train_loop`` on a fresh seeded model holding this rank's
    experts (under 2D their slice of the FFN width, ``World.model_shards``),
    under ``world``: its result, K1/K2/K3 launches, peak memory, each save's
    and restore's times and, with ``hold``, K1 and K2/K3 held against their
    plain versions on every launch of the first step.  ``ckpt_dir`` None
    takes no checkpoint."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.moe_gemm import ops as k1
    from repro_torch.launch.train import data_config, plan_table
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import ep_world
    from repro_torch.train import TrainLoopConfig, train_loop

    dev = world.device
    model = Model(cfg, device=dev, param_dtype=torch.float32, requires_grad=True, seed=TW_SEED,
                  **world.model_shards(cfg))
    table = plan_table(cfg, batch=TW_BATCH, seq=TW_SEQ, virtual_ranks=world.n_model, n_data=world.n_data, device=dev)
    e_local = cfg.moe.n_experts // world.n_model
    live = sum(1 for v in table.envelope_slots(e_local) if v)
    manager = _NoCheckpoints() if ckpt_dir is None else CheckpointManager(
        ckpt_dir, keep=keep, world=world, sharded=model.expert_names(), ffn_axes=model.ffn_axes())
    records, on = [], [False]
    rec_fwd, rec_bwd, restore_records = _tw_recorder(records, on)

    def step_hook(step):
        on[0] = hold is not None and step == 0
        if hook is not None:
            hook(step)

    counters = {"k1": k1.moe_gemm, "k2": k1.moe_gemm_dgrad, "k3": k1.moe_gemm_wgrad}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop_cfg = TrainLoopConfig(steps=steps, ckpt_dir=ckpt_dir or "", ckpt_every=ckpt_every, keep=keep,
                               peak_lr=PEAK_LR, warmup=WARMUP, log_every=1)
    t0 = time.perf_counter()
    with ep_world(world), mock.patch.object(k1, "_forward", rec_fwd), mock.patch.object(k1, "_backward", rec_bwd):
        res = train_loop(model, data_config(cfg, seq=TW_SEQ, batch=TW_BATCH), loop_cfg, schedule=table,
                         failure_hook=step_hook, manager=manager)
    torch.cuda.synchronize()
    out = {"res": res, "wall_s": time.perf_counter() - t0, "launches": {k: fn.launches for k, fn in counters.items()},
           "live": live, "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "saves": manager.saves,
           "restores": manager.restores, "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
           "expert_shapes": {n: list(p.shape) for n, p in model.named_parameters() if n in model.expert_names()}}
    del model, manager
    gc.collect()
    torch.cuda.empty_cache()
    if hold is not None:
        restore_records(dev)
        out["held"] = _hold_in_turns(world, records, hold)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_rank(world, ckpt_root: str) -> dict:
    """Phase 15 on one of the ranks ``spawn_world`` starts: the clean run
    (K1/K2/K3 held in its first step), the run with a fault on rank
    ``TW_FAULT_RANK``, and the elastic restart of its checkpoint onto
    ``TW_LAYOUT_B``."""
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.parallel.sharding import regroup

    torch.backends.cuda.matmul.allow_tf32 = False
    # rank 0 logs the loop's steps, failures and restores as they happen
    logging.basicConfig(level=logging.INFO if world.rank == 0 else logging.WARNING,
                        format="phase 15 rank 0: %(message)s")
    base = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(base, n_layers=1, moe=dataclasses.replace(base.moe, dispatch="phase_pipelined"))
    clean_dir, fault_dir = os.path.join(ckpt_root, "clean"), os.path.join(ckpt_root, "fault")
    # the clean run keeps only its final checkpoint, removed before the fault run writes its own
    clean = _tw_run(world, cfg, clean_dir, TW_STEPS, keep=1, ckpt_every=TW_STEPS,
                    hold=f"phase 15 rank {world.rank} step 0")
    dist.barrier()
    if world.rank == 0:
        shutil.rmtree(clean_dir, ignore_errors=True)
    # 2D expert sharding on the same layout, weights and batches (the clean run's state freed by _tw_run)
    cfg_2d = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, expert_2d=True))
    if not world.two_d(cfg_2d):
        raise AssertionError(f"phase 15: {TW_LAYOUT} does not run expert_2d")
    run_2d = _tw_run(world, cfg_2d, None, TW_2D_STEPS, hold=f"phase 15 2D rank {world.rank} step 0")
    dist.barrier()
    fired = []

    def boom(step):
        if world.rank == TW_FAULT_RANK and step == TW_FAULT_AT and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    fault = _tw_run(world, cfg, fault_dir, TW_STEPS, keep=TW_KEEP, ckpt_every=TW_CKPT_EVERY, hook=boom)
    fault["fired"] = bool(fired)
    # the restart reads the latest checkpoint: the earlier one goes first, so at most TW_KEEP are ever on disk
    dist.barrier()
    if world.rank == 0:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(fault_dir) if n.startswith("step_"))
        for s_ in steps[:-1]:
            shutil.rmtree(os.path.join(fault_dir, f"step_{s_:08d}"), ignore_errors=True)
    dist.barrier()
    other = regroup(world, TW_LAYOUT_B)
    elastic = _tw_run(other, cfg, fault_dir, TW_STEPS + TW_MORE_STEPS, keep=TW_KEEP, ckpt_every=TW_CKPT_EVERY)
    elastic["layout"] = (other.n_data, other.n_model, other.data_index, other.me)
    return {"clean": clean, "clean_2d": run_2d, "fault": fault, "elastic": elastic}


def train_world_phase(card: str, counted) -> tuple:
    """Phase 15 on this process's side: spawn the ranks (``train_rank``),
    hold what they return, print the phase's lines; returns (launches keyed
    like ``counted``, the phase's numbers)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.parallel.sharding import spawn_world, world_backend

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shm = Path("/dev/shm")
    in_memory = shm.is_dir() and os.access(shm, os.W_OK)
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_world_", dir=str(shm) if in_memory else None)
    ckpt_bytes = 3 * 4 * 1.713e9  # f32 parameters and two moments of the whole 1-layer model
    need = TW_KEEP * ckpt_bytes * 1.1
    free = shutil.disk_usage(ckpt_root).free
    if in_memory:
        meminfo = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
        free = min(free, int(meminfo["MemAvailable"].split()[0]) * 1024)
    backend = world_backend(torch.device("cuda"), TW_RANKS, torch.cuda.device_count())
    card_free, card_total = torch.cuda.mem_get_info()
    print(f"phase 15: {TW_RANKS} ranks on {torch.cuda.device_count()} card(s) as (data, model) {TW_LAYOUT}, backend "
          f"{backend}; checkpoints in {ckpt_root} ({'memory' if in_memory else 'disk'}): {free / 1e9:.1f} GB free, "
          f"need {need / 1e9:.1f} GB ({TW_KEEP} of {ckpt_bytes / 1e9:.1f} GB, + 10%); the card {card_free / 2**30:.2f} of "
          f"{card_total / 2**30:.2f} GiB free, this process holding {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved) ({card})")
    try:
        if free < need:
            fail(f"phase 15: {free / 1e9:.1f} GB free for checkpoints, {need / 1e9:.1f} GB needed")
        # 4 ranks of ~19 GB share the card: expandable segments keep each allocator's reserve near its use
        alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            ranks = spawn_world(train_rank, TW_RANKS, device="cuda", layout=TW_LAYOUT, args=(ckpt_root,),
                                timeout_s=TW_TIMEOUT_S, init_timeout_s=300)
        except Exception as e:  # a rank's failure (its traceback), a dead rank or the timeout
            fail(f"phase 15: {e}")
        finally:
            if alloc_conf is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    t_world = time.perf_counter() - t_phase
    launches, launches_2d = dict.fromkeys(counted, 0), dict.fromkeys(counted, 0)
    names = {"k1": "moe_gemm_grouped", "k2": "moe_gemm_grouped_dgrad", "k3": "moe_gemm_grouped_wgrad"}

    def losses(run):
        return [h["loss"] for h in run["res"]["history"]]

    c0 = ranks[0]["clean"]
    for r, rank in enumerate(ranks):
        clean, fault, el = rank["clean"], rank["fault"], rank["elastic"]
        lc = losses(clean)
        if clean["res"]["final_step"] != TW_STEPS or not np.all(np.isfinite(lc)) or not lc[-1] < lc[0]:
            fail(f"phase 15 rank {r}: the clean run's losses {lc} (final step {clean['res']['final_step']}): finite "
                 f"and falling expected")
        if lc != losses(c0):
            fail(f"phase 15 rank {r}: the clean run's losses differ from rank 0's (the global batch's loss on every rank)")
        if fault["fired"] != (r == TW_FAULT_RANK) or fault["res"]["failures"] != 1 or fault["res"]["final_step"] != TW_STEPS:
            fail(f"phase 15 rank {r}: the fault run fired {fault['fired']}, failures {fault['res']['failures']}, final "
                 f"step {fault['res']['final_step']}: one failure on every rank, injected on rank {TW_FAULT_RANK} only")
        if [h["step"] for h in fault["res"]["history"]] != list(range(TW_STEPS)):
            fail(f"phase 15 rank {r}: the fault run's history steps {[h['step'] for h in fault['res']['history']]}")
        if not math.isclose(fault["res"]["final_loss"], clean["res"]["final_loss"], rel_tol=TW_LOSS_RTOL):
            fail(f"phase 15 rank {r}: the fault run's final loss {fault['res']['final_loss']} against the clean run's "
                 f"{clean['res']['final_loss']} (rtol {TW_LOSS_RTOL})")
        le = losses(el)
        if el["res"]["final_step"] != TW_STEPS + TW_MORE_STEPS or not np.all(np.isfinite(le)) or \
                [h["step"] for h in el["res"]["history"]] != list(range(TW_STEPS, TW_STEPS + TW_MORE_STEPS)):
            fail(f"phase 15 rank {r}: the restart on {TW_LAYOUT_B}: history {el['res']['history']}")
        # K1 twice a step (remat per block recomputes the forward), K2/K3 once: each (live phase slots + the local
        # block) launches a layer call
        executed = {"clean": TW_STEPS, "fault": TW_STEPS + TW_FAULT_AT - TW_CKPT_EVERY, "elastic": TW_MORE_STEPS}
        for run_name, n_steps in executed.items():
            run = rank[run_name]
            per_call = run["live"] + 1
            want = {"k1": 2 * per_call * n_steps, "k2": per_call * n_steps, "k3": per_call * n_steps}
            if run["launches"] != want:
                fail(f"phase 15 rank {r} {run_name}: K1/K2/K3 launched {run['launches']}, expected {want} "
                     f"({n_steps} steps, {per_call} launches a layer call)")
            for k, v in run["launches"].items():
                launches[names[k]] += v
        for run_name in ("clean", "clean_2d"):
            run = rank[run_name]
            held_n = {k: v["n"] for k, v in run["held"].items()}
            per_call = run["live"] + 1
            if held_n != {"k1": 2 * per_call, "k2": per_call, "k3": per_call}:
                fail(f"phase 15 rank {r} {run_name}: K1/K2/K3 held {held_n} times in the first step, expected every "
                     f"launch of it")
        # the 2D run: every step's loss the clean run's within TW_2D_LOSS_RTOL, the same on every rank; each rank
        # holds its 4 experts' half of the FFN width; launches as the clean run's steps; less memory a rank
        r2 = rank["clean_2d"]
        l2 = losses(r2)
        if r2["res"]["final_step"] != TW_2D_STEPS or len(l2) != TW_2D_STEPS or not np.all(np.isfinite(l2)):
            fail(f"phase 15 rank {r} 2D: losses {l2}, final step {r2['res']['final_step']}")
        if l2 != losses(ranks[0]["clean_2d"]):
            fail(f"phase 15 rank {r} 2D: the losses differ from rank 0's")
        rel_2d = [abs(a - b) / abs(b) for a, b in zip(l2, lc)]
        if max(rel_2d) > TW_2D_LOSS_RTOL:
            fail(f"phase 15 rank {r} 2D: losses {l2} against the clean run's {lc[:TW_2D_STEPS]}: relative "
                 f"{max(rel_2d):.3g} beyond {TW_2D_LOSS_RTOL}")
        n_exp = 8 // TW_LAYOUT[1]
        want_shapes = {"w_gate": [n_exp, 4096, 14336 // TW_LAYOUT[0]], "w_up": [n_exp, 4096, 14336 // TW_LAYOUT[0]],
                       "w_down": [n_exp, 14336 // TW_LAYOUT[0], 4096]}
        if {n.rsplit(".", 1)[-1]: v for n, v in r2["expert_shapes"].items()} != want_shapes:
            fail(f"phase 15 rank {r} 2D: expert shapes {r2['expert_shapes']}, expected {want_shapes}")
        per_call = r2["live"] + 1
        want = {"k1": 2 * per_call * TW_2D_STEPS, "k2": per_call * TW_2D_STEPS, "k3": per_call * TW_2D_STEPS}
        if r2["launches"] != want:
            fail(f"phase 15 rank {r} 2D: K1/K2/K3 launched {r2['launches']}, expected {want}")
        for k, v in r2["launches"].items():
            launches_2d[names[k]] += v
        if not r2["peak_gb"] < clean["peak_gb"]:
            fail(f"phase 15 rank {r} 2D: peak memory {r2['peak_gb']:.2f} GB, not below the clean run's "
                 f"{clean['peak_gb']:.2f}")
    held = {k: max(rank["clean"]["held"][k]["max"] for rank in ranks) for k in ("k1", "k2", "k3")}
    held_2d = {k: max(rank["clean_2d"]["held"][k]["max"] for rank in ranks) for k in ("k1", "k2", "k3")}
    lc, lf = losses(c0), losses(ranks[0]["fault"])
    bit_equal = all(losses(rank["fault"]) == losses(rank["clean"]) for rank in ranks)

    def step_ms(run):
        ms = sorted(h["dt_s"] * 1e3 for h in run["res"]["history"][1:])
        return ms[len(ms) // 2]

    numbers = {
        "label": TW_LABEL, "layout": list(TW_LAYOUT), "layout_b": list(TW_LAYOUT_B), "batch": TW_BATCH, "seq": TW_SEQ,
        "params_b_per_rank": [rank["clean"]["params_b"] for rank in ranks],
        "params_b_per_rank_b": [rank["elastic"]["params_b"] for rank in ranks],
        "clean_losses": lc, "fault_losses": lf, "elastic_losses": losses(ranks[0]["elastic"]),
        "fault_bit_equal": bit_equal,
        "peak_gb": {run: [rank[run]["peak_gb"] for rank in ranks] for run in ("clean", "fault", "elastic")},
        "step_ms": {run: max(step_ms(rank[run]) for rank in ranks) for run in ("clean", "fault", "elastic")},
        "saves": [{k: v for k, v in rec.items()} for run in ("clean", "fault", "elastic")
                  for rec in ranks[0][run]["saves"]],
        "restores": {run: [rank[run]["restores"] for rank in ranks] for run in ("fault", "elastic")},
        "held": held, "world_s": t_world,
        "run_2d": {"steps": TW_2D_STEPS, "losses": losses(ranks[0]["clean_2d"]),
                   "loss_rel_to_clean": max(abs(a - b) / abs(b) for a, b in zip(losses(ranks[0]["clean_2d"]), lc)),
                   "params_b_per_rank": [rank["clean_2d"]["params_b"] for rank in ranks],
                   "peak_gb": [rank["clean_2d"]["peak_gb"] for rank in ranks],
                   "step_ms": max(step_ms(rank["clean_2d"]) for rank in ranks),
                   "wall_s": max(rank["clean_2d"]["wall_s"] for rank in ranks), "held": held_2d,
                   "launches": launches_2d},
    }
    print(f"phase 15: 1-layer full-width Mixtral-8x7B trained across {TW_RANKS} ranks (data, model) {TW_LAYOUT}, "
          f"phase_pipelined, {TW_BATCH} x {TW_SEQ} tokens, {numbers['params_b_per_rank'][0]:.3f} B parameters a rank: "
          f"clean losses {[round(v, 4) for v in lc]} ({card})")
    print(f"phase 15: a fault on rank {TW_FAULT_RANK} at step {TW_FAULT_AT} rolled every rank back to step "
          f"{TW_CKPT_EVERY}: final loss {lf[-1]:.6f} against the clean run's {lc[-1]:.6f} (rtol {TW_LOSS_RTOL}); every "
          f"step's loss equal to the clean run's bit for bit on every rank: {bit_equal} ({card})")
    print(f"phase 15: the step-{TW_STEPS} checkpoint restored onto (data, model) {TW_LAYOUT_B} "
          f"({numbers['params_b_per_rank_b'][0]:.3f} B parameters a rank): losses "
          f"{[round(v, 4) for v in numbers['elastic_losses']]} ({card})")
    print(f"phase 15: every K1 launch and K2/K3 launch pair of each rank's first step held against the plain versions: "
          f"K1 max err {held['k1']:.4g}, K2 max err {held['k2']:.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|), K3 rel L2 "
          f"{held['k3']:.3g} (tol {WGRAD_REL_L2}); launches {launches} ({card})")
    n2 = numbers["run_2d"]
    print(f"phase 15 2D (expert_2d, {TW_LAYOUT}, 4 experts x F/2 a rank, {n2['params_b_per_rank'][0]:.3f} B parameters "
          f"a rank): losses {[round(v, 6) for v in n2['losses']]} against the clean run's "
          f"{[round(v, 6) for v in lc[:TW_2D_STEPS]]}: relative {n2['loss_rel_to_clean']:.3g} (tol {TW_2D_LOSS_RTOL}); "
          f"peak memory a rank {[round(v, 2) for v in n2['peak_gb']]} GB against the clean run's "
          f"{[round(v, 2) for v in numbers['peak_gb']['clean']]}; {n2['step_ms']:.1f} ms a step (the slowest rank's "
          f"median after step 0), {n2['wall_s']:.1f} s for the run | {TW_LABEL} ({card})")
    print(f"phase 15 2D: every K1 launch and K2/K3 launch pair of each rank's first step held against the plain "
          f"versions: K1 max err {held_2d['k1']:.4g}, K2 max err {held_2d['k2']:.4g}, K3 rel L2 {held_2d['k3']:.3g}; "
          f"launches {launches_2d} ({card})")
    for run in ("clean", "fault", "elastic"):
        print(f"phase 15 {run}: peak memory a rank {[round(v, 2) for v in numbers['peak_gb'][run]]} GB "
              f"(torch.cuda.max_memory_allocated); {numbers['step_ms'][run]:.1f} ms a step (the slowest rank's median "
              f"after step 0) | {TW_LABEL} ({card})")
    for rec in numbers["saves"]:
        print(f"phase 15 checkpoint step {rec['step']} (rank 0): snapshot and gathers {rec['snapshot_s']:.1f} s "
              f"blocking ({rec['nbytes'] / 1e9:.2f} GB to the host), background write {rec['write_s']:.1f} s ({card})")
    for run, recs in numbers["restores"].items():
        print(f"phase 15 {run}: restores a rank (step, s) {[[(r_['step'], round(r_['s'], 1)) for r_ in rr] for rr in recs]} "
              f"({card})")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s wall, the world {t_world:.1f} s ({card})")
    return launches, launches_2d, numbers


def main() -> None:
    t_script = time.perf_counter()
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
    from repro_torch.kernels.mamba_scan import ops as k6
    from repro_torch.core import ComputeModel, ScheduleRuntime, knee_model, make_serving_controller
    from repro_torch.core.schedule import TABLE_LEAVES
    from repro_torch.launch import simulate
    from repro_torch.launch.serve import controller_line, demand_estimate, serve
    from repro_torch.configs import ARCHS as ARCH_REGISTRY
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.launch import shapes
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

    def close_f32(out, ref, what: str) -> float:
        if not torch.isfinite(out).all():
            fail(f"{what}: non-finite output")
        err = (out - ref).abs()
        if float((err - WKV_TOL * ref.abs()).max()) > WKV_TOL:
            fail(f"{what}: max |kernel - plain| {float(err.max()):.4g} beyond {WKV_TOL} + {WKV_TOL}*|plain|")
        return float(err.max())

    COUNTED = {
        "moe_gemm_grouped": k1.moe_gemm, "flash_attention_fwd": k4.flash_attention,
        "moe_gemm_grouped_dgrad": k1.moe_gemm_dgrad, "moe_gemm_grouped_wgrad": k1.moe_gemm_wgrad,
        "moe_gemm_ungrouped": k1.moe_gemm_ungrouped, "wkv6": k5.wkv6, "wkv6_bwd": k5.wkv6_bwd,
        "selective_scan": k6.selective_scan, "mamba_scan_bwd": k6.selective_scan_bwd,
    }

    def reset_counts():
        for fn in COUNTED.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in COUNTED.items()}

    def rel_l2(a, b) -> float:
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def counting_engine_steps(kinds: dict, comparing: list):
        """``ServeEngine._step`` patched to count each call's launches in ``kinds`` by the call's kind: captured
        (a replay launches what the capture recorded; replays do not pass the wrappers' counters), the
        capture's warm-up step (a real decode step on copies), or a comparison (``comparing[0]`` set)."""
        from repro_torch.serve import ServeEngine

        real_step = ServeEngine._step

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

        return mock.patch.object(ServeEngine, "_step", counted_step)

    def engine_launches_of(kinds: dict, counted: dict, replays: int):
        """The main path's launches of an engine run: the wrappers' counts, less the capture's (no launch) and
        the comparisons', plus each replay's recorded launches; with the capture's and the warm-up's calls."""
        captured = kinds.get("captured", dict.fromkeys(COUNTED, 0) | {"calls": 0})
        warmup = kinds.get("warmup", dict.fromkeys(COUNTED, 0) | {"calls": 0})
        comparison = kinds.get("comparison", dict.fromkeys(COUNTED, 0))
        main_ = {name: counted[name] - captured[name] - comparison[name] + replays * captured[name] for name in COUNTED}
        return main_, captured, warmup

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
        del w0, x, rv, out
        # the library call beside K1: torch.bmm SwiGLU over the live experts only (the first min(b, E): rows go
        # round robin, and their weights are a prefix view) at ceil(b / E) rows an expert, timed as K1 is (a CUDA
        # graph replay of back-to-back calls rotating over the weight copies)
        copies = simulate.rank_weights(name, device=dev, copies=simulate.COPIES)
        library_us = {}
        for b in KNEE_LIBRARY_B:
            live = min(b, prof.experts)
            x = simulate.rank_batch(name, b, device=dev)[0][:live, :-(-b // prof.experts)].contiguous()

            def lib_call(i, x=x, live=live):
                wg, wu, wd = (w[:live] for w in copies[i % len(copies)])
                return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

            for i in range(simulate.WARMUP):
                lib_call(i)
            library_us[b] = simulate._device_us(lib_call, dev, simulate.REPS)
            print(f"K1 knee {name} b={b}: torch.bmm SwiGLU over x{list(x.shape)} {library_us[b]:.2f} us (graph) "
                  f"beside K1 {prof.device_us[prof.batches.index(b)]:.2f} us ({card})")
        knee[name] = {
            "experts": prof.experts, "batches": prof.batches, "device_us": prof.device_us, "call_us": prof.call_us,
            "device_fit": [prof.device_fit.floor_us, prof.device_fit.per_token_us],
            "call_fit": [prof.call_fit.floor_us, prof.call_fit.per_token_us], "max_abs_err": err,
            "library_device_us": library_us,
        }
        del copies, x
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
        controller=True, virtual_ranks=VIRTUAL_RANKS, drift="none", seed=0,
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

    k4_layer_rel = []  # per held K4 call: (the largest relative L2 over its (b, head)s, median |plain|)

    def held_k4(q, k, v, *, causal=True, window=None, prescale=1.0):
        out = k4._launch(q, k, v, causal=causal, window=window, prescale=prescale)  # a comparison launch: not counted
        ref = plain_flash(q, k, v, causal=causal, window=window, prescale=prescale)
        what = f"K4 in layer {len(k4_layer_errs)}"
        k4_layer_errs.append(close(out, ref, what))
        o, r = out.float().flatten(2), ref.float().flatten(2)
        rel = float(((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)).max())
        k4_layer_rel.append((rel, float(r.abs().median())))
        if rel > K4_REL_L2:
            fail(f"{what}: relative L2 over a (b, head) {rel:.3g} beyond {K4_REL_L2} (median |plain| "
                 f"{k4_layer_rel[-1][1]:.3g})")
        return out

    def k4_rel_text() -> str:
        """The held K4 calls' worst relative L2 over a (b, head), beside its limit and the median |plain|."""
        rel, med = max(k4_layer_rel)
        return f"rel L2 over a (b, head) {rel:.3g} (tol {K4_REL_L2}; median |plain| there {med:.3g})"

    k6_layer_errs, k5_layer_errs = [], []

    def held_k6(x, dt, bm, cm, a, d_skip, h0=None, h_out=None):
        ref_y, ref_h = k6.selective_scan_plain(x, dt, bm, cm, a, d_skip, h0)  # before the kernel writes h_out
        y, h = k6._launch(x, dt, bm, cm, a, d_skip, h0, h_out)  # a comparison launch: not counted
        n = len(k6_layer_errs)
        k6_layer_errs.append(max(close_f32(y, ref_y, f"K6 y in Mamba layer {n}"),
                                 close_f32(h, ref_h, f"K6 h in Mamba layer {n}")))
        return y, h

    def held_k5(r, k, v, w, u, s0=None):
        y, s_fin = k5._launch(r, k, v, w, u, s0)  # a comparison launch: not counted
        y_ref, s_ref = k5.wkv6_plain(r, k, v, w, u, s0)
        n = len(k5_layer_errs)
        k5_layer_errs.append(max(close_f32(y, y_ref, f"K5 in layer {n} y"), close_f32(s_fin, s_ref, f"K5 in layer {n} S")))
        return y, s_fin

    held_kernels = {"K1": (k1, "moe_gemm", held_k1, k1_layer_errs), "K4": (k4, "flash_attention", held_k4, k4_layer_errs),
                    "K6": (k6, "selective_scan", held_k6, k6_layer_errs), "K5": (k5, "wkv6", held_k5, k5_layer_errs)}

    def kernels_held(what: str, fn, **expect):
        """``fn()`` with K1, K4, K6 and K5 each held against its plain version on every call's own inputs
        (comparison launches, not counted); fails unless each was held in ``expect[name]`` calls (0 where not
        given).  Returns fn's result and each held kernel's largest max |kernel - plain|."""
        for *_, errs in held_kernels.values():
            errs.clear()
        k4_layer_rel.clear()
        with contextlib.ExitStack() as stack:
            for mod, attr, held, _ in held_kernels.values():
                stack.enter_context(mock.patch.object(mod, attr, held))
            out = fn()
        got = {name: len(errs) for name, (*_, errs) in held_kernels.items()}
        want = {name: expect.get(name, 0) for name in held_kernels}
        if got != want:
            fail(f"{what}: kernels held in {got} calls, expected {want}")
        return out, {name: max(errs) for name, (*_, errs) in held_kernels.items() if errs}

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
        k4_layer_rel.clear()
        with mock.patch.object(k1, "moe_gemm", held_k1), mock.patch.object(k4, "flash_attention", held_k4):
            kernel_logits = prefill_logits(p, table=table)
        if len(k1_layer_errs) != LAYERS or len(k4_layer_errs) != LAYERS or not torch.isfinite(kernel_logits).all():
            fail(f"Mixtral bf16 prefill ({label}): K1 held in {len(k1_layer_errs)} and K4 in {len(k4_layer_errs)} "
                 f"of {LAYERS} layers, or non-finite logits")
        print(f"{label}: K1 inside the {LAYERS}-layer bf16 prefill, on each layer's own packed inputs: max_abs_err "
              f"{max(k1_layer_errs):.4g}; K4 on each layer's own strided q/k/v: max_abs_err {max(k4_layer_errs):.4g} "
              f"(tol {BF16_TOL} + {BF16_TOL}*|plain|), {k4_rel_text()}")
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
        kinds, comparing = {}, [False]  # each call of the step function, by kind (counting_engine_steps)

        real_decode, real_prefill = eng._decode_once, eng._prefill_row
        steps, prefill_ms, held, first_fire_held = [], {}, [], [False]
        # K1 and K4 held against their plain versions at the shapes this path gives
        # them: batch-1 prefill per bucket, decode under the controller's tables
        k_held = {"prefill": {}, "decode": [], "after_cold": None}

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
                ref, errs = kernels_held(f"engine decode step {len(steps) + 1}", eng.step_on_copies, K1=LAYERS)
                comparing[0] = False
                k_held["decode"].append((len(steps) + 1, errs["K1"]))
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
                again, errs = kernels_held(f"engine prefill bucket {bucket}", lambda: real_prefill(req, bucket),
                                           K1=LAYERS, K4=LAYERS)
                k_held["prefill"][bucket] = (errs["K1"], errs["K4"])
                if not all(torch.equal(a[key], b[key]) for a, b in zip(row, again[0]) for key in a):
                    fail(f"engine prefill bucket {bucket}: the row differs from the same prefill with K1 and K4 held")
            return row, plen

        eng._decode_once, eng._prefill_row = held_decode, timed_prefill
        phase, snaps = [None], {}
        reset_counts()
        with counting_engine_steps(kinds, comparing):
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

        main, captured, warmup = engine_launches_of(kinds, counted, eng.graph_replays)
        if captured["calls"] != 1:
            fail(f"engine: {captured['calls']} captures")
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
        return main, pools

    # 6c. serve through the engine: the same model behind ServeEngine (the
    # JAX drift run's knobs), continuous batching over 8 slots at ragged
    # depths, the decode step one CUDA graph under the device controller
    engine_launches, engine_pools = serve_engine_phase(model)
    engine_pool = engine_pools["A"]

    def hierarchical_engine_phase(model, pools) -> dict:
        """Phase 14c (see the module doc).  Returns the main path's launches per kernel."""
        from repro_torch.core import DeviceController, HierarchicalDeviceController
        from repro_torch.serve import Request, ServeEngine

        t_phase = time.perf_counter()
        hcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe, dispatch="hierarchical",
                                                                 pod_size=HIER_POD_SIZE))
        saved_cfg, model.cfg = model.cfg, hcfg  # the model's layers read the dispatch from it
        eng = ServeEngine(hcfg, model, **HIER_ENGINE_KW)
        ctrl = eng._ctrl
        if not isinstance(ctrl, HierarchicalDeviceController):
            fail(f"phase 14c: the engine built a {type(ctrl).__name__}, not the two-level controller")
        # a CPU twin of the two-level controller, fed the routing the engine copies to the host, step for step
        twin = HierarchicalDeviceController(DeviceController(ctrl.intra.cfg, device="cpu"),
                                            DeviceController(ctrl.inter.cfg, device="cpu"), ctrl.pod_size)
        twin_state, fed = eng._state.clone("cpu"), []
        rng = np.random.default_rng(ENGINE_SEED + 1)
        kinds, comparing = {}, [False]
        real_decode, real_prefill = eng._decode_once, eng._prefill_row
        steps, prefill_ms, held, k_held = [], {}, [], {"prefill": {}, "decode": []}

        def held_decode():
            """The replay held against the eager step on copies (K1 held in every layer) at each phase's first
            step and at the step after each re-plan."""
            hold = not steps or steps[-1]["phase"] != phase[0] or steps[-1]["fire"]
            if hold:
                comparing[0] = True
                ref, errs = kernels_held(f"phase 14c decode step {len(steps) + 1}", eng.step_on_copies, K1=LAYERS)
                comparing[0] = False
                k_held["decode"].append((len(steps) + 1, errs["K1"]))
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
                    fail(f"phase 14c {phase[0]} decode step {len(steps)}: the graph replay differs from the eager "
                         f"step function on copies of its inputs")
            return nxt

        def timed_prefill(req, bucket):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            row, plen = real_prefill(req, bucket)
            torch.cuda.synchronize()
            if plen > 0:
                prefill_ms.setdefault(bucket, []).append((time.perf_counter() - t0) * 1e3)
            if plen > 0 and bucket not in k_held["prefill"]:
                again, errs = kernels_held(f"phase 14c prefill bucket {bucket}", lambda: real_prefill(req, bucket),
                                           K1=LAYERS, K4=LAYERS)
                k_held["prefill"][bucket] = (errs["K1"], errs["K4"])
                if not all(torch.equal(a[key], b[key]) for a, b in zip(row, again[0]) for key in a):
                    fail(f"phase 14c prefill bucket {bucket}: the row differs from the same prefill with K1, K4 held")
            return row, plen

        eng._decode_once, eng._prefill_row = held_decode, timed_prefill
        phase = [None]
        reset_counts()
        with counting_engine_steps(kinds, comparing):
            for name in ("A", "B"):
                phase[0] = name
                arrivals = np.floor(np.cumsum(rng.exponential(1.0, HIER_REQUESTS))).astype(int)
                reqs = [Request(prompt=rng.choice(pools[name], int(rng.integers(*ENGINE_PROMPT))),
                                max_new_tokens=int(rng.integers(*ENGINE_NEW)), arrival=float(a)) for a in arrivals]
                t0 = time.perf_counter()
                out = eng.run(reqs)
                wall = time.perf_counter() - t0
                for routing, dropped in fed:
                    twin.step(twin_state, routing, dropped)
                fed.clear()
                done, tokens = sum(r.done for r in reqs), sum(len(r.tokens) for r in reqs)
                if done != len(reqs):
                    fail(f"phase 14c {name}: {done} of {len(reqs)} requests completed")
                for leaf_name, leaf in eng._state.leaves().items():
                    mine, theirs = leaf.cpu(), twin_state.leaves()[leaf_name]
                    ok = torch.allclose(mine, theirs, rtol=1e-6, atol=0) if mine.is_floating_point() else \
                        torch.equal(mine, theirs)
                    if not ok:
                        fail(f"phase 14c {name}: controller leaf {leaf_name} differs from the CPU twin's")
                m = out["controller"]
                print(f"phase 14c {name}: completed {done}/{len(reqs)} | {tokens} tokens in {wall:.2f} s, "
                      f"{tokens / wall:.1f} tok/s | two-level controller: re-plans {m['device_replans']} (intra "
                      f"{m['intra']['device_replans']}, inter {m['inter']['device_replans']}), drop fraction "
                      f"{m['drop_fraction']:.4f}; the CPU twin fed the same routing agrees leaf for leaf ({card})")
        counted = read_counts()
        del eng._decode_once, eng._prefill_row
        main, captured, warmup = engine_launches_of(kinds, counted, eng.graph_replays)
        n_prefill, n_decode = sum(len(v) for v in prefill_ms.values()), len(steps)
        expect = dict.fromkeys(COUNTED, 0)
        expect.update(moe_gemm_grouped=LAYERS * (n_prefill + n_decode + warmup["calls"]),
                      flash_attention_fwd=LAYERS * n_prefill)
        if captured["calls"] != 1 or main != expect or eng.graph_replays != n_decode:
            fail(f"phase 14c: launches {main}, expected {expect}; {captured['calls']} captures, "
                 f"{eng.graph_replays} replays of {n_decode} decode steps")
        if not k_held["prefill"] or not k_held["decode"]:
            fail(f"phase 14c: K1/K4 held in prefills {k_held['prefill']}, K1 in decode steps {k_held['decode']}")
        plain = [st["ms"] for st in steps if not st["fire"]]
        fired = [e for e in eng.replan_log]
        row = {"decode_ms_per_step": float(np.median(plain)), "decode_steps": n_decode,
               "prefill_ms": {b: float(np.median(v)) for b, v in sorted(prefill_ms.items())},
               "replans": [(e["decode_step"], e["kind"], e["ms"]) for e in fired],
               "held_max_abs_err": {"K1": max(v for _, v in k_held["decode"]),
                                    "K4": max(e[1] for e in k_held["prefill"].values())},
               "launches": main, "wall_s": time.perf_counter() - t_phase}
        print(f"phase 14c: full-width Mixtral-8x7B ({LAYERS} layers) through ServeEngine with dispatch hierarchical "
              f"(pod size {HIER_POD_SIZE} over {HIER_ENGINE_KW['n_ranks']} virtual ranks) | decode as one graph "
              f"{row['decode_ms_per_step']:.2f} ms a step (host clock, median of {len(plain)} steps without a "
              f"re-plan) | batch-1 prefill {row['prefill_ms']} ms a bucket | re-plans {row['replans']} | replay held "
              f"against the eager step at {len(held)} steps | K1 held in every layer of those steps (max_abs_err "
              f"{row['held_max_abs_err']['K1']:.4g}) and K1/K4 in one prefill a bucket (K4 max_abs_err "
              f"{row['held_max_abs_err']['K4']:.4g}) | launches {main} | {row['wall_s']:.1f} s ({card})")
        model.cfg = saved_cfg
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return row

    # 14c. the two-level controller behind the engine on the same model (run here, while the model is alive)
    hier_engine = hierarchical_engine_phase(model, engine_pools)

    del model, drift_table, dres
    torch.cuda.empty_cache()

    # the per-config serving check of phases 6d and 12: serve() at full width, then a bf16 prefill with every
    # kernel held on each layer's own inputs, and each kernel's row at the inputs of its first call
    def k4_row_at(q, k, v, *, causal=True, window=None, prescale=1.0) -> dict:
        """K4 at one call's inputs: the held errors so far, kernel / plain / SDPA times, and the bound on the
        keys each query row sees (the causal triangle, cut by the window)."""
        b_, h_, sq_, d_ = q.shape
        kh_, skv = k.shape[1], k.shape[2]
        seen = torch.clamp(torch.arange(sq_, dtype=torch.float64) + (skv - sq_) + 1, max=skv)
        if window is not None:
            seen = torch.clamp(seen, max=window)
        b_ms, b_by = bound(4.0 * d_ * b_ * h_ * float(seen.sum()), 2 * (2 * b_ * h_ * sq_ * d_ + 2 * b_ * kh_ * skv * d_))
        mask = None if window is None else k4.attention_mask(sq_, skv, causal=causal, window=window, device=dev)
        rel, med = max(k4_layer_rel)
        extra = {}
        if window is not None and skv > window > 64:
            # the per-head check must see a window fault: the plain version with the window edge moved by one
            # 64-key tile, against itself
            ref = plain_flash(q, k, v, causal=causal, window=window, prescale=prescale).float().flatten(2)
            moved = plain_flash(q, k, v, causal=causal, window=window - 64, prescale=prescale).float().flatten(2)
            extra["window_moved_rel_l2"] = float(((moved - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
            print(f"K4 window {window} moved to {window - 64} in the plain version: rel L2 over a (b, head) "
                  f"{extra['window_moved_rel_l2']:.3g} against the limit {K4_REL_L2}")
            if extra["window_moved_rel_l2"] <= K4_REL_L2:
                fail("K4: a window edge moved by a tile stays within K4_REL_L2, so the per-head check is blind to it")
            del ref, moved
        return {
            "shape": f"q[{b_},{h_},{sq_},{d_}] kv[{b_},{kh_},{skv},{d_}] causal, window {window}, GQA group "
                     f"{h_ // kh_}, the model's views",
            "max_abs_err": max(k4_layer_errs), "rel_l2": rel, "median_abs_plain": med,
            "ms": graph_ms(lambda: k4._launch(q, k, v, causal=causal, window=window, prescale=prescale), 20),
            "plain_ms": cuda_ms(lambda: plain_flash(q, k, v, causal=causal, window=window, prescale=prescale), 2,
                                warmup=1),
            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None, scale=prescale * d_**-0.5, enable_gqa=True), 20),
            "bound_ms": b_ms, "bound_by": b_by, **extra,
        }

    def k1_row_at(x, w_gate, w_up, w_down, row_valid) -> dict:
        """K1 at one call's inputs: the held error so far, kernel / plain / torch.bmm SwiGLU times, and the
        bound on the tiles this run's routing occupies."""
        e_, c_, d_ = x.shape
        f_ = w_gate.shape[-1]
        occ = k1.tile_occupancy(row_valid)
        rows, live = int(occ.sum()), int(occ.any(dim=1).sum())
        b_ms, b_by = bound(6.0 * d_ * f_ * rows, rows * d_ * 2 + live * 3 * d_ * f_ * 2 + e_ * c_ + e_ * c_ * d_ * 2)
        return {
            "shape": f"x[{e_},{c_},{d_}] w[{e_},{d_},{f_}] occupied rows {rows}, live experts {live}",
            "max_abs_err": max(k1_layer_errs), "ms": graph_ms(lambda: k1._launch(x, w_gate, w_up, w_down, row_valid), 10),
            "plain_ms": cuda_ms(lambda: k1.moe_gemm_plain(x, w_gate, w_up, w_down, row_valid), 1, warmup=1),
            "library_ms": graph_ms(lambda: torch.bmm(F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up), w_down), 10),
            "bound_ms": b_ms, "bound_by": b_by,
        }

    def k6_cost(x, dt, bm, cm, a, d_skip, h0) -> dict:
        """The least time: the largest of the bytes over the memory rate, the f32 FLOPs (4 a state and step,
        2 a channel and step for the skip) over the f32 peak and the exponentials over the SFU rate."""
        b_, s_, di = x.shape
        ds = a.shape[1]
        nbytes = x.numel() * x.element_size() + 4 * (dt.numel() + bm.numel() + cm.numel() + a.numel() + di
                                                     + b_ * s_ * di + b_ * di * ds * (2 if h0 is not None else 1))
        times = {"bytes": nbytes / HBM_BYTES_PER_S, "f32 FLOPs": (4.0 * ds + 2.0) * b_ * s_ * di / PEAK_F32_FLOPS,
                 "exponentials": float(b_ * s_ * di * ds) / EXP_PER_S}
        by = max(times, key=times.get)
        return {"bound_ms": times[by] * 1e3, "bound_by": "bytes" if by == "bytes" else "operations",
                "bound_set_by": by, "bound_parts_ms": {key: v * 1e3 for key, v in times.items()}}

    def k6_row_at(x, dt, bm, cm, a, d_skip, h0=None, h_out=None) -> dict:
        """K6 at one call's inputs: the held error so far, kernel and plain times, and the bound."""
        return {
            "shape": f"x[{','.join(map(str, x.shape))}] {str(x.dtype).removeprefix('torch.')} ds {a.shape[1]}, "
                     + ("from zeros" if h0 is None else "from the carried state"),
            "max_abs_err": max(k6_layer_errs), "ms": graph_ms(lambda: k6._launch(x, dt, bm, cm, a, d_skip, h0, h_out), 20),
            "plain_ms": cuda_ms(lambda: k6.selective_scan_plain(x, dt, bm, cm, a, d_skip, h0), 2, warmup=1),
            "library_ms": None, **k6_cost(x, dt, bm, cm, a, d_skip, h0),
        }

    def print_rows(arch, rows) -> None:
        for name, row in rows.items():
            lib = {"flash_attention_fwd": "SDPA", "moe_gemm_grouped": "torch.bmm SwiGLU"}.get(name)
            print(f"{arch}: {name} at its first layer's {row['shape']}: kernel {row['ms']:.4f} ms | plain "
                  f"{row['plain_ms']:.3f} ms" + (f" | {lib} {row['library_ms']:.4f} ms" if lib else "")
                  + f" | bound {row['bound_ms']:.4f} ms ({row.get('bound_set_by', row['bound_by'])}), "
                  f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound ({card})")

    def serve_and_hold(acfg, bsz: int, plen: int, new: int, rounds: int, prompt_seed: int):
        """Serve ``acfg`` with seeded weights through serve(), the controller on, and check it: each kernel
        launched once a layer that runs it in each prefill and decode step, tokens and logits in range, the
        MoE stats and a cold plan kept.  Then a bf16 prefill of fresh prompts (``prompt_seed``) under the
        served table with K1, K4 and K6 held on each layer's own inputs, and each kernel's row at its first
        call's inputs.  Returns the model, the serve result, the launches, the held logits, the prompts and
        the prefix embeddings (None without a frontend), and the rows by kernel name."""
        arch = acfg.name
        kinds = [acfg.layer_kind(l) for l in range(acfg.n_layers)]
        n_attn, n_mamba, n_moe = kinds.count("attn"), kinds.count("mamba"), acfg.n_moe_layers
        prefix = acfg.frontend_tokens if acfg.frontend != "none" else 0
        t0 = time.perf_counter()
        amodel = Model(acfg, device=dev, seed=0)
        torch.cuda.synchronize()
        a_params = sum(prm.numel() for prm in amodel.parameters())
        moe_text = f", {acfg.moe.n_experts} experts top-{acfg.moe.top_k} F {acfg.moe.d_ff_expert}" if n_moe else ""
        print(f"model: {arch} {acfg.n_layers} layers ({n_attn} attention, {n_mamba} Mamba, {n_moe} MoE), "
              f"{a_params / 1e9:.2f} B params ({2 * a_params / 1e9:.2f} GB bf16){moe_text}, heads "
              f"{acfg.n_heads}/{acfg.n_kv_heads} of {acfg.resolved_head_dim}, window {acfg.sliding_window}, prefix "
              f"{prefix}, init {time.perf_counter() - t0:.1f} s")
        reset_counts()
        res = serve(amodel, batch=bsz, prompt_len=plen, new_tokens=new, rounds=rounds, controller=True,
                    virtual_ranks=VIRTUAL_RANKS, drift="none", seed=0)
        got = read_counts()
        expect = dict.fromkeys(COUNTED, 0)
        expect.update(flash_attention_fwd=rounds * n_attn, selective_scan=rounds * n_mamba * (1 + new),
                      moe_gemm_grouped=rounds * n_moe * (1 + new))
        for r in range(rounds):
            print(f"{arch} serve round {r}: plan {res.plan_ms[r]:.1f} ms | prefill {res.prefill_ms[r]:.1f} ms "
                  f"({bsz * (prefix + plen) / res.prefill_ms[r] * 1e3:.0f} tok/s over {prefix} prefix + {plen} "
                  f"tokens) | decode {res.decode_ms[r]:.1f} ms ({res.decode_ms[r] / new:.2f} ms/step) ({card})")
        print(f"{arch} serve: launches {got} (expected {expect})")
        if got != expect:
            fail(f"{arch} serving path launches {got}, expected {expect}")
        if res.tokens.shape != (rounds, bsz, new) or int(res.tokens.min()) < 0 \
                or int(res.tokens.max()) >= acfg.vocab_size:
            fail(f"{arch}: generated tokens out of range or misshapen: {tuple(res.tokens.shape)}")
        if res.first_logits.shape != (bsz, acfg.vocab_size) or not torch.isfinite(res.first_logits).all():
            fail(f"{arch}: prefill logits misshapen or non-finite")
        if n_moe:
            print(f"{arch} serve: MoE routed {res.routed:.0f}, admitted {res.admitted:.0f}, dropped "
                  f"{res.dropped:.0f} | table n_phases {res.tables[-1].n_phases[0].item()} caps "
                  f"{res.tables[-1].caps[0].tolist()} envelope {list(res.tables[-1].envelope)} | "
                  f"{controller_line(res.controller[-1])}")
            if not 0 < res.admitted <= res.routed or res.dropped < 0:
                fail(f"{arch}: MoE stats inconsistent: routed {res.routed}, admitted {res.admitted}, "
                     f"dropped {res.dropped}")
            if [d_.actions for d_ in res.decisions] != [("miss",)] + [("keep",)] * (rounds - 1):
                fail(f"{arch} serving decisions {res.decisions}, expected a cold plan in round 0 kept after")
        elif res.table is not None or res.decisions:
            fail(f"{arch}: a model without MoE planned a table")

        pgen = torch.Generator(device=dev).manual_seed(prompt_seed)
        prompts = torch.randint(0, acfg.vocab_size, (bsz, plen), generator=pgen, device=dev)
        ext = None if not prefix else torch.randn((bsz, prefix, acfg.d_model), generator=pgen, device=dev).to(
            torch.bfloat16)
        first = {}

        def first_of(name, held):
            def run(*args, **kw):
                first.setdefault(name, (args, kw))
                return held(*args, **kw)
            return run

        for errs in (k1_layer_errs, k4_layer_errs, k4_layer_rel, k6_layer_errs):
            errs.clear()
        with mock.patch.object(k1, "moe_gemm", first_of("moe_gemm_grouped", held_k1)), \
                mock.patch.object(k4, "flash_attention", first_of("flash_attention_fwd", held_k4)), \
                mock.patch.object(k6, "selective_scan", first_of("selective_scan", held_k6)):
            logits = amodel.prefill(prompts, amodel.init_cache(bsz, prefix + plen), ext, schedule=res.table)[0].float()
        held = (len(k4_layer_errs), len(k6_layer_errs), len(k1_layer_errs))
        if held != (n_attn, n_mamba, n_moe) or not torch.isfinite(logits).all():
            fail(f"{arch} bf16 prefill: K4/K6/K1 held in {held} layers, expected {(n_attn, n_mamba, n_moe)}, "
                 "or non-finite logits")
        print(f"{arch}: bf16 prefill with K4 held in {n_attn}, K6 in {n_mamba}, K1 in {n_moe} layers on their own "
              f"inputs: max_abs_err K4 {max(k4_layer_errs):.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|), {k4_rel_text()}"
              + (f"; K6 {max(k6_layer_errs):.4g} (tol {WKV_TOL} + {WKV_TOL}*|plain|, f32)" if n_mamba else "")
              + (f"; K1 {max(k1_layer_errs):.4g} (tol {BF16_TOL} + {BF16_TOL}*|plain|)" if n_moe else ""))
        row_of = {"flash_attention_fwd": k4_row_at, "moe_gemm_grouped": k1_row_at, "selective_scan": k6_row_at}
        rows = {name: row_of[name](*args, **kw) for name, (args, kw) in first.items()}
        print_rows(arch, rows)
        return amodel, res, got, logits, prompts, ext, rows

    # 6d. Qwen3-MoE-235B-A22B and DBRX-132B at full width, cut to ARCH_LAYERS layers, through serve (the
    # controller plans at 16 and 2 experts a virtual rank), with K1 and K4 held per layer in a bf16 prefill;
    # then one full-width Mixtral MoE layer under a table row with the fp8 and int8 wire codecs
    t_phase = time.perf_counter()
    arch_launches, arch_rows = {}, {}
    for arch in ARCHS:
        acfg = get_config(arch)
        scfg = dataclasses.replace(acfg, n_layers=ARCH_LAYERS,
                                   moe=dataclasses.replace(acfg.moe, dispatch="phase_pipelined", use_pallas=True))
        amodel, ares, arch_launches[arch], *_, arch_rows[arch] = serve_and_hold(
            scfg, BATCH, PROMPT, ARCH_NEW, ROUNDS, prompt_seed=11)
        host_rt, host_scen = make_serving_controller(scfg, n_ranks=VIRTUAL_RANKS, drift="none", rounds=ROUNDS,
                                                     device="cpu")
        host_rt.observe(demand_estimate(scfg, float(BATCH * PROMPT * scfg.moe.top_k), host_scen, 0))
        if not all(tables_equal(t, host_rt.table()) for t in ares.tables):
            fail(f"{arch} serving tables differ from a host runtime's")
        del amodel, ares, host_rt, _
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

    # 9b. K5b (the recurrence's backward) against its plain version at the training shape r/k/v
    # [4, 64, 1024, 64]: bf16 in the model's strided [B, T, H, D] views from S = 0; f32 from a carried s0
    # with a nonzero dS_final; decays near 0 and near 1.  Comparison launches (_launch_bwd) are not counted.
    def bwd_case(dtype, strided: bool, carried: bool, decay: str | None = None):
        shape = (b5, RWKV_PROMPT, h5, hd5) if strided else (b5, h5, RWKV_PROMPT, hd5)
        view = (lambda x: x.transpose(1, 2)) if strided else (lambda x: x)
        r, k, v = (view(torch.randn(shape, generator=wgen, device=dev) * 0.5).to(dtype) for _ in range(3))
        noise = torch.randn(shape, generator=wgen, device=dev)
        if decay is None:
            w = torch.exp(-torch.exp(-2.0 + 0.5 * noise))  # the model's range
        else:
            eps = torch.rand(shape, generator=wgen, device=dev) * 1e-3 + 1e-15
            w = eps if decay == "near 0" else 1.0 - eps
        dy = view(torch.randn(shape, generator=wgen, device=dev))
        s0 = ds = None
        if carried:
            s0, ds = (torch.randn((b5, h5, hd5, hd5), generator=wgen, device=dev) * 0.3 for _ in range(2))
        return r, k, v, view(w), torch.randn((h5, hd5), generator=wgen, device=dev) * 0.1, dy, s0, ds

    def bwd_close(got, want, what: str) -> float:
        """Each gradient's relative L2 and max |diff| / max |plain| within WKV_BWD_TOL; returns the max |diff|."""
        worst, parts = 0.0, []
        for name, g, p_ in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
            if p_ is None:
                continue
            if not torch.isfinite(g).all():
                fail(f"{what} {name}: non-finite")
            rel, err, top = rel_l2(g, p_), float((g - p_).abs().max()), float(p_.abs().max())
            if rel > WKV_BWD_TOL or err > WKV_BWD_TOL * top:
                fail(f"{what} {name}: rel L2 {rel:.3g}, max |diff| {err:.4g} against max |plain| {top:.4g} "
                     f"(tol {WKV_BWD_TOL} each)")
            worst = max(worst, err)
            parts.append(f"{name} {rel:.3g} / {err / top:.3g}")
        print(f"K5b {what}: rel L2 / max |diff| over max |plain| (tol {WKV_BWD_TOL} each): {', '.join(parts)}")
        return worst

    k5b_err = 0.0
    for label, case in (
        ("bf16, model's strided views, S from 0", dict(dtype=torch.bfloat16, strided=True, carried=False)),
        ("f32, carried s0 and dS_final", dict(dtype=torch.float32, strided=False, carried=True)),
        ("bf16, decays near 0, carried", dict(dtype=torch.bfloat16, strided=True, carried=True, decay="near 0")),
        ("bf16, decays near 1, carried", dict(dtype=torch.bfloat16, strided=True, carried=True, decay="near 1")),
    ):
        args = bwd_case(**case)
        got = k5._launch_bwd(*args)
        torch.cuda.synchronize()
        k5b_err = max(k5b_err, bwd_close(got, k5.wkv6_bwd_plain(*args), label))
        del got
    args = bwd_case(torch.bfloat16, True, False)  # the training path's case, timed
    r, k, v, w, u5, dy, _, _ = args
    n = b5 * h5 * RWKV_PROMPT * hd5
    # 14 D^2 f32 FLOP per (b, h, t): the S and G recurrences (w * x + a * b: a MUL and an FMA, 3 each) and four
    # 64-term sums (dr, dk, dv, dw: 2 each); bytes: bf16 r/k/v, f32 w and dy read, four f32 gradients written
    b_ms, b_by = bound(14.0 * hd5 * n, n * (3 * 2 + 4 + 4) + 4 * n * 4 + 2 * h5 * hd5 * 4, PEAK_F32_FLOPS)
    k5b_row = {
        "shape": f"r/k/v[{b5},{h5},{RWKV_PROMPT},{hd5}] bf16 as [B, T, H, D] views, w and dy f32, S from 0",
        "max_abs_err": k5b_err,
        "ms": cuda_ms(lambda: k5._launch_bwd(*args), 10),
        "plain_ms": cuda_ms(lambda: k5.wkv6_bwd_plain(*args), 1, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "forward_ms": cuda_ms(lambda: k5._launch(r, k, v, w, u5, None), 10),
    }
    print(f"K5b backward: {k5b_row['shape']} | kernel {k5b_row['ms']:.4f} ms | plain {k5b_row['plain_ms']:.2f} ms | "
          f"library: none | bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / k5b_row['ms']:.1f}% of bound | K5 forward "
          f"on the same inputs {k5b_row['forward_ms']:.4f} ms ({card})")
    del args, r, k, v, w, u5, dy
    torch.cuda.empty_cache()

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

    kernel_logits, errs = kernels_held("RWKV bf16 prefill", lambda: rwkv_prefill_logits(rmodel), K5=rcfg.n_layers)
    if not torch.isfinite(kernel_logits).all():
        fail("RWKV bf16 prefill: non-finite logits")
    print(f"K5 inside the {rcfg.n_layers}-layer bf16 prefill (prompt {RWKV_CHECK_PROMPT}), on each layer's own "
          f"strided inputs: max_abs_err {errs['K5']:.3g} (tol {WKV_TOL} + {WKV_TOL}*|plain|)")
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
    del caches, logits

    # 10b. the long_500k cell on the same 32-layer model: the cell applies to the subquadratic configs only,
    # the O(1) state of a 524288-token cache has the bytes of a 1024-token one, and after a 1024-token prompt
    # at batch 1 the cell's decode steps (one token at step 524287 + i, input_specs' shapes) run through K5
    def long_cell(acfg, amodel, table, gen) -> tuple[dict, dict]:
        """Phases 10b and 10c: the long_500k cell on a served model.  The cache of init_cache(1, 524288): a
        recurrent state (RWKV, Mamba) is O(1), a sliding window's ring holds only the window, a full attention
        layer holds every position.  A LONG_PROMPT-token prompt (drawn from ``gen``) at batch 1, prefilled once
        with K4, K6, K1 and K5 held against their plain versions in every layer (its logits must equal the
        counted prefill's bit for bit), then LONG_STEPS decode steps ending inside the cell with exact launches.
        Returns the numbers and the launches."""
        arch = acfg.name
        long_cell_ = shapes.CELLS["long_500k"]
        ok_, why = shapes.cell_applicable(acfg, long_cell_)
        if not ok_:
            fail(f"long_500k does not apply to {arch}: {why}")
        kinds_ = [acfg.layer_kind(l) for l in range(acfg.n_layers)]
        n_attn, n_mamba, n_rwkv = kinds_.count("attn"), kinds_.count("mamba"), kinds_.count("rwkv6")
        n_moe = acfg.n_moe_layers
        specs = shapes.input_specs(acfg, long_cell_)

        def bytes_by_kind(caches) -> dict:
            out = {}
            for kind_, c in zip(kinds_, caches):
                out[kind_] = out.get(kind_, 0) + sum(t.numel() * t.element_size() for t in c.values())
            return out

        long_caches = amodel.init_cache(long_cell_.global_batch, long_cell_.seq_len)
        long_b = bytes_by_kind(long_caches)
        row = {"cache_mb": {k: v / 1e6 for k, v in long_b.items()}}
        print(f"long_500k {arch}: init_cache(1, {long_cell_.seq_len}) {sum(long_b.values()) / 1e6:.3f} MB by layer kind "
              f"{ {k: round(v, 3) for k, v in row['cache_mb'].items()} }; input_specs "
              f"{{{', '.join(f'{k}: {tuple(t.shape)} {t.dtype}' for k, t in specs.items())}}}")
        if acfg.sliding_window:
            short_b = bytes_by_kind(amodel.init_cache(1, acfg.sliding_window))
            print(f"long_500k {arch}: init_cache(1, {acfg.sliding_window}) {sum(short_b.values()) / 1e6:.3f} MB (the "
                  f"ring holds the window); the {LONG_PROMPT}-token prompt lies outside the {acfg.sliding_window}-token "
                  f"window at position {long_cell_.seq_len - 1}, so each decode step sees only the tokens decoded "
                  f"before it, which is what attn_full computes there")
            if long_b != short_b:
                fail(f"long_500k {arch}: the ring cache grows with the context ({long_b} against {short_b})")
        for kind_ in ("mamba", "rwkv6"):
            if kind_ in long_b:
                short_b = bytes_by_kind(amodel.init_cache(1, LONG_PROMPT))
                print(f"long_500k {arch}: {kind_} state {long_b[kind_] / 1e6:.3f} MB at {long_cell_.seq_len} positions, "
                      f"{short_b[kind_] / 1e6:.3f} MB at {LONG_PROMPT} (O(1)); the {n_attn} attention layer(s) hold "
                      f"{long_b.get('attn', 0) / 1e9:.3f} GB")
                if long_b[kind_] != short_b[kind_]:
                    fail(f"long_500k {arch}: the {kind_} state grows with the context ({long_b[kind_]} against "
                         f"{short_b[kind_]} bytes)")
        # steps from the cell's last position on, where every attention layer has a window (its ring takes any
        # position) or there is none; a full attention cache holds the cell's 524288 positions, so there the
        # steps end at its last
        full_attn = n_attn > 0 and not acfg.sliding_window
        start = long_cell_.seq_len - (LONG_STEPS if full_attn else 1)
        if full_attn:
            print(f"long_500k {arch}: decode steps at {start}..{start + LONG_STEPS - 1}, the last the cell's last "
                  f"position: the attention cache holds {long_cell_.seq_len} positions")
        prompt = torch.randint(0, acfg.vocab_size, (long_cell_.global_batch, LONG_PROMPT), generator=gen, device=dev)
        held_logits, held = kernels_held(
            f"long_500k {arch} prefill",
            lambda: amodel.prefill(prompt, amodel.init_cache(long_cell_.global_batch, long_cell_.seq_len),
                                   schedule=table)[0], K1=n_moe, K4=n_attn, K6=n_mamba, K5=n_rwkv)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits, long_caches = amodel.prefill(prompt, long_caches, schedule=table)
        torch.cuda.synchronize()
        prefill_ms_ = (time.perf_counter() - t0) * 1e3
        if not torch.equal(logits, held_logits):
            fail(f"long_500k {arch}: the prefill's logits differ from the same prefill with the kernels held")
        print(f"long_500k {arch}: the {LONG_PROMPT}-token prefill with the kernels held against their plain versions "
              f"in every layer (K4 and K1 tol {BF16_TOL} + {BF16_TOL}*|plain|, K6 and K5 {WKV_TOL} + {WKV_TOL}*|plain|, "
              f"f32) gives the counted prefill's logits bit for bit: max_abs_err "
              f"{ {k: float(f'{v:.4g}') for k, v in held.items()} }")
        del held_logits
        token = torch.argmax(logits, dim=-1).to(specs["token"].dtype)
        ms_, toks = [], []
        for i in range(LONG_STEPS):
            if token.shape != specs["token"].shape:
                fail(f"long_500k {arch}: token {tuple(token.shape)} against the cell's {tuple(specs['token'].shape)}")
            t0 = time.perf_counter()
            logits, long_caches = amodel.decode_step(token, long_caches, start + i, schedule=table)
            token = torch.argmax(logits, dim=-1).to(specs["token"].dtype)
            toks.append(int(token[0]))  # reads the step back: it has finished
            ms_.append((time.perf_counter() - t0) * 1e3)
        got = read_counts()
        expect = dict.fromkeys(COUNTED, 0)
        expect.update(flash_attention_fwd=n_attn, selective_scan=n_mamba * (1 + LONG_STEPS),
                      moe_gemm_grouped=n_moe * (1 + LONG_STEPS), wkv6=n_rwkv * (1 + LONG_STEPS))
        print(f"long_500k {arch}: prefill {prefill_ms_:.1f} ms ({LONG_PROMPT} tokens, batch 1) | decode at steps "
              f"{start}..{start + LONG_STEPS - 1}: {sum(ms_) / len(ms_):.2f} ms/step "
              f"(median {sorted(ms_)[len(ms_) // 2]:.2f}) | tokens {toks} | launches {got} (expected {expect}) ({card})")
        if got != expect:
            fail(f"long_500k {arch} launches {got}, expected {expect}")
        if not torch.isfinite(logits).all() or not all(0 <= t_ < acfg.vocab_size for t_ in toks):
            fail(f"long_500k {arch}: non-finite logits or tokens out of range")
        row.update(prefill_ms=prefill_ms_, decode_ms_per_step=sum(ms_) / len(ms_), first_step=start,
                   held_max_abs_err=held)
        del long_caches, logits
        torch.cuda.empty_cache()
        return row, got

    applies = {arch: shapes.cell_applicable(get_config(arch), shapes.CELLS["long_500k"])[0]
               for arch in sorted(ARCH_REGISTRY)}
    print(f"long_500k applies: {applies}")
    if applies != {arch: get_config(arch).subquadratic for arch in applies} or not applies["rwkv6-7b"]:
        fail(f"long_500k cell_applicable {applies}: expected True for the subquadratic configs (rwkv6-7b among them)")
    long_row, long_launches = long_cell(rcfg, rmodel, None, wgen)
    del rmodel
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

    # 11. train full-width RWKV6-7B: first a train step at 1 layer, kernel path (K5, K5b) against the plain
    # path (wkv6_plain, wkv6_bwd_plain), then 4 layers through launch/train.py's train for RWKV_TRAIN_STEPS
    # steps (the slice's main path), then one more step traced
    def train_step_vs_plain(label: str, model, batch, plain, expect: dict) -> dict:
        """One loss and backward of ``model`` on ``batch`` through the kernels, then through their plain versions
        (``plain``: (module, attribute, function) patches): the loss within GRAD_REL_TOL relative, each leaf's
        gradient within GRAD_REL_TOL relative L2, and the kernel path's launches ``expect`` (the rest 0).
        Returns each leaf's relative L2; the leaves' gradients are cleared after."""
        def loss_and_grads():
            for prm in model.parameters():
                prm.grad = None
            loss = model.loss(batch)
            loss.backward()
            grads = {n: prm.grad.detach().clone() for n, prm in model.named_parameters()}
            for prm in model.parameters():
                prm.grad = None
            return loss.item(), grads

        reset_counts()
        k_loss, k_grads = loss_and_grads()
        step_counts = read_counts()
        with contextlib.ExitStack() as stack:
            for mod, attr, fn in plain:
                stack.enter_context(mock.patch.object(mod, attr, fn))
            p_loss, p_grads = loss_and_grads()
        rel = {n: rel_l2(k_grads[n], p_grads[n]) for n in p_grads}
        worst = max(rel, key=rel.get)
        want = dict.fromkeys(COUNTED, 0) | expect
        print(f"{label} train step, kernel vs plain path: loss {k_loss:.6f} vs {p_loss:.6f}, max leaf rel L2 "
              f"{rel[worst]:.3g} ({worst}; tol {GRAD_REL_TOL}), kernel-path launches {step_counts}")
        if not (math.isfinite(k_loss) and abs(k_loss - p_loss) <= GRAD_REL_TOL * abs(p_loss)) or not rel[worst] <= GRAD_REL_TOL:
            fail(f"{label} train step: kernel path differs from the plain path (loss {k_loss} vs {p_loss}, "
                 f"grad rel L2 {rel[worst]} at {worst})")
        if step_counts != want:
            fail(f"{label} train step launches {step_counts}, expected {want}")
        return rel

    def train_and_check(label: str, model, steps: int, batch: int, seq: int, expect: dict, trace_groups: dict):
        """``model`` through launch/train.py's train for ``steps`` AdamW steps: launches exactly ``expect`` (the
        rest 0), no table planned, finite losses, the mean of the last two below step 0's, peak memory under
        LOOP_PEAK_GB; then one more step traced.  Returns the result, the peak GB and the launches."""
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = train(model, steps=steps, batch=batch, seq=seq, peak_lr=PEAK_LR, warmup=WARMUP)
        got = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        for i, (ls, gn, ms, tps) in enumerate(zip(res.losses, res.grad_norms, res.step_ms, res.tokens_per_s())):
            print(f"{label} train step {i}: loss {ls:.4f} | grad norm {gn:.4f} | {ms:.1f} ms | {tps:.0f} tok/s")
        want = dict.fromkeys(COUNTED, 0) | expect
        print(f"{label} train: peak memory allocated {peak:.2f} GB (limit {LOOP_PEAK_GB} GB) | launches {got} "
              f"(expected {want}) ({card})")
        if got != want:
            fail(f"{label} training path launches {got}, expected {want}")
        if res.table is not None or not all(math.isfinite(v) for v in res.losses):
            fail(f"{label} training planned a table or a loss is non-finite: {res.losses}")
        if not (res.losses[-1] + res.losses[-2]) / 2 < res.losses[0]:
            fail(f"{label} training loss did not fall: {res.losses}")
        if not peak < LOOP_PEAK_GB:
            fail(f"{label} training peak memory {peak:.2f} GB, limit {LOOP_PEAK_GB} GB")
        with torch.profiler.profile(activities=activities) as prof:
            traced = train(model, steps=1, batch=batch, seq=seq, peak_lr=PEAK_LR, warmup=WARMUP)
        trace_report(prof, traced.step_ms[0], f"{label} train step trace ({card})",
                     {**trace_groups, "cuBLAS GEMM": cublas, "elementwise and reductions": elementwise})
        return res, peak, got

    rstream = SyntheticStream(DataConfig(vocab_size=rcfg.vocab_size, seq_len=RWKV_TRAIN_SEQ, global_batch=RWKV_TRAIN_BATCH))
    rbatch = {key: torch.from_numpy(val).to(dev) for key, val in rstream.batch(0).items()}
    # rcfg.remat is "block": the backward recomputes each layer's forward, K5 included; K5 twice, K5b once
    one = Model(dataclasses.replace(rcfg, n_layers=1), device=dev, param_dtype=torch.float32, requires_grad=True,
                seed=1)
    train_step_vs_plain("rwkv, 1 layer,", one, rbatch, ((k5, "_forward", k5.wkv6_plain), (k5, "_backward", k5.wkv6_bwd_plain)),
                        {"wkv6": 2, "wkv6_bwd": 1})
    del one, rbatch
    torch.cuda.empty_cache()

    rtcfg = dataclasses.replace(rcfg, n_layers=RWKV_TRAIN_LAYERS)
    t0 = time.perf_counter()
    model = Model(rtcfg, device=dev, param_dtype=torch.float32, requires_grad=True, seed=0)
    torch.cuda.synchronize()
    n_params = sum(prm.numel() for prm in model.parameters())
    print(f"rwkv train model: {rtcfg.name} {RWKV_TRAIN_LAYERS} of {rcfg.n_layers} layers, {n_params / 1e9:.3f} B params "
          f"(f32 masters), remat {rtcfg.remat}, init {time.perf_counter() - t0:.1f} s")
    rtres, rtpeak_gb, rwkv_train_launches = train_and_check(
        "rwkv", model, RWKV_TRAIN_STEPS, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ,
        {"wkv6": 2 * RWKV_TRAIN_LAYERS * RWKV_TRAIN_STEPS, "wkv6_bwd": RWKV_TRAIN_LAYERS * RWKV_TRAIN_STEPS},
        {"K5 wkv6": {"wkv6_kernel"},
         "K5b wkv6_bwd": {"wkv6_bwd_sweep_kernel", "wkv6_bwd_grad_kernel"}})
    rwkv_train_row = {"step_ms": rtres.step_ms, "losses": rtres.losses, "peak_gb": rtpeak_gb}
    del model
    torch.cuda.empty_cache()

    # 12. the twelfth slice: the seven configs above, each through serve_and_hold at full width with seeded
    # weights, then the prefill logits of the kernel path against the plain path within the larger of
    # LOGITS_REL_TOL and twice the noise floor (the plain path against itself with K4's f32 output scaled by
    # 1 + 1e-7 N(0, 1) before its rounding), and K6 timed at one decode step
    t_phase = time.perf_counter()
    ngen12 = torch.Generator(device=dev).manual_seed(12)

    def perturbed_flash(q, k, v, *, causal=True, window=None, prescale=1.0):
        """plain_flash with its f32 output scaled by 1 + 1e-7 N(0, 1) before the bf16 rounding."""
        acc = k4.flash_attention_plain(((q * prescale) * (q.shape[-1] ** -0.5)).float(), k, v, causal=causal,
                                       window=window)  # an f32 q: the same arithmetic, the output left in f32
        return (acc * (1 + 1e-7 * torch.randn(acc.shape, generator=ngen12, device=dev))).to(q.dtype)

    slice12, slice12_launches, s12_k4, s12_k6, s12_k1 = {}, dict.fromkeys(COUNTED, 0), {}, {}, {}
    engine12_launches, long12_launches = dict.fromkeys(COUNTED, 0), dict.fromkeys(COUNTED, 0)

    def engine_slice12(acfg, amodel) -> dict:
        """Phase 12b: a phase-12 model behind ServeEngine (ENGINE_KW: 8 slots, buckets 64/128/256; the device
        controller where the config has MoE), ENGINE12_PHASES phases of 8 requests arriving at once with prompts
        in all three buckets.  Checks: every request completes; one decode graph; the replay equals the eager step
        on copies bit for bit at the first ENGINE12_HELD steps of each phase, K6 and K1 held against their plain
        versions in every layer of those eager steps; the first prefill of each bucket run again with K4, K6 and
        K1 held in every layer gives the served row bit for bit; K4, K6 and K1 launches exact (a replay counts its
        capture's launches), K6 and K1 among the capture's.  Returns the numbers."""
        from repro_torch.serve import Request, ServeEngine

        arch = acfg.name
        kinds_ = [acfg.layer_kind(l) for l in range(acfg.n_layers)]
        n_attn, n_mamba, n_moe = kinds_.count("attn"), kinds_.count("mamba"), acfg.n_moe_layers
        eng = ServeEngine(acfg, amodel, **ENGINE_KW)
        if eng.has_controller != bool(n_moe):
            fail(f"{arch} engine: controller {eng.has_controller} for {n_moe} MoE layers")
        kinds, comparing = {}, [False]
        real_decode, real_prefill = eng._decode_once, eng._prefill_row
        step_ms, prefill_ms, held, hold_left = [], {}, [], [0]
        held_errs = {"prefill": {}, "decode": []}  # each held run's largest max |kernel - plain| by kernel

        def held_decode():
            hold = hold_left[0] > 0
            if hold:
                comparing[0] = True
                ref, errs = kernels_held(f"{arch} engine decode step {len(step_ms) + 1}", eng.step_on_copies,
                                         K1=n_moe, K6=n_mamba)
                comparing[0] = False
                held_errs["decode"].append(errs)
                hold_left[0] -= 1
            t0 = time.perf_counter()
            nxt = real_decode()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if hold:
                live = torch.from_numpy(np.flatnonzero(eng.batcher.live)).to(dev)
                same = np.array_equal(eng.last_outputs, ref["outputs"]) and all(
                    torch.equal(mine[key][live], theirs[key][live])
                    for mine, theirs in zip(eng._caches, ref["caches"]) for key in mine)
                if eng.has_controller:
                    same = same and all(torch.equal(leaf, ref["state"].leaves()[name])
                                        for name, leaf in eng._state.leaves().items())
                held.append(len(step_ms))
                if not same:
                    fail(f"{arch} engine decode step {len(step_ms)}: the graph replay differs from the eager step "
                         f"function on copies of its inputs")
            return nxt

        def timed_prefill(req, bucket):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_prefill(req, bucket)
            torch.cuda.synchronize()
            if out[1] > 0:
                prefill_ms.setdefault(bucket, []).append((time.perf_counter() - t0) * 1e3)
            if out[1] > 0 and bucket not in held_errs["prefill"]:
                # the same prefill again with the kernels held: it must also give the served row
                again, held_errs["prefill"][bucket] = kernels_held(
                    f"{arch} engine prefill bucket {bucket}", lambda: real_prefill(req, bucket), K1=n_moe, K4=n_attn,
                    K6=n_mamba)
                if not all(torch.equal(a_[key], b_[key]) for a_, b_ in zip(out[0], again[0]) for key in a_):
                    fail(f"{arch} engine prefill bucket {bucket}: the row differs from the same prefill with the "
                         f"kernels held")
            return out

        # a recurrent model prefills at the exact prompt length: one padded prompt's admitted slot must hold the
        # recurrent leaves of an exact-length prefill of the same prompt on a fresh cache, bit for bit
        recurrent = [l for l, k_ in enumerate(kinds_) if k_ in ("mamba", "rwkv6")]
        real_admit, padded_row, last_prefill = eng._admit, {}, [None]

        def checked_admit(row, slot, plen):
            real_admit(row, slot, plen)
            req = last_prefill[0]
            if not recurrent or padded_row or plen == eng.queue.bucket_of(plen):
                return
            exact = amodel.init_cache(1, eng.max_len, eng.cache_dtype)
            before = read_counts()  # the reference prefill's launches are not the engine's
            with torch.inference_mode():
                amodel.prefill(torch.from_numpy(req.prompt[None, :-1]).to(dev), exact, schedule=eng._prefill_table)
            for name, fn in COUNTED.items():
                fn.launches = before[name]
            same = all(torch.equal(eng._caches[l][key][slot], exact[l][key][0]) for l in recurrent for key in exact[l])
            padded_row.update(plen=plen, bucket=eng.queue.bucket_of(plen), same=same,
                              leaves=sorted({key for l in recurrent for key in exact[l]}))
            if not same:
                fail(f"{arch} engine: a padded prompt's admitted row (prefill {plen} of bucket "
                     f"{padded_row['bucket']}) differs from an exact-length prefill's recurrent leaves")

        def noted_prefill(req, bucket):
            last_prefill[0] = req
            return timed_prefill(req, bucket)

        eng._decode_once, eng._prefill_row, eng._admit = held_decode, noted_prefill, checked_admit
        erng = np.random.default_rng(ENGINE_SEED + 12)
        t_eng = time.perf_counter()
        reset_counts()
        with counting_engine_steps(kinds, comparing):
            for ph in range(ENGINE12_PHASES):
                reqs = [Request(prompt=erng.integers(0, acfg.vocab_size, n), max_new_tokens=int(erng.integers(8, 17)))
                        for n in ENGINE_TRACE_PROMPTS]
                hold_left[0] = ENGINE12_HELD
                before = eng.metrics()["serve"]
                out = eng.run(reqs)
                s_, c_ = out["serve"], out["compile"]
                done = sum(r.done for r in reqs)
                rejected = s_["requests"]["rejected"] - before["requests"]["rejected"]
                print(f"{arch} engine phase {ph}: completed {done}/{len(reqs)}, rejected {rejected} | decode steps "
                      f"{s_['decode_steps'] - before['decode_steps']} | compile {c_}"
                      + (f" | controller {out['controller']}" if eng.has_controller else "") + f" ({card})")
                if done != len(reqs) or rejected or c_["decode_executables"] != 1:
                    fail(f"{arch} engine phase {ph}: {done} of {len(reqs)} completed, {rejected} rejected, "
                         f"{c_['decode_executables']} decode graphs")
        counted = read_counts()
        wall = time.perf_counter() - t_eng
        del eng._decode_once, eng._prefill_row, eng._admit
        # the distinct prefill shapes: the buckets, or a recurrent model's exact prompt lengths
        shapes_ = {n - 1 for n in ENGINE_TRACE_PROMPTS} if recurrent else set(ENGINE_KW["buckets"])
        if eng.metrics()["compile"]["prefill_executables"] != len(shapes_):
            fail(f"{arch} engine: {eng.metrics()['compile']['prefill_executables']} prefill shapes, expected "
                 f"{len(shapes_)}")
        if recurrent and not padded_row:
            fail(f"{arch} engine: no padded prompt's admitted row was held against an exact-length prefill")
        if recurrent:
            print(f"{arch} engine: a padded prompt's admitted row (prefill {padded_row['plen']} in bucket "
                  f"{padded_row['bucket']}) equals an exact-length prefill's {padded_row['leaves']} in every recurrent "
                  f"layer bit for bit: {padded_row['same']} ({card})")
        main_, captured, warmup = engine_launches_of(kinds, counted, eng.graph_replays)
        n_prefill, n_decode = sum(len(v) for v in prefill_ms.values()), len(step_ms)
        expect = dict.fromkeys(COUNTED, 0)
        expect.update(flash_attention_fwd=n_attn * n_prefill,
                      selective_scan=n_mamba * (n_prefill + n_decode + warmup["calls"]),
                      moe_gemm_grouped=n_moe * (n_prefill + n_decode + warmup["calls"]))
        print(f"{arch} engine launches: {main_} (expected {expect}: K4 attention layers x prefills {n_prefill}, K6 "
              f"and K1 Mamba / MoE layers x (prefills + decode steps {n_decode} + the capture's warm-up step "
              f"{warmup['calls']}); {eng.graph_replays} replays of one graph recording K6 {captured['selective_scan']}"
              f" and K1 {captured['moe_gemm_grouped']} times); graph vs eager held bit for bit at steps {held}")
        if captured["calls"] != 1 or main_ != expect or eng.graph_replays != n_decode or \
                (captured["selective_scan"], captured["moe_gemm_grouped"]) != (n_mamba, n_moe) or \
                len(held) != ENGINE12_PHASES * ENGINE12_HELD or sorted(held_errs["prefill"]) != sorted(ENGINE_KW["buckets"]):
            fail(f"{arch} engine launches {main_}, expected {expect}; captures {captured}; held at {held}, prefill "
                 f"buckets held {sorted(held_errs['prefill'])}")
        decode_errs = {name: max(e[name] for e in held_errs["decode"]) for name in held_errs["decode"][0]}
        print(f"{arch} engine kernels held against their plain versions in every layer (K4 and K1 tol {BF16_TOL} + "
              f"{BF16_TOL}*|plain|, K4 also {K4_REL_L2} rel L2 a (b, head); K6 {WKV_TOL} + {WKV_TOL}*|plain|, f32): "
              f"batch-1 prefill, bucket: max_abs_err "
              f"{ {b_: {k_: float(f'{v:.4g}') for k_, v in e.items()} for b_, e in sorted(held_errs['prefill'].items())} }; "
              f"decode at the {len(held_errs['decode'])} held steps (the replays equal them): "
              f"{ {k_: float(f'{v:.4g}') for k_, v in decode_errs.items()} } ({card})")
        row = {"decode_ms_per_step_median": float(np.median(step_ms)), "decode_steps": n_decode,
               "prefill_ms_median": {b_: float(np.median(v)) for b_, v in sorted(prefill_ms.items())},
               "graph_replays": eng.graph_replays, "held_steps": len(held), "wall_s": wall,
               "held_max_abs_err": {"prefill": held_errs["prefill"], "decode": decode_errs},
               "padded_row_exact": padded_row or None}
        print(f"{arch} engine: decode ms/step (graph, host clock) median {row['decode_ms_per_step_median']:.2f} | "
              f"prefill ms median by bucket {row['prefill_ms_median']} | {wall:.1f} s wall ({card})")
        for key in COUNTED:
            engine12_launches[key] += main_[key]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return row

    def slice12_config(arch, keep, bsz, plen, new) -> None:
        """Serve one config, check it, time its kernels; everything it holds is freed on return."""
        acfg = get_config(arch)
        if keep is not None:
            acfg = dataclasses.replace(acfg, n_layers=keep)
        if acfg.moe is not None:
            acfg = dataclasses.replace(acfg, moe=dataclasses.replace(acfg.moe, dispatch="phase_pipelined",
                                                                     use_pallas=True))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        amodel, ares, got, kernel_logits, prompts12, ext12, rows = serve_and_hold(acfg, bsz, plen, new, 1,
                                                                                  prompt_seed=13)
        serve_s = time.perf_counter() - t0
        for key in COUNTED:
            slice12_launches[key] += got[key]
        prefix = 0 if ext12 is None else ext12.shape[1]

        def logits12():
            caches = amodel.init_cache(bsz, prefix + plen)
            return amodel.prefill(prompts12, caches, ext12, schedule=ares.table)[0].float()

        with mock.patch.object(k1, "moe_gemm", k1.moe_gemm_plain), \
                mock.patch.object(k6, "selective_scan", k6.selective_scan_plain):
            with mock.patch.object(k4, "flash_attention", plain_flash):
                plain_logits = logits12()
            with mock.patch.object(k4, "flash_attention", perturbed_flash):
                noise_logits = logits12()
        rel, floor = row_rel(kernel_logits, plain_logits), row_rel(noise_logits, plain_logits)
        logits_tol = max(LOGITS_REL_TOL, MIXTRAL_BF16_NOISE_MULT * floor)
        same_top1 = int((kernel_logits.argmax(-1) == plain_logits.argmax(-1)).sum())
        print(f"{arch}: prefill logits kernel vs plain path: max row rel L2 {rel:.3g} (tol {logits_tol:.3g}), same "
              f"argmax {same_top1}/{bsz}; noise floor {floor:.3g}")
        if not torch.isfinite(plain_logits).all() or rel > logits_tol:
            fail(f"{arch}: prefill logits of the kernel path differ from the plain path: rel L2 {rel:.3g}, "
                 f"tol {logits_tol:.3g}")

        s12_k4[arch] = rows["flash_attention_fwd"]
        if "selective_scan" in rows:
            dec = {}

            def record_k6(*args, **kw):  # the step's scan inputs, then the kernel (not counted: a timing setup)
                dec.setdefault("args", tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args))
                return k6._launch(*args, **kw)

            caches12 = amodel.init_cache(bsz, prefix + plen + 1)
            amodel.prefill(prompts12, caches12, ext12, schedule=ares.table)
            with mock.patch.object(k6, "selective_scan", record_k6):
                amodel.decode_step(ares.tokens[0, :, 0].to(dev), caches12, prefix + plen, schedule=ares.table)
            xd, dtd, bd, cd, ad, dd, hd = dec["args"][:7]
            del caches12
            hbuf = hd.clone()
            got_dec, want_dec = k6._launch(xd, dtd, bd, cd, ad, dd, hd, hbuf), k6.selective_scan_plain(
                xd, dtd, bd, cd, ad, dd, hd)
            err_dec = max(close_f32(got_dec[0], want_dec[0], "K6 y at decode"),
                          close_f32(got_dec[1], want_dec[1], "K6 h at decode"))
            s12_k6[arch] = {**rows["selective_scan"],
                            "decode": {**k6_row_at(xd, dtd, bd, cd, ad, dd, hd, hbuf), "max_abs_err": err_dec}}
            print_rows(arch, {"selective_scan at one decode step": s12_k6[arch]["decode"]})
        if "moe_gemm_grouped" in rows:
            s12_k1[arch] = rows["moe_gemm_grouped"]
        extra12 = {}
        if arch in SLICE12_ENGINE:  # 12b and 10c on the same model, before it is freed
            extra12["engine"] = engine_slice12(acfg, amodel)
            extra12["long_500k"], got_long = long_cell(acfg, amodel, ares.table, ngen12)
            for key in COUNTED:
                long12_launches[key] += got_long[key]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        slice12[arch] = {"layers": acfg.n_layers, "batch": bsz, "prompt": plen, "prefix": prefix, "new_tokens": new,
                         "prefill_ms": ares.prefill_ms[0], "decode_ms_per_step": ares.decode_ms[0] / new,
                         "peak_gb": peak_gb, "logits_rel_l2": rel, "noise_floor": floor,
                         "serve_and_hold_s": serve_s, **extra12}
        print(f"{arch}: peak memory allocated {peak_gb:.2f} GB, serve and hold {serve_s:.1f} s ({card})")

    for arch, keep, bsz, plen, new in SLICE12:
        slice12_config(arch, keep, bsz, plen, new)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s wall ({card})")

    # 13. training the hybrid and a dense config (TRAIN13): for Jamba's layer 0 first a train step, kernel path
    # (K6, K6b) against the plain path, with the first scan backward's inputs recorded; K6b held against its
    # plain version on them and timed as a CUDA graph replay; then each model through launch/train.py's train
    t_phase = time.perf_counter()
    train13, train13_launches, k6b_row, k6_train_row = {}, dict.fromkeys(COUNTED, 0), None, None

    def plain_scan_forward(*args, checkpoints=False, **kw):
        out = k6.selective_scan_plain(*args, **kw)
        return (*out, None) if checkpoints else out

    for arch, keep in TRAIN13:
        acfg = get_config(arch)
        if keep is not None:
            acfg = dataclasses.replace(acfg, n_layers=keep)
        kinds_ = [acfg.layer_kind(l) for l in range(acfg.n_layers)]
        n_mamba = kinds_.count("mamba")
        t0 = time.perf_counter()
        model = Model(acfg, device=dev, param_dtype=torch.float32, requires_grad=True, seed=0)
        torch.cuda.synchronize()
        n_params = sum(prm.numel() for prm in model.parameters())
        print(f"train13 model: {arch} {acfg.n_layers} layers ({', '.join(sorted(set(kinds_)))}; ffn "
              f"{sorted({acfg.ffn_kind(l) for l in range(acfg.n_layers)})}), {n_params / 1e9:.3f} B params (f32 "
              f"masters), remat {acfg.remat}, init {time.perf_counter() - t0:.1f} s")
        if n_mamba:
            stream13 = SyntheticStream(DataConfig(vocab_size=acfg.vocab_size, seq_len=TRAIN13_SEQ,
                                                  global_batch=TRAIN13_BATCH, seed=1))
            batch13 = {key: torch.from_numpy(val).to(dev) for key, val in stream13.batch(0).items()}
            recorded = {}
            real_backward = k6._backward

            def recording_backward(*args, **kw):
                recorded.setdefault("args", (tuple(t.detach().clone() if isinstance(t, torch.Tensor) else t
                                                   for t in args), {k_: v.detach().clone() for k_, v in kw.items()
                                                                    if isinstance(v, torch.Tensor)}))
                return real_backward(*args, **kw)

            with mock.patch.object(k6, "_backward", recording_backward):  # records the kernel path's call
                rel = train_step_vs_plain(f"{arch}, {acfg.n_layers} layer,", model, batch13, (
                    (k6, "_forward", plain_scan_forward), (k6, "_backward", k6.selective_scan_bwd_plain)),
                    {"selective_scan": 2 * n_mamba, "mamba_scan_bwd": n_mamba})  # K6 twice (remat), K6b once
            print(f"{arch} train step gradients, kernel vs plain path: rel L2 a_log {rel['layers.0.mixer.a_log']:.3g}, "
                  f"d_skip {rel['layers.0.mixer.d_skip']:.3g}")
            del batch13

            # K6b on the recorded inputs of the layer's scan backward: the training shape and its data
            (x6, dt6, b6, c6, a6, d6, dy6, h06, dhf6), kw6 = recorded["args"][0][:9], recorded["args"][1]
            hck6 = kw6["checkpoints"]
            got = k6._launch_bwd(x6, dt6, b6, c6, a6, d6, dy6, h06, dhf6, hck6)  # comparison launches: not counted
            again = k6._launch_bwd(x6, dt6, b6, c6, a6, d6, dy6, h06, dhf6, hck6)
            want = k6.selective_scan_bwd_plain(x6, dt6, b6, c6, a6, d6, dy6, h06, dhf6)
            torch.cuda.synchronize()
            parts, worst_err, rels = [], 0.0, {}
            for name, g, w, g2 in zip(("dx", "ddt", "db", "dc", "da", "dd_skip", "dh0"), got, want, again):
                if w is None:
                    continue
                if not torch.isfinite(g).all():
                    fail(f"K6b {name}: non-finite")
                if not torch.equal(g, g2):
                    fail(f"K6b {name}: two runs on the same inputs differ")
                r_, err, top = rel_l2(g, w), float((g - w).abs().max()), float(w.abs().max())
                if r_ > SCAN_BWD_TOL or err > SCAN_BWD_TOL * top:
                    fail(f"K6b {name}: rel L2 {r_:.3g}, max |diff| {err:.4g} against max |plain| {top:.4g} (tol "
                         f"{SCAN_BWD_TOL} each)")
                worst_err, rels[name] = max(worst_err, err), r_
                parts.append(f"{name} {r_:.3g} / {err / top:.3g}")
            print(f"K6b at the training shape on the layer's own inputs: rel L2 / max |diff| over max |plain| (tol "
                  f"{SCAN_BWD_TOL} each): {', '.join(parts)}; two runs equal bit for bit")
            bsz_, s_, di_ = x6.shape
            ds_ = a6.shape[1]
            n_el = bsz_ * s_ * di_
            # the bound, from the function's least traffic: x (its dtype), dt, dy, B and C read once; dx, ddt, dB and
            # dC written once; a, d_skip (and h0, dh_final where given) read, da, dd_skip (and dh0) written; no
            # checkpoints (how many a design keeps is its own choice, so they are reported apart, as its traffic);
            # operations: one exponential a (b, t, i, s), the least the adjoint's propagation takes
            state_n = bsz_ * di_ * ds_
            nbytes = n_el * x6.element_size() + 4 * (4 * n_el + 4 * bsz_ * s_ * ds_ + 2 * a6.numel() + 2 * di_
                                                     + (2 * state_n if h06 is not None else 0)
                                                     + (state_n if dhf6 is not None else 0))
            t_bytes, t_exp = nbytes / HBM_BYTES_PER_S, n_el * ds_ / EXP_PER_S
            t_flops = 12.0 * n_el * ds_ / PEAK_F32_FLOPS
            ck = k6.ckpt_steps()
            # this design's own traffic: the function's, its checkpoints read, its dB/dC partials written and read
            n_blocks = -(-di_ // k6._bwd_lib().mamba_scan_bwd_block_channels())
            design_bytes = nbytes + 4 * hck6.numel() + 2 * 4 * n_blocks * bsz_ * s_ * 2 * k6.MAX_STATE
            # K6 at the training shape on the same scan inputs, with checkpoints (as autograd launches it) and
            # without: y and h held against the plain version within WKV_TOL (comparison launches, not counted)
            y_k, h_k, _ = k6._launch(x6, dt6, b6, c6, a6, d6, h06, checkpoints=True)
            y_p, h_p = k6.selective_scan_plain(x6, dt6, b6, c6, a6, d6, h06)
            k6_train_row = {
                "shape": f"x[{bsz_},{s_},{di_}] {str(x6.dtype).removeprefix('torch.')} ds {ds_}, dt f32, from zeros "
                         f"(Jamba layer 0 in training)",
                "max_abs_err": max(close_f32(y_k, y_p, "K6 y at the training shape"),
                                   close_f32(h_k, h_p, "K6 h at the training shape")),
                "ms": graph_ms(lambda: k6._launch(x6, dt6, b6, c6, a6, d6, h06), 5),
                "checkpointed_ms": graph_ms(lambda: k6._launch(x6, dt6, b6, c6, a6, d6, h06, checkpoints=True), 5),
                "plain_ms": cuda_ms(lambda: k6.selective_scan_plain(x6, dt6, b6, c6, a6, d6, h06), 1, warmup=1),
                "library_ms": None, **k6_cost(x6, dt6, b6, c6, a6, d6, h06),
            }
            del y_k, h_k, y_p, h_p
            print(f"K6 at the training shape: {k6_train_row['shape']} | kernel {k6_train_row['ms']:.4f} ms, with "
                  f"checkpoints every {ck} steps {k6_train_row['checkpointed_ms']:.4f} ms (CUDA graph replays) | plain "
                  f"{k6_train_row['plain_ms']:.1f} ms | library: none | bound {k6_train_row['bound_ms']:.4f} ms "
                  f"({k6_train_row['bound_set_by']}), {100 * k6_train_row['bound_ms'] / k6_train_row['ms']:.1f}% of "
                  f"bound | max_abs_err {k6_train_row['max_abs_err']:.3g} (tol {WKV_TOL} + {WKV_TOL}*|plain|) ({card})")
            k6b_row = {
                "shape": f"x[{bsz_},{s_},{di_}] {str(x6.dtype).removeprefix('torch.')} ds {ds_}, dt/dy f32, "
                         f"checkpoints every {ck} steps, from zeros (Jamba layer 0 in training)",
                "max_abs_err": worst_err, "rel_l2": rels,
                "ms": graph_ms(lambda: k6._launch_bwd(x6, dt6, b6, c6, a6, d6, dy6, h06, dhf6, hck6), 5),
                "plain_ms": cuda_ms(lambda: k6.selective_scan_bwd_plain(x6, dt6, b6, c6, a6, d6, dy6), 1, warmup=1),
                "library_ms": None, "bound_ms": max(t_bytes, t_exp) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_exp else "operations",
                "bound_parts_ms": {"bytes": t_bytes * 1e3, "exponentials": t_exp * 1e3, "f32 FLOPs": t_flops * 1e3},
                "bound_bytes": nbytes, "design_bytes": design_bytes, "design_bytes_ms": design_bytes / HBM_BYTES_PER_S * 1e3,
                "forward_checkpointed_ms": k6_train_row["checkpointed_ms"], "forward_ms": k6_train_row["ms"],
            }
            old_src = os.environ.get("K6B_OLD_SOURCE")
            if old_src:
                # an earlier design of K6b (a directory holding its mamba_scan_bwd.cu, same C interface), built
                # beside this one and timed on the same inputs in turns: old, new, new, old
                old_lib = k6.bind_bwd(build.load("mamba_scan_bwd", csrc=str(Path(old_src).resolve())))
                old_got = k6._launch_bwd(x6, dt6, b6, c6, a6, d6, dy6, h06, dhf6, hck6, lib=old_lib)
                for name, g, w in zip(("dx", "ddt", "db", "dc", "da", "dd_skip", "dh0"), old_got, want):
                    if w is not None and rel_l2(g, w) > SCAN_BWD_TOL:
                        fail(f"K6b's earlier design {name}: rel L2 {rel_l2(g, w):.3g} against the plain version")
                turns = {"old": [], "new": []}
                for which in ("old", "new", "new", "old"):
                    lib_ = old_lib if which == "old" else None
                    turns[which].append(graph_ms(
                        lambda: k6._launch_bwd(x6, dt6, b6, c6, a6, d6, dy6, h06, dhf6, hck6, lib=lib_), 5))
                old_ms, new_ms = (sum(v) / len(v) for v in (turns["old"], turns["new"]))
                k6b_row["earlier_design"] = {"source": old_src, "turns_ms": turns, "old_ms": old_ms, "new_ms": new_ms}
                print(f"K6b against its earlier design ({old_src}) in turns old, new, new, old: {turns['old'][0]:.4f}, "
                      f"{turns['new'][0]:.4f}, {turns['new'][1]:.4f}, {turns['old'][1]:.4f} ms ({card})")
                if new_ms >= old_ms:
                    fail(f"K6b {new_ms:.4f} ms is not faster than its earlier design's {old_ms:.4f} ms")
            print(f"K6b backward: {k6b_row['shape']} | kernel {k6b_row['ms']:.4f} ms (CUDA graph replay) | plain "
                  f"{k6b_row['plain_ms']:.1f} ms | library: none (no PyTorch call computes it) | bound "
                  f"{k6b_row['bound_ms']:.4f} ms ({k6b_row['bound_by']}, {nbytes / 1e9:.3f} GB with no checkpoints; "
                  f"parts {k6b_row['bound_parts_ms']}), {100 * k6b_row['bound_ms'] / k6b_row['ms']:.1f}% of bound | this "
                  f"design's traffic (checkpoints every {ck} steps, dB/dC partials) {k6b_row['design_bytes'] / 1e9:.3f} GB, "
                  f"{k6b_row['design_bytes_ms']:.4f} ms | K6 forward on the same inputs {k6b_row['forward_ms']:.4f} ms, "
                  f"with checkpoints {k6b_row['forward_checkpointed_ms']:.4f} ms ({card})")
            del recorded, got, again, want, x6, dt6, b6, c6, a6, d6, dy6, hck6
            torch.cuda.empty_cache()

        tres13, peak13, got = train_and_check(
            arch, model, TRAIN13_STEPS, TRAIN13_BATCH, TRAIN13_SEQ,
            {"selective_scan": 2 * n_mamba * TRAIN13_STEPS, "mamba_scan_bwd": n_mamba * TRAIN13_STEPS},
            {"K6 selective_scan": {"mamba_scan_kernel"}, "K6b mamba_scan_bwd": {"mamba_scan_bwd_kernel"},
             "K6b partial sums": {"sum_parts_kernel"}})  # K6 2 x Mamba layers x steps under remat, K6b once each
        for key in COUNTED:
            train13_launches[key] += got[key]
        train13[arch] = {"layers": acfg.n_layers, "params_b": n_params / 1e9, "step_ms": tres13.step_ms,
                         "tok_s": tres13.tokens_per_s(), "losses": tres13.losses, "peak_gb": peak13}
        del model, tres13
        gc.collect()
        torch.cuda.empty_cache()
    if k6b_row is None:
        fail("phase 13: no Mamba layer trained, so K6b was never held")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s wall ({card})")

    # 14. expert parallelism across EP_RANKS ranks sharing the card (gloo with CUDA tensors); the kernels were
    # built above, so the ranks only load them
    ep_layer_launches, ep_serve_launches, ep_rows, ep_held, ep_serve = ep_phase(dev, card, COUNTED)

    # 15. training across TW_RANKS ranks sharing the card: clean, a fault on one rank, an elastic restart
    tw_launches, tw_2d_launches, tw_numbers = train_world_phase(card, COUNTED)

    # the kernels line, then the result line
    path_launches = {
        name: {"serve": launches[name], "serve_drift": drift_launches[name], "serve_engine": engine_launches[name],
               **{f"serve_{arch}": arch_launches[arch][name] for arch in ARCHS}, "wire_codecs": wire_launches[name],
               "knee": knee_launches[name], "train": train_launches[name], "train_loop": loop_launches[name],
               "rwkv_serve": rwkv_launches[name], "rwkv_long_500k": long_launches[name],
               "rwkv_train": rwkv_train_launches[name], "slice12": slice12_launches[name],
               "slice12_engine": engine12_launches[name], "slice12_long_500k": long12_launches[name],
               "train13": train13_launches[name], "ep_layer": ep_layer_launches[name],
               "ep_serve": ep_serve_launches[name], "hier_engine": hier_engine["launches"][name],
               "train_world": tw_launches[name], "train_world_2d": tw_2d_launches[name]}
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
            ep={"label": EP_LABEL, "layer": ep_rows, "k1_held_max_err": ep_held["k1"], "k2_held_max_err": ep_held["k2"],
                "k3_held_rel_l2": ep_held["k3"], "serve": ep_serve},
            train_world=tw_numbers,
            **{arch: arch_rows[arch]["moe_gemm_grouped"] for arch in ARCHS}, **s12_k1,
        ),
        dict(
            name="flash_attention_fwd", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:77",
            launches=sum(path_launches["flash_attention_fwd"].values()),
            launches_by_path=path_launches["flash_attention_fwd"],
            **{key: k4_row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            shape=k4_row["shape"],
            **{key: k4_row[key] for key in K4_EXTRA_KEYS + ("model_call_max_abs_err",)},
            **{arch: arch_rows[arch]["flash_attention_fwd"] for arch in ARCHS}, **s12_k4,
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
            **k5_rows["prefill"], decode=k5_rows["decode"], long_500k=long_row,
        ),
        dict(
            name="wkv6_bwd", route="cuda", source="src/repro_torch/csrc/rwkv_wkv_bwd.cu",
            # port-side: the JAX model runs the scan _wkv_scan and XLA differentiates it (no Pallas backward)
            replaces="src/repro/models/rwkv.py:99", launches=sum(path_launches["wkv6_bwd"].values()),
            launches_by_path=path_launches["wkv6_bwd"], **k5b_row, rwkv_train=rwkv_train_row,
        ),
        dict(
            name="selective_scan", route="cuda", source="src/repro_torch/csrc/mamba_scan.cu",
            # port-side: the JAX model runs the recurrence as a lax.scan (_scan_ssm; no Pallas kernel)
            replaces="src/repro/models/mamba.py:66", launches=sum(path_launches["selective_scan"].values()),
            launches_by_path=path_launches["selective_scan"], **s12_k6["jamba-1.5-large-398b"], train=k6_train_row,
        ),
        dict(
            name="mamba_scan_bwd", route="cuda", source="src/repro_torch/csrc/mamba_scan_bwd.cu",
            # port-side: the JAX model differentiates its lax.scan (_scan_ssm; no Pallas backward)
            replaces="src/repro/models/mamba.py:66", launches=sum(path_launches["mamba_scan_bwd"].values()),
            launches_by_path=path_launches["mamba_scan_bwd"], **k6b_row, train13=train13,
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
    for arch, row in slice12.items():
        print(f"phase 12 {arch}: {json.dumps(row)} ({card})")
    for arch, row in train13.items():
        print(f"phase 13 {arch}: {json.dumps(row)} ({card})")
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s wall, the build included ({card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()

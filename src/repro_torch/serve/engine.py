"""Continuous-batching decode service with schedule-regime warm swaps.

Counterpart of ``repro/serve/engine.py``.  An admission queue feeds a
slot-based decode batch, and the scheduler loop closes over *realized*
routing statistics: the decode step runs under the device controller's
table (``DeviceController.table_of``) and steps that controller on the
routing it just produced, as the reference's one decode executable does.
The host runtime only plans the prefill table, from realized decode
routing averaged every ``host_observe_every`` steps.

Step functions:

* **prefill**: eager, one call per request at batch 1, under the host
  runtime's table.  An attention-only model prefills the prompt padded to
  its bucket, as the reference does.  A model with a recurrent layer
  (``block == "rwkv6"``, or a hybrid's Mamba layers) prefills it at its
  exact ``prefill_len``: the bucket stays the queue's length class only.
  The reference pads those too (``repro/serve/engine.py``), so an RWKV
  state, a Mamba layer's ``h`` and its conv tail absorb the padding
  tokens, which no ``pos`` mask can take out again, and a padded prompt
  decodes other tokens than the same prompt alone.  The port departs from
  the reference there, as it does for the sliding window's ring slots: a
  padded prompt's row equals an unpadded prefill's, and its tokens the
  unbatched path's.  The prefill is eager at batch 1, so an exact length
  compiles nothing.  The port writes caches in place, so each request
  prefills into a fresh row cache (the reference reuses an immutable
  template).  ``prefill_executables`` counts the distinct prefill shapes
  run: the buckets of an attention-only model, the exact lengths of a
  recurrent one.
* **admit**: eager.  Positions ``>= prefill_len`` in the row's ``pos``
  leaves become -1 (padding KV never seen), then every leaf is copied
  into batch slot ``slot`` of the decode caches in place.  Float leaves
  (an RWKV state, a Mamba state) are copied as they are: they saw the
  prompt's tokens only.
* **decode**: on the card ONE CUDA graph, captured at the first decode
  step and replayed at every step after it.  Its static inputs are one
  [3, B] int32 buffer (tokens, per-slot positions, liveness), refilled
  by one host-to-device copy a step; the caches and the controller state
  are the engine's own tensors.  The body: ``decode_step`` under the
  controller's table with liveness-weighted stats, ``argmax``, then the
  device half of the controller's transition (``step_device``).  Its
  outputs (next tokens, routing, dropped, ``fire``/``warm``/``best``) come
  back in one device-to-host copy; when ``fire`` is set the host re-plans eagerly,
  in place, before the next replay.  Under ``dispatch="hierarchical"`` the
  controller is the two-level ``HierarchicalDeviceController``: both
  levels step inside the graph, and ``fire`` is either level's.  The controller's envelope is static,
  so nothing forces a second capture.  On the CPU the same body runs
  eagerly.  A failed capture or replay raises.

Admission is KV-aware: a request whose peak position exceeds the decode
cache is rejected at enqueue (counted), one that fits but finds no free
slot waits in the length-bucketed queue.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import (
    DeviceController,
    HierarchicalDeviceController,
    HierarchicalRuntime,
    ScheduleTable,
    make_serving_controller,
)
from repro_torch.core.lap import greedy_phases
from repro_torch.models import Model
from repro_torch.parallel.fabric import consumes_table
from repro_torch.parallel.sharding import current_world
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import Request, RequestQueue

__all__ = ["ServeEngine"]


class ServeEngine:
    """One model's serving loop (see module docstring).

    ``controller="auto"`` closes the scheduler loop when the config has a
    table-consuming MoE fabric whose expert count divides ``n_ranks``;
    ``"off"`` serves without one.  The regime/penalty knobs reach the
    device controller; ``plan_overrides`` (quantum/min_cap/slack) reach
    both planners.  ``model`` is a ``Model`` (weights from ``transplant``,
    say); None builds ``Model(cfg, device=device, seed=seed)``.  ``device``
    defaults to CUDA (``resolve_device``: raises without a card)."""

    def __init__(
        self,
        cfg,
        model: Model | None = None,
        *,
        decode_slots: int = 4,
        max_len: int = 64,
        buckets=(8, 16, 32),
        n_ranks: int = 8,
        controller: str = "auto",
        regime_slots: int = 0,
        regime_threshold: float = 0.25,
        replan_penalty: float = 0.0,
        drop_tolerance: float = 0.05,
        hysteresis_steps: int = 1,
        cooldown: int = 2,
        ema: float = 0.5,
        host_observe_every: int = 16,
        plan_overrides: dict | None = None,
        cache_dtype=torch.bfloat16,
        seed: int = 0,
        device=None,
    ):
        world = current_world()
        if world is not None and world.size > 1:
            raise NotImplementedError(
                "the serving engine runs on one rank: its decode step is one CUDA graph, and collectives cannot be "
                "captured in it; serve across ranks through repro_torch.launch.serve"
            )
        if controller not in ("auto", "off"):
            raise ValueError(f"controller must be 'auto' or 'off', got {controller!r}")
        if max(buckets) > max_len:
            raise ValueError(f"largest bucket {max(buckets)} exceeds max_len {max_len}")
        if cfg.vocab_size > 2**24:
            raise ValueError("token ids ride the decode output as f32: the vocabulary must stay below 2**24")
        if model is None:
            model = Model(cfg, device=device, seed=seed)
        elif device is not None and torch.device(device) != model.device:
            raise ValueError(f"model lives on {model.device}, engine asked for {device}")
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.max_len = int(max_len)
        self.cache_dtype = cache_dtype
        self.host_observe_every = int(host_observe_every)
        self.queue = RequestQueue(buckets)
        self.batcher = ContinuousBatcher(decode_slots, max_len)
        self._metrics = ServeMetrics()
        self._metrics.n_slots = decode_slots
        self._host_swaps = 0
        self._routing_acc: list[np.ndarray] = []
        self._bank_tables: list = []
        self._bank_refs: list[np.ndarray] = []
        # ------------------------------------------------------ controller
        self._runtime = self._ctrl = self._state = self._table = self._prefill_table = None
        if controller == "auto" and cfg.moe is not None and consumes_table(cfg.moe.dispatch):
            self._build_controller(
                n_ranks=n_ranks, regime_slots=regime_slots, regime_threshold=regime_threshold,
                replan_penalty=replan_penalty, drop_tolerance=drop_tolerance, hysteresis_steps=hysteresis_steps,
                cooldown=cooldown, ema=ema, plan_overrides=plan_overrides or {},
            )
        # -------------------------------------------------- decode buffers
        self._caches = model.init_cache(decode_slots, max_len, cache_dtype)
        self._inputs = torch.zeros((3, decode_slots), dtype=torch.int32, device=self.device)
        self._use_graph = self.device.type == "cuda"
        self._graph: torch.cuda.CUDAGraph | None = None
        self._graph_out = None
        # a recurrent layer's state would absorb a padded prefill's padding tokens
        self._recurrent = any(cfg.layer_kind(l) in ("rwkv6", "mamba") for l in range(cfg.n_layers))
        self._prefill_shapes: set[int] = set()
        self._admits = 0
        self.graph_replays = 0
        # the last decode step's outputs as copied to the host (``split_outputs``)
        self.last_outputs: np.ndarray | None = None
        # one entry per re-plan the decode loop ran: decode step, kind, host ms
        self.replan_log: list[dict] = []
        self._decode_steps = 0

    # ----------------------------------------------------------- controller
    def _build_controller(
        self, *, n_ranks, regime_slots, regime_threshold, replan_penalty, drop_tolerance, hysteresis_steps,
        cooldown, ema, plan_overrides,
    ) -> None:
        # plan_overrides reach the HOST planner too: the initial device
        # capmat comes from its first table, and a training-scale plan would
        # grant every pair more than smoke-scale decode traffic can overflow
        runtime, _ = make_serving_controller(
            self.cfg, n_ranks=n_ranks, drift="none", ema=ema, cooldown=cooldown, replan_penalty=replan_penalty,
            plan_kwargs=plan_overrides or None, device=self.device,
        )
        if runtime is None:  # experts don't divide the rank count
            return
        moe = self.cfg.moe
        # prime the host planner with a uniform estimate; realized decode
        # routing replaces it on the first observe cadence
        stats0 = np.full(
            (runtime.n_layers, 1, moe.n_experts), float(self.batcher.n_slots * moe.top_k) / moe.n_experts, np.float32
        )
        runtime.observe(stats0)
        if isinstance(runtime, HierarchicalRuntime):
            # the composed fabric's two-level controller: the regime library and the penalty knobs are
            # flat-controller features, as in the JAX engine
            ctrl, state = HierarchicalDeviceController.from_runtime(runtime)
        else:
            ctrl, state = DeviceController.from_runtime(
                runtime, drop_tolerance=drop_tolerance, hysteresis_steps=hysteresis_steps,
                regime_slots=regime_slots, regime_threshold=regime_threshold, replan_penalty=replan_penalty,
                **plan_overrides,
            )
        self._runtime, self._ctrl, self._state = runtime, ctrl, state
        self._table = ctrl.table_of(state)  # over the state's plan tensors: re-plans show through
        self._prefill_table = runtime.table()

    @property
    def has_controller(self) -> bool:
        return self._ctrl is not None

    @property
    def regime_capacity(self) -> int:
        return 0 if self._ctrl is None else self._ctrl.cfg.regime_slots

    def _require_regime_library(self):
        if self._ctrl is None or self.regime_capacity == 0:
            raise ValueError(
                "no regime library: construct the engine with a table-consuming MoE config and regime_slots > 0"
            )

    def capture_regime(self) -> int:
        """Snapshot the CURRENT plan and EMA'd realized traffic shape into the
        regime library (the plan was cold-solved for exactly this regime, so
        a later warm swap replays it verbatim).  Returns the library index."""
        self._require_regime_library()
        self._bank_tables.append(self._table.clone(device="cpu"))  # a copy: re-plans write the live plan
        self._bank_refs.append(self._state.smoothed.cpu().numpy().astype(np.float32).mean(axis=0))
        self._ctrl.load_regimes(self._state, self._bank_tables, self._bank_refs)
        return len(self._bank_tables) - 1

    def load_regimes(self, references) -> None:
        """Pre-plan tables for known reference regimes (``[n, n]`` traffic in
        per-step token units) and fill the library with them."""
        self._require_regime_library()
        for ref in references:
            self._bank_tables.append(self._plan_table(np.asarray(ref)))
            self._bank_refs.append(np.asarray(ref, np.float32))
        self._ctrl.load_regimes(self._state, self._bank_tables, self._bank_refs)

    def _plan_table(self, ref: np.ndarray) -> ScheduleTable:
        """One regime table planned with the device controller's own solver
        and knobs, so a warm swap installs what the cold branch would have
        planned for the reference traffic."""
        dcfg = self._ctrl.cfg
        n = dcfg.n_ranks
        if ref.shape != (n, n):
            raise ValueError(f"reference shape {ref.shape} != {(n, n)}")
        traffic = np.broadcast_to(ref[None], (self._runtime.n_layers, n, n)).astype(np.float32)
        plan = greedy_phases(
            torch.from_numpy(traffic).to(self.device), k_max=dcfg.k_max, quantum=dcfg.quantum,
            min_cap=dcfg.min_cap, slack=dcfg.slack, mask=torch.ones((n, n), dtype=torch.bool, device=self.device),
            max_rounds=dcfg.max_rounds,
        )
        return ScheduleTable(
            perms=plan["perms"], caps=plan["caps"], valid=plan["valid"], offsets=torch.zeros_like(plan["perms"]),
            n_phases=plan["n_phases"], envelope=dcfg.envelope,
        )

    # -------------------------------------------------------------- serving
    def _prefill_row(self, req: Request, bucket: int):
        """Prefill one request at batch 1 into a fresh row cache: padded to
        its bucket, or at its exact length where a recurrent layer would
        absorb the padding (module doc)."""
        plen = req.prefill_len
        row = self.model.init_cache(1, self.max_len, self.cache_dtype)
        if plen > 0:
            length = plen if self._recurrent else bucket
            tokens = np.zeros((1, length), np.int32)
            tokens[0, :plen] = req.prompt[:-1]
            self.model.prefill(torch.from_numpy(tokens).to(self.device), row, schedule=self._prefill_table)
            self._prefill_shapes.add(length)
        return row, plen

    @torch.inference_mode()
    def _admit(self, row: list[dict], slot: int, plen: int) -> None:
        """Mark the row's padding positions empty and copy it into ``slot``.
        The attention ``pos`` leaves are the only integer leaves."""
        for big, one in zip(self._caches, row):
            for key, leaf in one.items():
                if not leaf.is_floating_point():
                    leaf = torch.where(leaf >= plen, -1, leaf)
                big[key][slot].copy_(leaf[0])
        self._admits += 1

    def _admit_ready(self, step_no: int, wall: float) -> None:
        """Admit queued requests into free slots (KV already checked at
        enqueue: anything in the queue fits a slot's cache)."""
        while True:
            slot = self.batcher.free_slot()
            if slot is None:
                return
            item = self.queue.pop()
            if item is None:
                return
            req, bucket = item
            row, plen = self._prefill_row(req, bucket)
            self._admit(row, slot, plen)
            self.batcher.admit(slot, req)
            req.admit_step = step_no
            req.admit_wall = wall
            self._metrics.record_admitted(req, step_no)

    def _host_inputs(self) -> torch.Tensor:
        """This step's tokens, positions and liveness as one [3, B] int32."""
        b = self.batcher
        return torch.from_numpy(np.stack([b.token, b.step, b.live.astype(np.int32)]))

    @torch.inference_mode()
    def _step(self, inputs: torch.Tensor, caches: list[dict], state, table):
        """The decode step function: what the graph captures and what runs
        eagerly on the CPU.  Returns (outputs as one f32 vector, routable
        traffic or None)."""
        token, steps, live = inputs[0], inputs[1], inputs[2] != 0
        if self._ctrl is None:
            logits, _ = self.model.decode_step(token, caches, steps)
            return torch.argmax(logits, dim=-1).to(torch.float32), None
        logits, _, stats = self.model.decode_step(
            token, caches, steps, schedule=table, collect_stats=True, live=live
        )
        nxt = torch.argmax(logits, dim=-1)
        out = self._ctrl.step_device(state, stats["routing"], stats["dropped"])
        flags = torch.stack([out.fire.to(torch.float32), out.warm.to(torch.float32), out.best.to(torch.float32)])
        packed = [nxt.to(torch.float32), stats["routing"].reshape(-1), stats["dropped"].reshape(-1), flags]
        return torch.cat(packed), out.routable

    def split_outputs(self, host: np.ndarray) -> dict:
        """A decode step's outputs, one f32 vector on the host, by name:
        ``tokens`` [B] int32 and, with a controller, ``routing`` [L, 1, E],
        ``dropped`` [L, 1] and ``fire`` / ``warm`` / ``best``."""
        n = self.batcher.n_slots
        out = {"tokens": host[:n].astype(np.int32)}
        if self._ctrl is not None:
            L, E = self._runtime.n_layers, self.cfg.moe.n_experts
            out["routing"] = host[n : n + L * E].reshape(L, 1, E)
            out["dropped"] = host[n + L * E : n + L * E + L].reshape(L, 1)
            out.update(fire=bool(host[-3] > 0), warm=bool(host[-2] > 0), best=int(host[-1]))
        return out

    def _capture(self) -> None:
        """Capture ``_step`` on the engine's own tensors as one CUDA graph.
        The warm-up step of the usual recipe runs on a side stream on COPIES
        of the caches and controller state, so lazy initialisation happens
        outside the capture and the served state is untouched."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            caches = [{k: v.clone() for k, v in c.items()} for c in self._caches]
            state = None if self._state is None else self._state.clone()
            table = None if state is None else self._ctrl.table_of(state)
            self._step(self._inputs.clone(), caches, state, table)
        torch.cuda.current_stream(self.device).wait_stream(side)
        del caches, state, table
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._graph_out = self._step(self._inputs, self._caches, self._state, self._table)
        self._graph = graph

    def _decode_once(self) -> np.ndarray:
        """One decode step over the slot batch; returns the next token per
        slot (garbage on vacant slots, never read)."""
        self._inputs.copy_(self._host_inputs())
        if self._use_graph:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            self.graph_replays += 1
            packed, routable = self._graph_out
        else:
            packed, routable = self._step(self._inputs, self._caches, self._state, self._table)
        host = packed.cpu().numpy()  # the step's one device-to-host copy
        self.last_outputs = host
        self._decode_steps += 1
        out = self.split_outputs(host)
        if self._ctrl is not None:
            if out["fire"]:
                self._replan(routable, out["warm"], out["best"])
            self._routing_acc.append(out["routing"])
            if len(self._routing_acc) >= self.host_observe_every:
                self._host_observe()
        return out["tokens"]

    def _replan(self, routable, warm: bool, best: int) -> None:
        """The host half of a fired step, timed (host clock around work that
        ends in a synchronize on the card)."""
        t0 = time.perf_counter()
        self._ctrl.replan(self._state, routable, warm=warm, best=best)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.replan_log.append(
            {"decode_step": self._decode_steps, "kind": "warm" if warm else "cold",
             "ms": (time.perf_counter() - t0) * 1e3}
        )

    def _host_observe(self) -> None:
        """Feed aggregated realized decode routing to the host planner: the
        prefill table's re-plan loop."""
        avg = np.mean(np.stack(self._routing_acc), axis=0)
        self._routing_acc.clear()
        decision = self._runtime.observe(avg)
        if decision.changed:
            self._prefill_table = self._runtime.table()
            self._host_swaps += 1

    def step_on_copies(self) -> dict:
        """The eager step function, re-plan included, on COPIES of the next
        decode step's inputs, caches and controller state (the engine's own
        stay untouched): the step's ``outputs`` on the host (as
        ``last_outputs``) and the ``caches`` and ``state`` after the step.
        Holds the captured graph against eager execution."""
        caches = [{k: v.clone() for k, v in c.items()} for c in self._caches]
        state = None if self._state is None else self._state.clone()
        table = None if state is None else self._ctrl.table_of(state)
        packed, routable = self._step(self._host_inputs().to(self.device), caches, state, table)
        host = packed.cpu().numpy()
        out = self.split_outputs(host)
        if out.get("fire"):
            self._ctrl.replan(state, routable, warm=out["warm"], best=out["best"])
        return {"outputs": host, "caches": caches, "state": state, "fire": out.get("fire", False)}

    def run(self, requests, *, continuous: bool = True, max_steps: int = 100_000):
        """Serve ``requests`` (arrival in decode-step units) to completion.
        ``continuous=False`` is the fixed-round baseline: admission only
        when the batch is EMPTY, so every round drains before the next one
        seats.  Returns the metrics summary (also ``metrics()``)."""
        m = self._metrics
        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        m.record_offered(len(pending))
        step_no = 0
        t0 = time.perf_counter()
        while pending or len(self.queue) or self.batcher.n_live:
            if step_no >= max_steps:
                raise RuntimeError(f"serve loop exceeded {max_steps} steps")
            while pending and pending[0].arrival <= step_no:
                req = pending.popleft()
                if req.kv_tokens > self.max_len or not self.queue.add(req):
                    m.record_rejected(req, "capacity")
            if continuous or self.batcher.n_live == 0:
                self._admit_ready(step_no, time.perf_counter())
            if self.batcher.n_live == 0:
                m.record_idle_step()  # waiting on future arrivals
                step_no += 1
                continue
            m.record_decode_step(self.batcher.n_live)
            nxt = self._decode_once()
            for req in self.batcher.advance(nxt, time.perf_counter()):
                m.record_finished(req)
            step_no += 1
        m.wall_s = time.perf_counter() - t0
        return self.metrics()

    # -------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        """Serving telemetry; ``compile`` counts the decode graphs captured
        (0 on the CPU, where the step runs eagerly), the distinct prefill
        lengths run (the buckets, or a recurrent model's exact lengths) and
        the admit function (1 once used)."""
        out = {
            "serve": self._metrics.summary(),
            "compile": {
                "decode_executables": int(self._graph is not None),
                "prefill_executables": len(self._prefill_shapes),
                "admit_executables": int(self._admits > 0),
            },
        }
        if self._ctrl is not None:
            out["controller"] = {
                **self._ctrl.metrics(self._state),
                "host_replans": self._runtime.summary()["replan_events"],
                "host_prefill_swaps": self._host_swaps,
            }
        return out

"""Fault-tolerant training loop.  Counterpart of ``repro/train/loop.py``,
behaviour for behaviour:

* resume from the latest checkpoint on start;
* asynchronous checkpoints every ``ckpt_every`` steps and at the last one;
* retry on failure: a step that raises (injected through
  ``failure_hook``) rolls back to the last checkpoint and continues, with
  a budget of ``max_failures`` consecutive failures that resets once the
  run passes the failing step, and a history without duplicate steps;
* deterministic data: ``batch(step)`` is pure, so replayed steps see the
  same data;
* the loss is read one step late (never blocking on the step just
  launched) and a non-finite one raises ``NonFiniteLossError``, which
  consumes the failure budget like a crash;
* the host runtime (``runtime``): the previous step's realized routing
  feeds ``runtime.observe`` (through ``stats_hook`` when given), and a
  swap hands the re-planned table to the next step;
* the device controller (``device_controller``): the fused step
  (``make_train_step(controller=...)``) observes and scores on the
  device; its telemetry is read only on the logging cadence;
* the degradation chain: a ``FabricFaultError`` goes to
  ``runtime.record_fault``, and when ``runtime.active_fabric()`` moves
  the loop switches the fabric;
* across the ranks of a world (``parallel.sharding.ep_world``), JAX's
  loop under a (data, model) mesh: each data group trains on its rows of
  the global batch, the step reduces the gradients to the global batch's
  (``parallel.data_parallel``), checkpoints are layout-free (rank 0
  writes the global leaves; any layout, or one process, restores them),
  and ``failure_hook``'s outcome is agreed by one MAX all-reduce before
  the step's first collective, so a failure on any rank rolls every rank
  back to the same checkpoint.  A rank's own error inside a step is not
  retried there (the other ranks wait in a collective it will not join):
  it raises.  The loss is the global batch's on every rank, so the
  non-finite check and the failure budget decide alike, and
  the routing stats are summed over the world (``models/moe.py``), so
  every rank's runtime re-plans and swaps alike.  ef8, the device
  controller and a fabric switch are refused there
  (``data_parallel.NEXT_SLICE``).

Where the port differs, and why:

* **Fresh state.** JAX's fresh state is ``Model.init(PRNGKey(0))``.  Here
  it is the model's parameters at loop entry (a host copy), with zeroed
  moments and ef state, so a rollback before the first checkpoint equals
  JAX's on transplanted weights.
  The state is restored in place: parameters keep their storage.
* **The fused step's re-plan.** JAX re-plans inside the step
  (``lax.cond``).  Here the step leaves ``fire`` on the device; the loop
  reads it with the deferred loss, before the next step (and before a
  rollback), and calls ``controller.replan``: the same decisions in the
  same order.
* **Rollback scope.** The device-controller state is not rolled back
  (JAX keeps it across a rollback too).
* **Fabric switches.** JAX rebuilds its immutable model and recompiles
  the step.  Here ``model.cfg``'s dispatch is set in place and the step
  keeps its parameters and state: the layers read ``model.cfg`` at every
  call and nothing caches the dispatch.
* **No compiles.** The port compiles nothing, so where JAX reports
  ``compiles`` the loop reports ``table_rebuilds``: table storage built
  anew after the first swap (host runtime) or after the first step
  (device controller).  A swap inside the envelope refills the same
  tensors, so only an envelope growth or shrink counts.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.faults import FabricFaultError, NonFiniteLossError
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel.fabric import consumes_schedule as _consumes, consumes_table as _consumes_table
from repro_torch.parallel.sharding import current_world
from repro_torch.train.train_step import make_train_step

__all__ = ["TrainLoopConfig", "train_loop"]


class _Agreed(Exception):
    """A failure every rank of the world agreed on (``failure_hook``'s)."""

    def __init__(self, err: Exception):
        super().__init__(str(err))
        self.err = err

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep: int = 3
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup: int = 20
    grad_compress: str | None = None
    # failure budget: consecutive failed attempts; resets once the run
    # passes the step that failed (not on a replayed earlier step)
    max_failures: int = 3
    log_every: int = 10


def train_loop(
    model,
    data_cfg: DataConfig,
    loop_cfg: TrainLoopConfig,
    *,
    shard_batch: Callable | None = None,
    failure_hook: Callable[[int], None] | None = None,
    runtime=None,
    stats_hook: Callable | None = None,
    device_controller=None,
    device_ctrl_state=None,
    schedule=None,
    manager: CheckpointManager | None = None,
) -> dict:
    """Run (or resume) training of ``model`` (trained in place).  Returns
    ``{"history", "final_step", "failures", "final_loss"}``, plus
    ``controller`` with a runtime or a device controller, and
    ``device_ctrl_state`` with the latter.

    shard_batch: optional fn(dict of numpy arrays) -> batch (identity);
      under a world it gets this data group's rows.
    failure_hook: called before each step; may raise to inject a failure.
    runtime: a primed ``core.ScheduleRuntime`` (on the model's device);
      the loop observes the previous step's routing and passes the swapped
      table to the next step.
    stats_hook: fn(step, stats) -> stats on the observed float64 counts
      before ``runtime.observe`` (drift injection).
    device_controller + device_ctrl_state: a ``core.DeviceController`` on
      the model's device and its state (updated in place), in place of
      ``runtime``/``stats_hook``.
    schedule: a static ``ScheduleTable`` for a table-consuming dispatch
      without a runtime (JAX: the schedule its ``Model`` holds).
    manager: the ``CheckpointManager`` to use (default one on
      ``loop_cfg.ckpt_dir`` keeping ``loop_cfg.keep``, layout-free under a
      world); it records each save's and restore's times.
    """
    world = current_world()
    if world is not None and world.size == 1:
        world = None
    if world is not None:
        # refused before any collective, on every rank alike (make_train_step refuses ef8 and the fused step)
        if runtime is not None and runtime.cfg.fallback_chain:
            raise dp.refuse("a runtime fabric switch (the degradation chain)")
        rows = dp.batch_rows(data_cfg.global_batch, world)
    if device_controller is not None:
        if runtime is not None:
            raise ValueError(
                "device_controller and runtime are mutually exclusive: the device controller replaces the "
                "host observe loop (keep the runtime path as a separate parity run)"
            )
        if stats_hook is not None:
            raise ValueError(
                "stats_hook needs host-fetched routing stats; the device controller never surfaces them — "
                "inject drift through the data stream instead"
            )
        if device_ctrl_state is None:
            raise ValueError(
                "device_controller needs an initial state: build one via DeviceController.init_state or "
                ".from_runtime"
            )
    stream = SyntheticStream(data_cfg)
    opt = AdamW(lr=cosine_schedule(loop_cfg.peak_lr, loop_cfg.warmup, loop_cfg.steps))
    moe_cfg = getattr(model.cfg, "moe", None)
    consumes = moe_cfg is not None and _consumes(moe_cfg.dispatch)
    table = None
    if device_controller is not None:
        if not consumes or not _consumes_table(moe_cfg.dispatch):
            raise ValueError(
                "device_controller needs a table-consuming fabric ('phase_pipelined' or 'ragged_a2a'): the "
                "re-plan writes new schedule arrays into the tensors the step reads"
            )
    elif runtime is not None and consumes:
        if not _consumes_table(moe_cfg.dispatch):
            raise ValueError(
                f"{moe_cfg.dispatch!r} bakes its schedule into the executable — a controller runtime cannot "
                "swap its plans; use the 'phase_pipelined' or 'ragged_a2a' fabric for runtime-driven swaps, "
                "or drop the runtime and pass a static schedule"
            )
        if runtime.schedules is None:
            raise ValueError(
                f"{moe_cfg.dispatch!r} dispatch with a runtime needs a primed runtime before the first step "
                "(ScheduleRuntime.prime)"
            )
        table = runtime.table()
    elif consumes:
        if schedule is None:
            raise ValueError(
                f"{moe_cfg.dispatch!r} dispatch needs a schedule before the first step: prime the runtime "
                "(ScheduleRuntime.prime) or pass schedule="
            )
        table = schedule
    chain = runtime.cfg.fallback_chain if runtime is not None else ()
    if chain:
        if moe_cfg is None:
            raise ValueError("fallback_chain needs an MoE model (no moe config found)")
        if chain[0] != moe_cfg.dispatch:
            raise ValueError(
                f"fallback_chain must start at the configured dispatch: chain {chain} vs dispatch "
                f"{moe_cfg.dispatch!r}"
            )
        for fname in chain:
            if _consumes(fname) and not _consumes_table(fname):
                raise ValueError(
                    f"fallback_chain entry {fname!r} bakes its schedule into the executable — the FSM cannot "
                    "swap onto it mid-run; chain table-consuming or schedule-free fabrics only"
                )
    current_dispatch = moe_cfg.dispatch if moe_cfg is not None else None
    step_fn = make_train_step(
        model, opt, microbatches=loop_cfg.microbatches, grad_compress=loop_cfg.grad_compress,
        collect_routing=runtime is not None, controller=device_controller,
    )
    state = step_fn.state
    if manager is None:
        manager = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep, world=world,
                                    sharded=model.expert_names() if world is not None else ())
    at_entry = {n: p.detach().to("cpu", copy=True) for n, p in state["params"].items()}

    @torch.no_grad()
    def fresh_state() -> None:
        """The state a rollback with no checkpoint returns to, in place."""
        for n, p in state["params"].items():
            p.copy_(at_entry[n])
        for t in (*state["opt"]["mu"].values(), *state["opt"]["nu"].values(), *state["ef"].values()):
            t.zero_()
        state["opt"]["step"] = 0

    start_step, restored = manager.restore_latest(state)
    if restored is not None:
        log.info("resumed from step %d", start_step)
    else:
        start_step = 0

    if shard_batch is None:
        shard_batch = lambda b: b  # noqa: E731

    history = []
    failures = 0  # total over the run (reported)
    consecutive_failures = 0  # the retry budget (resets on progress)
    last_failure_step = -1
    step = start_step
    swaps = 0
    fabric_switches = 0
    pre_swap_rebuilds = None  # runtime.table_rebuilds at the first swap
    device_ptrs, device_rebuilds = None, 0
    pending_routing = None  # previous step's routing stats (device)
    pending_loss = None  # previous step's loss (device)
    pending_device = None  # previous fused step's DeviceStep (device)
    last_loss = None  # previous step's loss, read on the host (FSM input)

    def settle_device() -> None:
        """The host half of the previous fused step: read ``fire`` and
        re-plan in place, before anything else sees the plan."""
        nonlocal pending_device
        out, pending_device = pending_device, None
        if out is not None and bool(out.fire):
            device_controller.replan(device_ctrl_state, out.routable, warm=bool(out.warm), best=int(out.best))

    def switch_fabric(want: str) -> None:
        """Move to another fabric of the degradation chain: the dispatch is
        set on ``model.cfg`` in place; parameters and state stay."""
        nonlocal consumes, table, current_dispatch, fabric_switches
        model.cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(model.cfg.moe, dispatch=want))
        consumes = _consumes(want)
        table = runtime.table() if (consumes and _consumes_table(want)) else (schedule if consumes else None)
        current_dispatch = want
        fabric_switches += 1

    def follow_chain(step: int) -> bool:
        want = runtime.active_fabric()
        if want is None or want == current_dispatch:
            return False
        log.info("step %d: degradation chain %s -> %s (%s)", step, current_dispatch, want, runtime.health_state)
        switch_fabric(want)
        return True

    t_last = time.perf_counter()
    steps_since_log = 0
    while step < loop_cfg.steps:
        try:
            settle_device()
            if world is None:
                if failure_hook is not None:
                    failure_hook(step)
            else:
                hook_err = None
                if failure_hook is not None:
                    try:
                        failure_hook(step)
                    except Exception as e:  # noqa: BLE001 - agreed below, then raised on every rank
                        hook_err = e
                if dp.agree(hook_err is not None, world):
                    raise _Agreed(hook_err or RuntimeError(f"step {step}: another rank of the world failed"))
            if pending_loss is not None:
                # the previous step has finished by now: this read is the loop's one host sync a step
                last_loss = float(pending_loss)
                pending_loss = None
                if not np.isfinite(last_loss):
                    raise NonFiniteLossError(
                        f"step {step - 1} produced non-finite loss {last_loss}; rolling back to the last checkpoint"
                    )
            if runtime is not None and pending_routing is not None:
                stats = pending_routing["routing"].cpu()
                dropped = pending_routing["dropped"].cpu()
                pending_routing = None
                if stats_hook is not None:
                    stats = stats_hook(step, np.asarray(stats, dtype=np.float64))
                decision = runtime.observe(stats, dropped=dropped, loss=last_loss)
                if decision.changed:
                    swaps += 1
                    if consumes:
                        if pre_swap_rebuilds is None:
                            pre_swap_rebuilds = runtime.table_rebuilds
                        table = runtime.table()  # the same tensors, refilled, unless the envelope moved
                    log.info(
                        "step %d: controller swap (%s; %s)", step,
                        "library miss" if decision.replanned else "library hit", ",".join(decision.actions),
                    )
            if runtime is not None and chain:
                follow_chain(step)
            batch = shard_batch(stream.batch(step) if world is None else stream.batch(step, host_slice=rows))
            if device_controller is not None:
                metrics = step_fn(batch, device_ctrl_state)
                pending_device = metrics.pop("device_step")
                ptrs = tuple(getattr(device_ctrl_state, n).data_ptr() for n in ("perms", "caps", "valid", "n_phases"))
                device_rebuilds += device_ptrs is not None and ptrs != device_ptrs
                device_ptrs = ptrs
            else:
                metrics = step_fn(batch, table)
            if runtime is not None:
                pending_routing = metrics.pop("moe_stats")
            pending_loss = metrics["loss"]
            if step == loop_cfg.steps - 1:
                # the deferred check would miss the final step: read it now
                last_loss = float(pending_loss)
                pending_loss = None
                if not np.isfinite(last_loss):
                    raise NonFiniteLossError(
                        f"step {step} produced non-finite loss {last_loss}; rolling back to the last checkpoint"
                    )
            if step >= last_failure_step:
                consecutive_failures = 0  # progressed past the failing step: the fault was transient
        except Exception as err:  # roll back to the last checkpoint, retry
            if isinstance(err, _Agreed):
                err = err.err
            elif world is not None and not isinstance(err, NonFiniteLossError):
                # one rank's own fault inside the step: the others wait in a collective it will not join, so
                # no rank can roll back with it; the world stops (the loss is the world's, so a non-finite
                # one is seen by every rank alike)
                raise
            settle_device()
            failures += 1
            consecutive_failures += 1
            last_failure_step = step
            if consecutive_failures > loop_cfg.max_failures:
                raise err
            log.warning("step %d failed (%s); restoring last checkpoint", step, err)
            if runtime is not None and isinstance(err, FabricFaultError):
                # quarantine the backend and re-plan around the fault's link mask before the retry
                runtime.record_fault(err)
            manager.wait()
            ck_step, restored = manager.restore_latest(state)
            if restored is not None:
                step = ck_step
            else:
                fresh_state()
                step = 0
            # replayed steps re-log: drop history at/after the restored step
            history = [h for h in history if h["step"] < step]
            pending_routing = pending_loss = last_loss = None
            if runtime is not None and chain:
                if not follow_chain(step) and consumes and _consumes_table(current_dispatch):
                    table = runtime.table()  # record_fault may have swapped in a masked plan
            t_last = time.perf_counter()
            steps_since_log = 0
            continue

        steps_since_log += 1
        if step % loop_cfg.log_every == 0 or step == loop_cfg.steps - 1:
            loss = float(metrics["loss"])
            now = time.perf_counter()
            dt_step = (now - t_last) / steps_since_log
            t_last = now
            steps_since_log = 0
            entry = {"step": step, "loss": loss, "dt_s": dt_step}
            if device_controller is not None:
                # the one place controller telemetry reaches the host in device mode
                dm = device_controller.metrics(device_ctrl_state)
                entry["device_replans"] = dm["device_replans"]
                entry["drop_fraction"] = dm["drop_fraction"]
            history.append(entry)
            log.info("step %d loss %.4f (%.3fs/step)", step, loss, dt_step)
        step += 1
        if step % loop_cfg.ckpt_every == 0 or step == loop_cfg.steps:
            manager.save_async(step, state)
    settle_device()
    manager.wait()
    out = {
        "history": history,
        "final_step": step,
        "failures": failures,
        "final_loss": history[-1]["loss"] if history else float("nan"),
    }
    if runtime is not None:
        rebuilds = runtime.table_rebuilds - pre_swap_rebuilds if pre_swap_rebuilds is not None else 0
        out["controller"] = {
            **runtime.metrics(), "swaps": swaps, "table_rebuilds": rebuilds, "fabric_switches": fabric_switches,
            "final_dispatch": current_dispatch,
        }
    elif device_controller is not None:
        out["controller"] = {
            **device_controller.metrics(device_ctrl_state), "mode": "device", "table_rebuilds": device_rebuilds,
            "final_dispatch": current_dispatch,
        }
        out["device_ctrl_state"] = device_ctrl_state
    return out

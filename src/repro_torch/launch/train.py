"""Training entry point: plan the MoE schedule, then run the
fault-tolerant loop (``train/loop.py``: checkpoints, resume, rollback on
failure) for ``--steps`` steps of synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --smoke --steps 20 --device cpu --ckpt /path/to/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --layers 2 --steps 8 --seq 256 --batch 8 --dispatch phase_pipelined \
        --grad-compress ef8

The table follows the JAX launcher's recipe: ``build_schedule(cfg, n,
t_rank, plan="lossless")`` with ``t_rank = batch * seq // n`` tokens per
rank, one row per MoE layer with an automatic envelope (for a dispatch
that consumes table rows).  On one card the JAX launcher's ``n`` is its
mesh's model axis, 1; the port takes ``n`` from ``--virtual-ranks``, as
its serving launcher does.  The model keeps f32 masters and computes in
bf16; AdamW follows ``cosine_schedule(peak_lr, warmup, steps)``.  Each
step of ``train`` logs loss, grad norm, step ms and tokens/s; ``main``
goes through ``train_loop`` (checkpoints under ``--ckpt``, every
``max(steps // 4, 10)`` steps and at the last, optional ``--grad-compress
ef8``), as the JAX launcher does, and logs every 10th step; a second run
on the same ``--ckpt`` resumes from its latest checkpoint.
``plan_controller`` builds the device controller of the fused step.
Counterpart of ``repro/launch/train.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.device_controller import DeviceController
from repro_torch.core.runtime import ControllerConfig, ScheduleRuntime
from repro_torch.core.schedule import ScheduleTable
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch.dryrun import build_schedule, expected_traffic
from repro_torch.models import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel.fabric import TABLE_FABRICS
from repro_torch.train import TrainLoopConfig, make_train_step, train_loop

__all__ = ["TrainResult", "plan_table", "plan_controller", "train", "main"]

log = logging.getLogger("repro_torch.launch.train")


@dataclasses.dataclass
class TrainResult:
    losses: list[float]
    grad_norms: list[float]
    step_ms: list[float]
    tokens_per_step: int
    table: object  # the ScheduleTable the run used (or None)

    def tokens_per_s(self) -> list[float]:
        return [self.tokens_per_step / (ms / 1e3) for ms in self.step_ms]


def plan_table(cfg, *, batch: int, seq: int, virtual_ranks: int, device) -> ScheduleTable | None:
    """The JAX launcher's lossless plan as a per-layer table, or None when
    the arch's dispatch consumes no table rows."""
    if cfg.moe is None or cfg.moe.dispatch not in TABLE_FABRICS:
        return None
    t_rank = max(batch * seq // virtual_ranks, 1)
    sched = build_schedule(cfg, virtual_ranks, t_rank, strategy=cfg.moe.schedule_strategy, plan="lossless")
    return ScheduleTable.from_schedules([sched] * cfg.n_moe_layers, envelope="auto", device=device)


def plan_controller(cfg, *, batch: int, seq: int, virtual_ranks: int, device, **overrides):
    """``(runtime, controller, state)`` for the fused train step: a host
    ``ScheduleRuntime`` (default knobs) on ``device``, primed from the
    launcher's expected traffic (its own plan of the draw ``plan_table``
    plans), lifted into a ``DeviceController`` on ``device``;
    ``overrides`` go to ``DeviceController.from_runtime``."""
    n = virtual_ranks
    rt = ScheduleRuntime(ControllerConfig(n_ranks=n, n_experts=cfg.moe.n_experts), cfg.n_moe_layers, device=device)
    rt.prime(expected_traffic(cfg, n, max(batch * seq // n, 1)))
    ctrl, state = DeviceController.from_runtime(rt, device=device, **overrides)
    return rt, ctrl, state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model: Model, *, steps: int, batch: int, seq: int, virtual_ranks: int = 8,
          peak_lr: float = 3e-4, warmup: int = 2, microbatches: int = 1, seed: int = 0) -> TrainResult:
    """Train ``model`` in place for ``steps`` steps of synthetic data."""
    cfg, device = model.cfg, model.device
    table = plan_table(cfg, batch=batch, seq=seq, virtual_ranks=virtual_ranks, device=device)
    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed))
    opt = AdamW(lr=cosine_schedule(peak_lr, warmup, steps))
    step_fn = make_train_step(model, opt, microbatches=microbatches)
    losses, norms, step_ms = [], [], []
    for step in range(steps):
        data = {k: torch.from_numpy(v).to(device) for k, v in stream.batch(step).items()}
        _sync(device)
        t0 = time.perf_counter()
        metrics = step_fn(data, table)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        norms.append(norm)
        log.info(
            "step %d: loss %.4f | grad norm %.3f | lr %.3g | %.1f ms (%.0f tok/s)",
            step, loss, norm, metrics["lr"], step_ms[-1], batch * seq / (step_ms[-1] / 1e3),
        )
    return TrainResult(losses=losses, grad_norms=norms, step_ms=step_ms, tokens_per_step=batch * seq, table=table)


def main(argv=None) -> dict:
    """Returns ``train_loop``'s result, with the table the run used under ``table``."""
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--dispatch", default=None, help="MoE dispatch name (one device: the virtual fabric)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", default=None, choices=[None, "ef8"])
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--virtual-ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=args.dispatch))
    model = Model(cfg, device=args.device, param_dtype=torch.float32, requires_grad=True, seed=0)
    log.info("arch %s, %d layers, %.3f B params", cfg.name, cfg.n_layers,
             sum(p.numel() for p in model.parameters()) / 1e9)
    table = plan_table(cfg, batch=args.batch, seq=args.seq, virtual_ranks=args.virtual_ranks, device=model.device)
    loop_cfg = TrainLoopConfig(
        steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=max(args.steps // 4, 10), microbatches=args.microbatches,
        grad_compress=args.grad_compress, log_every=10,
    )
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    res = train_loop(model, data_cfg, loop_cfg, schedule=table)
    log.info("done: step %d loss %.4f (%d failures recovered)", res["final_step"], res["final_loss"], res["failures"])
    return {**res, "table": table}


if __name__ == "__main__":
    main()

"""Training entry point: plan the MoE schedule, then synthetic data ->
train step -> AdamW for ``--steps`` steps.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --layers 2 --steps 8 --seq 256 --batch 8 --dispatch phase_pipelined

The table follows the JAX launcher's recipe: ``build_schedule(cfg, n,
t_rank, plan="lossless")`` with ``t_rank = batch * seq // n`` tokens per
rank, one row per MoE layer with an automatic envelope (for a dispatch
that consumes table rows).  On one card the JAX launcher's ``n`` is its
mesh's model axis, 1; the port takes ``n`` from ``--virtual-ranks``, as
its serving launcher does.  The model keeps f32 masters and computes in
bf16; AdamW follows ``cosine_schedule(peak_lr, warmup, steps)``.  Each
step logs loss, grad norm, step ms and tokens/s.  Counterpart of
``repro/launch/train.py`` without the checkpoint/fault loop of
``train/loop.py``, which is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.schedule import ScheduleTable
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch.dryrun import build_schedule
from repro_torch.models import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel.fabric import TABLE_FABRICS
from repro_torch.train import make_train_step

__all__ = ["TrainResult", "plan_table", "train", "main"]

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


def main(argv=None) -> TrainResult:
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
    return train(
        model, steps=args.steps, batch=args.batch, seq=args.seq, virtual_ranks=args.virtual_ranks,
        microbatches=args.microbatches,
    )


if __name__ == "__main__":
    main()

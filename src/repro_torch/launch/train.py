"""Training entry point: plan the MoE schedule, then run the
fault-tolerant loop (``train/loop.py``: checkpoints, resume, rollback on
failure) for ``--steps`` steps of synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --smoke --steps 20 --device cpu --ckpt /path/to/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
        --layers 2 --steps 8 --seq 256 --batch 8 --dispatch phase_pipelined \
        --grad-compress ef8
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \
        --layers 4 --steps 8 --seq 1024 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch jamba-1.5-large-398b --layers 1 --steps 8 --seq 1024 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 8 --seq 1024 --batch 4

The table follows the JAX launcher's recipe: ``build_schedule(cfg, n,
t_rank, plan="lossless")`` with ``t_rank = batch * seq // n`` tokens per
rank, one row per MoE layer with an automatic envelope (for a dispatch
that consumes table rows).  On one card the JAX launcher's ``n`` is its
mesh's model axis, 1; the port takes ``n`` from ``--virtual-ranks``, as
its serving launcher does.  A model without MoE (RWKV6) plans no table,
and ``--dispatch`` leaves it as it is.  A frontend config (internvl2,
musicgen) trains on ``frontend_tokens`` prefix embeddings then text
tokens, as JAX's launcher feeds it (``data_config``).  The model keeps f32 masters and
computes in bf16; AdamW follows ``cosine_schedule(peak_lr, warmup,
steps)``.  Each
step of ``train`` logs loss, grad norm, step ms and tokens/s; ``main``
goes through ``train_loop`` (checkpoints under ``--ckpt``, every
``max(steps // 4, 10)`` steps and at the last, optional ``--grad-compress
ef8``, ``--wire-dtype fp8|int8`` and, with ``--dispatch hierarchical``,
``--pod-size`` for a MoE config), as the JAX launcher
does, and logs every 10th step; a second run
on the same ``--ckpt`` resumes from its latest checkpoint.
``plan_controller`` builds the device controller of the fused step.

Under ``torchrun`` (``WORLD_SIZE`` > 1) ``main`` trains across the ranks,
as JAX's launcher does over its mesh: the world is laid out as
``train_mesh_shape(n)`` (JAX's ``build_mesh``), each rank holds its model
group slice of the experts, the table is planned over the model group at
``t_rank = batch // n_data * seq // n_model`` tokens a rank, and
``train_loop`` runs under the world (rank 0 logs)::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu

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
from repro_torch.launch.dryrun import build_hierarchical_table, build_schedule, expected_traffic
from repro_torch.models import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel.fabric import codec_names, consumes_table
from repro_torch.parallel.sharding import close_world, ep_world, init_world, train_mesh_shape
from repro_torch.train import TrainLoopConfig, make_train_step, train_loop

__all__ = ["TrainResult", "data_config", "plan_table", "plan_controller", "train", "main"]

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


def plan_table(cfg, *, batch: int, seq: int, virtual_ranks: int, device, n_data: int = 1):
    """The JAX launcher's lossless plan as a per-layer ``ScheduleTable``
    (a ``HierarchicalTable`` for ``dispatch="hierarchical"``, planned per
    level at ``cfg.moe.pod_size``), or None when the arch's dispatch
    consumes no table rows.  Under a world ``virtual_ranks`` is the model
    group and ``n_data`` the data groups: ``batch // n_data * seq //
    virtual_ranks`` tokens a rank, as JAX's launcher."""
    if cfg.moe is None or not consumes_table(cfg.moe.dispatch):
        return None
    t_rank = max(batch // n_data * seq // virtual_ranks, 1)
    if cfg.moe.dispatch == "hierarchical":
        table = build_hierarchical_table(cfg, virtual_ranks, t_rank, cfg.n_moe_layers, plan="lossless",
                                         device=device)
        log.info("planned hierarchical schedule (pod_size %d): %d intra + %d inter phase slots", cfg.moe.pod_size,
                 table.intra.k_max, table.inter.k_max)
        return table
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


def data_config(cfg, *, seq: int, batch: int, seed: int = 0) -> DataConfig:
    """The JAX launcher's data: a frontend config's ``seq`` positions are
    ``frontend_tokens`` embeddings (``ext_embeds`` [B, P, d]) then ``seq - P``
    tokens."""
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed,
                      frontend_tokens=cfg.frontend_tokens if cfg.frontend != "none" else 0, d_model=cfg.d_model)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model: Model, *, steps: int, batch: int, seq: int, virtual_ranks: int = 8,
          peak_lr: float = 3e-4, warmup: int = 2, microbatches: int = 1, seed: int = 0) -> TrainResult:
    """Train ``model`` in place for ``steps`` steps of synthetic data."""
    cfg, device = model.cfg, model.device
    table = plan_table(cfg, batch=batch, seq=seq, virtual_ranks=virtual_ranks, device=device)
    stream = SyntheticStream(data_config(cfg, seq=seq, batch=batch, seed=seed))
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
    ap.add_argument("--wire-dtype", default=None, choices=[None, *codec_names()],
                    help="wire codec for dispatch payloads (fp8/int8 quantize the slots that cross ranks)")
    ap.add_argument("--pod-size", type=int, default=None,
                    help="ranks per pod for --dispatch=hierarchical (must divide the virtual ranks; pod-local traffic "
                         "rides the electrical intra level, the rest the circuit-scheduled inter level)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", default=None, choices=[None, "ef8"])
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--virtual-ranks", type=int, default=8,
                    help="EP ranks the table is planned over in one process (under torchrun: the model group)")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.moe is not None and args.dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=args.dispatch))
    if cfg.moe is not None and args.wire_dtype:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, wire_dtype=args.wire_dtype))
    if cfg.moe is not None and args.pod_size:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, pod_size=args.pod_size))
    loop_cfg = TrainLoopConfig(
        steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=max(args.steps // 4, 10), microbatches=args.microbatches,
        grad_compress=args.grad_compress, log_every=10,
    )
    data_cfg = data_config(cfg, seq=args.seq, batch=args.batch)
    n_world = int(os.environ.get("WORLD_SIZE", "1"))
    world = init_world(args.device, layout=train_mesh_shape(n_world)) if n_world > 1 else None
    try:
        if world is not None and world.rank:
            logging.getLogger().setLevel(logging.WARNING)  # rank 0 logs the run
        if world is not None:
            log.info("world of %d ranks as (data %d, model %d), backend %s", world.size, world.n_data, world.n_model,
                     world.backend)
        model = Model(cfg, device=args.device if world is None else world.device, param_dtype=torch.float32,
                      requires_grad=True, seed=0, **({} if world is None else world.model_shards(cfg)))
        log.info("arch %s, %d layers, %.3f B params%s", cfg.name, cfg.n_layers,
                 sum(p.numel() for p in model.parameters()) / 1e9, "" if world is None else " a rank")
        n_model, n_data = (args.virtual_ranks, 1) if world is None else (world.n_model, world.n_data)
        table = plan_table(cfg, batch=args.batch, seq=args.seq, virtual_ranks=n_model, n_data=n_data,
                           device=model.device)
        with ep_world(world):
            res = train_loop(model, data_cfg, loop_cfg, schedule=table)
        log.info("done: step %d loss %.4f (%d failures recovered)", res["final_step"], res["final_loss"],
                 res["failures"])
        return {**res, "table": table}
    finally:
        if world is not None:
            close_world()

if __name__ == "__main__":
    main()

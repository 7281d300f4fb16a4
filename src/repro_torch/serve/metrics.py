"""Serving telemetry: admission counters, queue waits, and latency /
throughput percentiles.

Everything here is host-side bookkeeping over completed lifecycle
events; nothing touches the device.  Queue waits are recorded in
*virtual* decode-step units (deterministic under any host speed) and
converted to wall milliseconds in ``summary`` via the measured mean
step duration; per-request throughput uses real wall timestamps.

Counterpart of ``repro/serve/metrics.py``, a copy (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

from repro_torch.serve.queue import Request

__all__ = ["ServeMetrics", "percentiles"]


def percentiles(xs, ps=(50, 99)) -> dict:
    """{"p50": ..., "p99": ..., "mean": ...} over ``xs`` (0s if empty)."""
    a = np.asarray(list(xs), np.float64)
    if a.size == 0:
        return {**{f"p{p}": 0.0 for p in ps}, "mean": 0.0}
    out = {f"p{p}": float(np.percentile(a, p)) for p in ps}
    out["mean"] = float(a.mean())
    return out


class ServeMetrics:
    """Accumulates one engine run's serving telemetry."""

    def __init__(self):
        self.offered = 0
        self.admitted = 0
        self.rejected = 0  # never schedulable: too long for buckets/KV
        self.completed = 0
        self.queue_wait_steps: list[float] = []
        self.request_tok_s: list[float] = []
        self.request_latency_s: list[float] = []
        self.generated_tokens = 0
        self.decode_steps = 0
        self.idle_steps = 0
        self.live_slot_steps = 0  # sum of live counts over decode steps
        self.n_slots = 0
        self.wall_s = 0.0

    # ------------------------------------------------------------- events
    def record_offered(self, n: int = 1) -> None:
        self.offered += n

    def record_rejected(self, req: Request, reason: str) -> None:
        del req, reason  # reasons are uniform for now; counter suffices
        self.rejected += 1

    def record_admitted(self, req: Request, step_no: int) -> None:
        self.admitted += 1
        self.queue_wait_steps.append(float(step_no - req.arrival))

    def record_decode_step(self, n_live: int) -> None:
        self.decode_steps += 1
        self.live_slot_steps += int(n_live)

    def record_idle_step(self) -> None:
        self.idle_steps += 1

    def record_finished(self, req: Request) -> None:
        self.completed += 1
        self.generated_tokens += len(req.tokens)
        if req.admit_wall is not None and req.finish_wall is not None:
            dt = max(req.finish_wall - req.admit_wall, 1e-9)
            self.request_latency_s.append(dt)
            self.request_tok_s.append(len(req.tokens) / dt)

    # ------------------------------------------------------------ summary
    def summary(self) -> dict:
        step_s = self.wall_s / max(self.decode_steps, 1)
        wait = percentiles(self.queue_wait_steps)
        return {
            "requests": {
                "offered": self.offered,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "completed": self.completed,
            },
            "queue_wait_steps": wait,
            "queue_wait_ms": {
                k: v * step_s * 1e3 for k, v in wait.items()
            },
            "request_tok_s": percentiles(self.request_tok_s),
            "request_latency_s": percentiles(self.request_latency_s),
            "throughput_tok_s": self.generated_tokens / max(self.wall_s, 1e-9),
            "generated_tokens": self.generated_tokens,
            "decode_steps": self.decode_steps,
            "idle_steps": self.idle_steps,
            "step_ms": step_s * 1e3,
            "occupancy": self.live_slot_steps
            / max(self.decode_steps * max(self.n_slots, 1), 1),
        }

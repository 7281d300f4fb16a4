"""AdamW with global-norm clipping and the cosine LR schedule.

    opt = AdamW(lr=cosine_schedule(3e-4, 20, 1000), weight_decay=0.1, clip_norm=1.0)
    state = opt.init(params, ranks=model.reference_ranks())
    params, state, stats = opt.update(grads, state, params)

``params`` and ``grads`` are ``{name: tensor}`` dicts.  Moments are f32.
The update runs in place (parameters, moments, and the gradients, which
are scaled by the clip factor), a part of ``UPDATE_CHUNK`` elements of a
leaf at a time, so that the only extra memory is two temporaries of that
size.  The arithmetic follows
``repro/optim/adamw.py``: clip by the global norm, bias-corrected
moments, ``eps`` added to ``sqrt(vhat)``, decoupled decay added to the
step, ``p - lr * delta``.

Weight decay applies where the JAX leaf has rank >= 2.  The JAX block
leaves carry a stacked layer axis, so the per-layer norm scales ([L, d]
there) decay and the final norm ([d]) does not; ``ranks`` gives each
parameter's rank in that layout (default: its own).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AdamW", "cosine_schedule", "global_norm"]

UPDATE_CHUNK = 1 << 24  # elements of a leaf updated at once: the update's two temporaries stay at 64 MB each


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr``, then cosine decay to ``final_frac`` of
    it; evaluated in f32 like the JAX schedule."""
    f32 = np.float32

    def lr(step) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(peak_lr) * step / f32(max(warmup_steps, 1)))
        prog = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
        cos = f32(final_frac) + f32(1 - final_frac) * f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
        return float(f32(peak_lr) * cos)

    return lr


def global_norm(tensors, *, sharded=(), group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (f32).  Under a world,
    ``tensors`` are the leaves every rank holds alike (counted once) and
    ``sharded`` the leaves split over ``group`` (the experts over the model
    group), whose squares are summed over it: the norm of the whole
    gradient, the same on every rank."""
    total = sum(torch.sum(torch.square(t.float())) for t in tensors)
    sharded = list(sharded)
    if sharded:
        part = sum(torch.sum(torch.square(t.float())) for t in sharded)
        if group is not None:
            dist.all_reduce(part, group=group)
        total = total + part
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params: dict, *, ranks: dict | None = None) -> dict:
        """Zero f32 moments; ``decay`` records which parameters decay."""
        ranks = ranks or {}
        return {
            "step": 0,
            "mu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()},
            "nu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()},
            "decay": {n: ranks.get(n, p.dim()) >= 2 for n, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, *, sharded=frozenset(), group=None):
        """One step in place.  Under a world, ``sharded`` names the leaves
        split over ``group`` (the experts over the model group): the clip
        norm is then the whole gradient's (``global_norm``), so every rank
        clips by the same factor."""
        step = state["step"] + 1
        gnorm = global_norm([g for n, g in grads.items() if n not in sharded],
                            sharded=[g for n, g in grads.items() if n in sharded], group=group)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            for g in grads.values():
                g.mul_(scale)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        bc1 = float(1 - np.float32(b1) ** np.float32(step))
        bc2 = float(1 - np.float32(b2) ** np.float32(step))
        for name, p in params.items():
            decay = state["decay"][name]
            flat = [t.view(-1) for t in (p, grads[name], state["mu"][name], state["nu"][name])]
            for a in range(0, p.numel(), UPDATE_CHUNK):  # elementwise, so a part at a time: bounded temporaries
                p_, g, mu, nu = (t[a:a + UPDATE_CHUNK] for t in flat)
                g = g.float()
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (nu / bc2).sqrt_().add_(self.eps)
                delta = (mu / bc1).div_(denom)
                del denom
                if decay:
                    delta.add_(p_.float(), alpha=self.weight_decay)
                delta.mul_(lr)
                if p_.dtype == torch.float32:
                    p_.sub_(delta)
                else:
                    p_.copy_(p_.float().sub_(delta))
                del delta
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}

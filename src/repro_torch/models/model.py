"""Model facade: embeddings -> layer stack -> norm -> logits, with the
serving entry points ``prefill`` and ``decode_step``.

``Model(cfg, device=...)`` holds the parameters as an ``nn.Module`` on
one device: CUDA unless the caller passes ``device="cpu"``.  ``seed``
draws them from a ``torch.Generator`` on that device with the JAX init's
distributions (the numbers differ from JAX's); ``seed=None`` leaves them
for ``transplant.load_reference``.  Counterpart of ``repro/models/model.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack
from repro_torch.models.layers import dense, embed, normal_param, ones_param, resolve_device, rmsnorm

__all__ = ["Model", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """The port runs RoPE attention + MoE blocks (Mixtral's pattern)."""
    unsupported = {
        "moe": cfg.moe is None,
        "block": cfg.block != "attn" or cfg.hybrid is not None,
        "pos_embedding": cfg.pos_embedding != "rope",
        "qkv_bias": cfg.qkv_bias,
        "frontend": cfg.frontend != "none",
        "tie_embeddings": cfg.tie_embeddings,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: {', '.join(bad)} not ported yet (ROADMAP: other mixers)")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.bfloat16, seed: int | None = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        gen = None if seed is None else torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(gen=gen, device=self.device, dtype=dtype)
        d = cfg.d_model
        self.embed = normal_param((cfg.vocab_size, d), 0.02, **kw)
        self.layers = nn.ModuleList(stack.block_init(cfg, l, **kw) for l in range(cfg.n_layers))
        self.ln_f = ones_param(d, device=self.device)
        self.head = normal_param((d, cfg.vocab_size), d**-0.5, **kw)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> list[dict]:
        return stack.stack_cache(self.cfg, batch, max_len, dtype=dtype, device=self.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.ln_f, eps=self.cfg.norm_eps)
        return dense(x, self.head).float()

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, caches: list[dict], *, schedule=None, collect_stats=False):
        """Process prompts [B, S], filling ``caches`` in place.  Returns
        (last-token logits [B, V] f32, caches), plus the per-layer MoE
        stats (``routing`` [L, 1, E], ``dropped`` / ``admitted`` [L, 1])
        with ``collect_stats``."""
        x = embed(self.embed, tokens)
        stats = []
        for p, cache, row in zip(self.layers, caches, stack.schedule_rows(schedule, self.cfg)):
            x, _, st = stack.block_prefill(p, self.cfg, x, cache, row, collect_stats=collect_stats)
            stats.append(st)
        logits = self._logits(x[:, -1:, :])[:, 0]
        if collect_stats:
            return logits, caches, stack.stack_stats(stats)
        return logits, caches

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, caches: list[dict], step: int, *, schedule=None, collect_stats=False):
        """One decode step for token [B] at absolute position ``step``.
        Returns (logits [B, V] f32, caches) (+ stats, as ``prefill``)."""
        x = embed(self.embed, token[:, None])
        stats = []
        for p, cache, row in zip(self.layers, caches, stack.schedule_rows(schedule, self.cfg)):
            x, _, st = stack.block_decode(p, self.cfg, x, cache, step, row, collect_stats=collect_stats)
            stats.append(st)
        logits = self._logits(x)[:, 0]
        if collect_stats:
            return logits, caches, stack.stack_stats(stats)
        return logits, caches

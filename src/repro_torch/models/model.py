"""Model facade: embeddings -> layer stack -> norm -> logits, with the
serving entry points ``prefill`` and ``decode_step`` and the training
entry points ``forward``, ``loss`` and ``loss_and_stats``.

``Model(cfg, device=...)`` holds the parameters as an ``nn.Module`` on
one device: CUDA unless the caller passes ``device="cpu"``.  ``dtype``
is the compute dtype; ``param_dtype`` (default: ``dtype``) stores the
weights JAX casts at use, so a trainer passes ``torch.float32`` masters
and ``requires_grad=True``.  ``seed`` draws the parameters from a
``torch.Generator`` on that device with the JAX init's distributions
(the numbers differ from JAX's); ``seed=None`` leaves them for
``transplant.load_reference``.  Counterpart of ``repro/models/model.py``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack
from repro_torch.models.layers import dense, embed, normal_param, ones_param, resolve_device, rmsnorm

CE_CHUNKS = 8  # JAX Model._ce: sequence chunks of the cross-entropy

__all__ = ["Model", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """The port runs RoPE attention + MoE blocks (Mixtral's pattern) and
    RWKV6 blocks without MoE."""
    rwkv = cfg.block == "rwkv6"
    unsupported = {
        "dense FFN": cfg.moe is None and not rwkv,
        "moe with rwkv6": rwkv and cfg.moe is not None,
        "block": cfg.block not in ("attn", "rwkv6") or cfg.hybrid is not None,
        "pos_embedding": cfg.pos_embedding != "rope",
        "qkv_bias": cfg.qkv_bias,
        "frontend": cfg.frontend != "none",
        "tie_embeddings": cfg.tie_embeddings,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: {', '.join(bad)} not ported yet (ROADMAP: other mixers)")


class Model(nn.Module):
    def __init__(
        self, cfg: ModelConfig, *, device=None, dtype=torch.bfloat16, param_dtype=None,
        seed: int | None = 0, requires_grad: bool = False,
    ):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        gen = None if seed is None else torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(gen=gen, device=self.device, dtype=self.param_dtype)
        d = cfg.d_model
        self.embed = normal_param((cfg.vocab_size, d), 0.02, **kw)
        self.layers = nn.ModuleList(stack.block_init(cfg, l, **kw) for l in range(cfg.n_layers))
        self.ln_f = ones_param(d, device=self.device)
        self.head = normal_param((d, cfg.vocab_size), d**-0.5, **kw)
        self.requires_grad_(requires_grad)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> list[dict]:
        return stack.stack_cache(self.cfg, batch, max_len, dtype=dtype, device=self.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.ln_f, eps=self.cfg.norm_eps)
        return dense(x, self.head).float()

    # ------------------------------------------------------------ training
    def reference_ranks(self) -> dict[str, int]:
        """Each parameter's rank in the JAX pytree, whose block leaves are
        stacked over layers (one more axis than the port's per-layer
        tensor).  AdamW decays by this rank, as JAX does."""
        return {n: p.dim() + n.startswith("layers.") for n, p in self.named_parameters()}

    def reference_groups(self) -> list[list[str]]:
        """Parameter names grouped by the JAX leaf that holds them: one
        group per block attribute (the leaf stacked over layers), one per
        top-level parameter.  Error-feedback compression takes one scale
        per group, as JAX takes one per leaf."""
        groups: dict[str, list[str]] = {}
        for n, _ in self.named_parameters():
            key = "layers." + n.split(".", 2)[2] if n.startswith("layers.") else n
            groups.setdefault(key, []).append(n)
        return list(groups.values())

    def _hidden(self, tokens, schedule, collect_stats):
        x = embed(self.embed, tokens, self.dtype)
        return stack.stack_train(self.layers, self.cfg, x, schedule, collect_stats=collect_stats)

    def forward(self, tokens: torch.Tensor, *, schedule=None) -> torch.Tensor:
        """Training/eval forward: full-sequence logits [B, S, V] (f32)."""
        return self._logits(self._hidden(tokens, schedule, False))

    def loss(self, batch: dict, *, schedule=None) -> torch.Tensor:
        """Mean next-token cross-entropy over positions with targets >= 0
        (``batch``: ``tokens`` / ``targets`` [B, S] int)."""
        return self._ce(self._hidden(batch["tokens"], schedule, False), batch["targets"])

    def loss_and_stats(self, batch: dict, *, schedule=None):
        """``loss`` plus the per-layer MoE stats (``routing`` [L, 1, E],
        ``dropped`` / ``admitted`` [L, 1])."""
        hidden, stats = self._hidden(batch["tokens"], schedule, True)
        return self._ce(hidden, batch["targets"]), stats

    def _ce_chunk(self, h_c, t_c):
        logits = self._logits(h_c)
        mask = (t_c >= 0).float()
        safe = torch.clamp(t_c, min=0).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        return ((logz - gold) * mask).sum(), mask.sum()

    def _ce(self, hidden, targets) -> torch.Tensor:
        """The JAX ``_ce``: the sequence in ``CE_CHUNKS`` chunks (one when S
        does not divide), each chunk's logits recomputed in the backward
        instead of kept, summed in chunk order in f32."""
        s = hidden.shape[1]
        nc = CE_CHUNKS if s % CE_CHUNKS == 0 else 1
        sc = s // nc
        nll = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(nc):
            h_c, t_c = hidden[:, i * sc:(i + 1) * sc], targets[:, i * sc:(i + 1) * sc]
            if nc == 1:
                n, c = self._ce_chunk(h_c, t_c)
            else:
                n, c = checkpoint(self._ce_chunk, h_c, t_c, use_reentrant=False)
            nll, cnt = nll + n, cnt + c
        return nll / torch.clamp(cnt, min=1.0)

    # ------------------------------------------------------------- serving
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, caches: list[dict], *, schedule=None, collect_stats=False):
        """Process prompts [B, S], filling ``caches`` in place.  Returns
        (last-token logits [B, V] f32, caches), plus the per-layer MoE
        stats (``routing`` [L, 1, E], ``dropped`` / ``admitted`` [L, 1];
        None for a model without MoE) with ``collect_stats``."""
        x = embed(self.embed, tokens, self.dtype)
        stats = []
        for p, cache, row in zip(self.layers, caches, stack.schedule_rows(schedule, self.cfg)):
            x, _, st = stack.block_prefill(p, self.cfg, x, cache, row, collect_stats=collect_stats)
            stats.append(st)
        logits = self._logits(x[:, -1:, :])[:, 0]
        if collect_stats:
            return logits, caches, stack.stack_stats(stats)
        return logits, caches

    @torch.inference_mode()
    def decode_step(
        self, token: torch.Tensor, caches: list[dict], step, *, schedule=None, collect_stats=False, live=None,
    ):
        """One decode step for token [B].  ``step`` is an int (every row at
        that absolute position) or a [B] int32 tensor (continuous batching:
        each slot at its own depth; ``attention.attn_decode``).  ``live``
        ([B] bool, optional) masks vacated slots out of the MoE routing
        counts, so a static-shape batch's garbage rows never count as
        demand.  Returns (logits [B, V] f32, caches) (+ stats, as
        ``prefill``)."""
        x = embed(self.embed, token[:, None], self.dtype)
        token_weight = None if live is None else live.to(torch.float32)[:, None]
        stats = []
        for p, cache, row in zip(self.layers, caches, stack.schedule_rows(schedule, self.cfg)):
            x, _, st = stack.block_decode(
                p, self.cfg, x, cache, step, row, collect_stats=collect_stats, token_weight=token_weight
            )
            stats.append(st)
        logits = self._logits(x)[:, 0]
        if collect_stats:
            return logits, caches, stack.stack_stats(stats)
        return logits, caches

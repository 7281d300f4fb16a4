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
``transplant.load_reference``.  ``expert_shard`` (rank, n) keeps EP rank
``rank``'s contiguous slice of each MoE layer's experts, and ``ffn_shard``
(index, n) data group ``index``'s slice of their FFN width under 2D
expert sharding (``World.model_shards`` gives both); a seeded model draws
every expert whole, so its slice equals the one-device model's.  With ``tie_embeddings`` there is no
``head``: the logits are ``x @ table.T`` in f32, and the table is kept in
f32 whatever the storage dtype, as JAX's ``unembed_apply`` reads it.  A
modality frontend's precomputed embeddings (``ext_embeds`` [B, P, d]) are
prepended to the token embeddings, and positions (RoPE or sinusoidal)
run over the whole sequence.  Counterpart of ``repro/models/model.py``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import stack
from repro_torch.models.layers import (
    dense, embed, normal_param, ones_param, resolve_device, rmsnorm, sinusoidal_pos,
)

CE_CHUNKS = 8  # JAX Model._ce: sequence chunks of the cross-entropy

__all__ = ["Model", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """The port runs attention (RoPE or sinusoidal positions, QKV bias,
    sliding windows) and Mamba mixers (the hybrid interleave), each with an
    MoE, SwiGLU or GELU FFN, and RWKV6 blocks without MoE, with tied or
    separate embeddings and the patch/frames frontends: every config of the
    JAX package.  It rejects the combinations the JAX package has no
    config for."""
    rwkv = cfg.block == "rwkv6"
    unsupported = {
        "moe with rwkv6": rwkv and cfg.moe is not None,
        "block": cfg.block not in ("attn", "rwkv6"),
        "pos_embedding": cfg.pos_embedding not in ("rope", "sinusoidal"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: {', '.join(bad)}: no such config in the JAX package")


def _slice_of(total: int, index: int, n: int, what: str, over: str) -> tuple[int, int]:
    """[lo, hi) of part ``index`` of ``total`` split into ``n`` equal parts."""
    if total % n:
        raise ValueError(f"{total} {what} do not split over {n} {over}")
    part = total // n
    return index * part, (index + 1) * part


class Model(nn.Module):
    def __init__(
        self, cfg: ModelConfig, *, device=None, dtype=torch.bfloat16, param_dtype=None,
        seed: int | None = 0, requires_grad: bool = False, expert_shard: tuple[int, int] | None = None,
        ffn_shard: tuple[int, int] | None = None,
    ):
        super().__init__()
        check_supported(cfg)
        experts = ffn = None
        if expert_shard is not None and cfg.moe is not None:
            experts = _slice_of(cfg.moe.n_experts, *expert_shard, "experts", "EP ranks")
        if ffn_shard is not None and cfg.moe is not None:
            ffn = _slice_of(cfg.moe.d_ff_expert, *ffn_shard, "expert FFN columns", "data groups")
        self.expert_shard = expert_shard
        self.ffn_shard = ffn_shard if cfg.moe is not None else None
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        gen = None if seed is None else torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(gen=gen, device=self.device, dtype=self.param_dtype)
        d = cfg.d_model
        table_dtype = torch.float32 if cfg.tie_embeddings else self.param_dtype
        self.embed = normal_param((cfg.vocab_size, d), 0.02, **{**kw, "dtype": table_dtype})
        self.layers = nn.ModuleList(
            stack.block_init(cfg, l, **kw, experts=experts, ffn=ffn) for l in range(cfg.n_layers))
        self.ln_f = ones_param(d, device=self.device)
        self.head = None if cfg.tie_embeddings else normal_param((d, cfg.vocab_size), d**-0.5, **kw)
        self.requires_grad_(requires_grad)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> list[dict]:
        return stack.stack_cache(self.cfg, batch, max_len, dtype=dtype, device=self.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.ln_f, eps=self.cfg.norm_eps)
        if self.head is None:  # tied: f32 logits against the f32 table
            return x.float() @ self.embed.float().T
        return dense(x, self.head).float()

    def _embed(self, tokens: torch.Tensor, ext_embeds=None) -> torch.Tensor:
        """Token embeddings [B, S, d] in the compute dtype, after the
        frontend's ``ext_embeds`` [B, P, d] when given, plus sinusoidal
        positions 0 .. P + S - 1 where the arch uses them."""
        x = embed(self.embed, tokens, self.dtype)
        if ext_embeds is not None:
            x = torch.cat([ext_embeds.to(device=x.device, dtype=self.dtype), x], dim=1)
        if self.cfg.pos_embedding == "sinusoidal":
            x = x + sinusoidal_pos(x.shape[1], self.cfg.d_model, dtype=self.dtype, device=x.device)[None]
        return x

    # ------------------------------------------------------------ training
    def reference_ranks(self) -> dict[str, int]:
        """Each parameter's rank in the JAX pytree, whose block leaves are
        stacked over layers (one more axis than the port's per-layer
        tensor).  AdamW decays by this rank, as JAX does."""
        return {n: p.dim() + n.startswith("layers.") for n, p in self.named_parameters()}

    def expert_names(self) -> frozenset[str]:
        """Names of the parameters that hold an MoE layer's experts (split
        over the model group under a world); a dense SwiGLU's
        ``ffn.w_gate`` is not one."""
        names = [n for n, _ in self.named_parameters()]
        return frozenset(
            n for n in names
            if n.endswith(("ffn.w_gate", "ffn.w_up", "ffn.w_down")) and n.rsplit(".", 1)[0] + ".router" in names
        )

    def ffn_axes(self) -> dict[str, int]:
        """The FFN-width axis of each expert parameter when the model holds a
        slice of that width (2D expert sharding: ``w_gate``/``w_up`` [E, d,
        F] on axis 2, ``w_down`` [E, F, d] on axis 1); empty otherwise."""
        if self.ffn_shard is None:
            return {}
        return {n: 1 if n.endswith("w_down") else 2 for n in self.expert_names()}

    def reference_groups(self) -> list[list[str]]:
        """Parameter names grouped by the JAX leaf that holds them: one
        group per block attribute (the leaf stacked over layers), one per
        top-level parameter.  Error-feedback compression takes one scale
        per group, as JAX takes one per leaf."""
        groups: dict[str, list[str]] = {}
        period = self.cfg.period
        for n, _ in self.named_parameters():
            if n.startswith("layers."):
                _, layer, attr = n.split(".", 2)
                key = f"layers.pos{int(layer) % period}.{attr}"
            else:
                key = n
            groups.setdefault(key, []).append(n)
        return list(groups.values())

    def _hidden(self, tokens, schedule, collect_stats, ext_embeds=None):
        x = self._embed(tokens, ext_embeds)
        return stack.stack_train(self.layers, self.cfg, x, schedule, collect_stats=collect_stats)

    def forward(self, tokens: torch.Tensor, ext_embeds=None, *, schedule=None) -> torch.Tensor:
        """Training/eval forward: full-sequence logits [B, P + S, V] (f32)."""
        return self._logits(self._hidden(tokens, schedule, False, ext_embeds))

    def loss(self, batch: dict, *, schedule=None) -> torch.Tensor:
        """Mean next-token cross-entropy over positions with targets >= 0
        (``batch``: ``tokens`` / ``targets`` [B, S] int, and ``ext_embeds``
        [B, P, d] for a frontend, whose positions carry no loss)."""
        hidden = self._hidden(batch["tokens"], schedule, False, batch.get("ext_embeds"))
        return self._ce(hidden, batch["targets"])

    def loss_and_stats(self, batch: dict, *, schedule=None):
        """``loss`` plus the per-layer MoE stats (``routing`` [L, 1, E],
        ``dropped`` / ``admitted`` [L, 1]); None for a model without MoE
        (RWKV6), as in JAX."""
        hidden, stats = self._hidden(batch["tokens"], schedule, True, batch.get("ext_embeds"))
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
        instead of kept, summed in chunk order in f32.  A frontend prefix
        (hidden longer than targets) takes target -1: no loss."""
        if hidden.shape[1] != targets.shape[1]:
            pad = hidden.shape[1] - targets.shape[1]
            targets = torch.cat([torch.full((targets.shape[0], pad), -1, dtype=targets.dtype,
                                            device=targets.device), targets], dim=1)
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
    def prefill(self, tokens: torch.Tensor, caches: list[dict], ext_embeds=None, *, schedule=None,
                collect_stats=False):
        """Process prompts [B, S] (after ``ext_embeds`` [B, P, d] for a
        frontend), filling ``caches`` in place; decoding then starts at
        position P + S.  Returns (last-token logits [B, V] f32, caches),
        plus the per-layer MoE stats (``routing`` [L, 1, E], ``dropped`` /
        ``admitted`` [L, 1]; None for a model without MoE) with
        ``collect_stats``."""
        x = self._embed(tokens, ext_embeds)
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
        if self.cfg.pos_embedding == "sinusoidal":  # [1, d] at step, or [B, 1, d] at each row's step
            pe = sinusoidal_pos(1, self.cfg.d_model, offset=step, dtype=self.dtype, device=x.device)
            x = x + (pe if isinstance(step, torch.Tensor) else pe[None])
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

"""Deterministic synthetic LM data (numpy only).

``SyntheticStream(cfg).batch(step)`` is a pure function of (seed, step)
through numpy's counter-based Philox generator, so a restarted run
continues the same data order.  Tokens follow a per-sequence Markov
chain (Zipf marginals + locality) so the cross-entropy has learnable
signal; ``targets`` are the next tokens, -1 at the last position.
Counterpart of ``repro/data/pipeline.py``: the same batches, copied so
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticStream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    d_model: int = 0  # needed when frontend_tokens > 0


class SyntheticStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf-ish unigram over a smallish effective vocab for signal.
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks**1.1)
        self._probs /= self._probs.sum()

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.Philox(key=self.cfg.seed, counter=step)
        )

    def batch(self, step: int, *, host_slice: slice | None = None) -> dict:
        """The global (or host-sliced) batch for ``step``."""
        cfg = self.cfg
        rng = self._rng(step)
        b = cfg.global_batch
        s_tok = cfg.seq_len - cfg.frontend_tokens
        # Markov chain: with prob 0.6 repeat a local pattern, else resample.
        base = rng.choice(cfg.vocab_size, size=(b, s_tok), p=self._probs)
        shift = np.roll(base, 1, axis=1)
        keep = rng.random((b, s_tok)) < 0.6
        tokens = np.where(keep, (shift + 1) % cfg.vocab_size, base)
        tokens = tokens.astype(np.int32)
        targets = np.roll(tokens, -1, axis=1).astype(np.int32)
        targets[:, -1] = -1
        out = {"tokens": tokens, "targets": targets}
        if cfg.frontend_tokens:
            out["ext_embeds"] = rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.d_model), dtype=np.float32
            ) * 0.02
        if host_slice is not None:
            out = {k: v[host_slice] for k, v in out.items()}
        return out

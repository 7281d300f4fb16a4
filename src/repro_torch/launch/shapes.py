"""The assigned input-shape cells and their input specs.

LM transformer shapes (per assignment):
  train_4k     seq 4096,   global_batch 256   -> train step
  prefill_32k  seq 32768,  global_batch 32    -> serve prefill
  decode_32k   seq 32768,  global_batch 128   -> serve step (1 new token,
                                                 a cache of seq_len)
  long_500k    seq 524288, global_batch 1     -> serve step; sub-quadratic
                                                 archs only (cfg.subquadratic)

``input_specs`` returns tensors on the ``meta`` device: shapes and dtypes
only, no storage (PyTorch's counterpart of ``jax.ShapeDtypeStruct``).
A config with a modality frontend takes ``frontend_tokens`` of the
sequence as precomputed embeddings (``ext_embeds``, bf16) in the train
and prefill cells, and the rest as tokens.  Where a cell is only described, as here, no
524288-token prompt is prefilled: the decode cell is one new token
against a cache of ``seq_len``.  Counterpart of ``repro/launch/shapes.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["Cell", "CELLS", "cell_applicable", "input_specs"]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


CELLS = {
    "train_4k": Cell("train_4k", 4096, 256, "train"),
    "prefill_32k": Cell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Cell("decode_32k", 32768, 128, "decode"),
    "long_500k": Cell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, cell: Cell) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped)."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "pure full-attention arch: 500k-token decode is the quadratic "
            "regime the shape excludes (DESIGN.md §4)"
        )
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: Cell) -> dict:
    """Meta-device stand-ins for every model input of this cell."""
    b, s = cell.global_batch, cell.seq_len
    if cell.mode in ("train", "prefill"):
        s_tok = s - cfg.frontend_tokens
        out = {"tokens": _spec((b, s_tok), torch.int32)}
        if cell.mode == "train":
            out["targets"] = _spec((b, s_tok), torch.int32)
        if cfg.frontend != "none":
            out["ext_embeds"] = _spec((b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
        return out
    # decode: one new token against a seq_len cache
    return {"token": _spec((b,), torch.int32), "step": _spec((), torch.int32)}

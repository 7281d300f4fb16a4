"""AdamW with global-norm clipping, the cosine LR schedule and
error-feedback int8 gradient compression."""

from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm
from repro_torch.optim.compression import ef_int8_compress, ef_int8_init

__all__ = ["AdamW", "cosine_schedule", "ef_int8_compress", "ef_int8_init", "global_norm"]

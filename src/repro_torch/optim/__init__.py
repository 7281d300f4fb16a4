"""AdamW with global-norm clipping and the cosine LR schedule."""

from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm

__all__ = ["AdamW", "cosine_schedule", "global_norm"]

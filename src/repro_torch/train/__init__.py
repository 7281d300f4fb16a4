"""The train step: loss and gradients (microbatch accumulation) + AdamW."""

from repro_torch.train.train_step import make_train_step

__all__ = ["make_train_step"]

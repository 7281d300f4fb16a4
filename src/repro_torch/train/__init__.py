"""The train step (loss and gradients, microbatch accumulation, ef8,
AdamW) and the fault-tolerant loop around it."""

from repro_torch.train.loop import TrainLoopConfig, train_loop
from repro_torch.train.train_step import make_train_step

__all__ = ["TrainLoopConfig", "make_train_step", "train_loop"]

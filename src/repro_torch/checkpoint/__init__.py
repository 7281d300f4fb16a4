"""Checkpoints: atomic, async, keep-K (``manager.py``)."""

from repro_torch.checkpoint.manager import CheckpointManager, restore, save

__all__ = ["CheckpointManager", "restore", "save"]

"""Deterministic synthetic LM data."""

from repro_torch.data.pipeline import DataConfig, SyntheticStream

__all__ = ["DataConfig", "SyntheticStream"]

"""Parallel execution: the MoE fabric seam (one device so far)."""

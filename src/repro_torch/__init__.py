"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

Mirrors ``src/repro``'s layout; imports neither ``jax`` nor ``repro``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

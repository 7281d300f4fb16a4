"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

K1 ``moe_gemm``: grouped SwiGLU expert GEMM; K4 ``flash_attention``:
prefill attention.  Each wrapper launches its kernel on a CUDA tensor and
runs the plain version on a CPU tensor.  Kernels build on first use.
"""

"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

K1 ``moe_gemm``: grouped SwiGLU expert GEMM, differentiable through K2
``moe_gemm_dgrad`` and K3 ``moe_gemm_wgrad``; K3b ``moe_gemm_ungrouped``:
the same with every row live; K4 ``flash_attention``: prefill attention;
K5 ``wkv6``: the RWKV6 recurrence.  Each wrapper launches its kernel on
a CUDA tensor and runs the plain version on a CPU tensor.  Kernels build
on first use.
"""

"""Hand-written CUDA kernels (``csrc/``), their wrappers (``sfc_matmul``,
``paged_attention``) and their plain PyTorch versions (``ref``); the
GEMM entry point is ``ops.sfc_matmul``.  Importing builds nothing."""

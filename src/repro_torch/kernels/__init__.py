"""Hand-written CUDA kernels (``csrc/``), their wrappers (``sfc_matmul``:
B1 and the batched B3; ``paged_attention``: B2; ``sfc_matmul_cached``:
B4) and their plain PyTorch versions (``ref``); the GEMM entry points
are ``ops.sfc_matmul`` and ``ops.sfc_matmul_batched``.  Importing builds
nothing."""

"""Hand-written CUDA kernels (``csrc/``), their wrappers (``sfc_matmul``:
B1 and the batched B3; ``paged_attention``: B2, with a sliding window;
``sfc_matmul_cached``: B4; ``sfc_matmul_grouped``: B5, a routed moe's
experts in one launch) and their plain PyTorch versions (``ref``, and
B5's beside its wrapper); the GEMM entry points are ``ops.sfc_matmul``
and ``ops.sfc_matmul_batched``.  Importing builds nothing."""

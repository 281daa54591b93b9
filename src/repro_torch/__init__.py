"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package grows beside
it slice by slice (ROADMAP.md).  It imports ``torch`` and ``numpy`` and
nothing of ``repro`` or ``jax``.  Module names follow ``repro``'s, so
each module's counterpart sits at the same path in ``src/repro/``.

Every TPU kernel on a ported path is a hand-written CUDA C++ kernel
(``kernels/csrc/``), built with ``nvcc`` for ``sm_90a`` at first use and
bound through ``ctypes`` (``kernels/_build.py``).  Each kernel wrapper
takes its plain PyTorch version only for tensors that lie on the CPU; on
a CUDA tensor it launches the kernel or raises.
"""
from .device import resolve_device  # noqa: F401

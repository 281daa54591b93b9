"""Public GEMM entry point (port of ``repro.kernels.ops.sfc_matmul``).

``sfc_matmul`` is the GEMM every model projection routes through
(``repro_torch.models.layers.DotEngine``).  A curve schedule runs the
hand-written SFC kernel (:func:`repro_torch.kernels.sfc_matmul.sfc_matmul_cuda`),
which masks ragged edges itself, so nothing is padded or cropped here.
``schedule="xla"`` is the library baseline the reference leaves to XLA:
:func:`repro_torch.kernels.ref.matmul_fused_ref` (``torch.matmul`` with
the same f32 epilogue).  ``schedule="auto"`` waits for the tuner's port.
"""
from __future__ import annotations

import torch

from .ref import matmul_fused_ref
from .sfc_matmul import sfc_matmul_cuda

__all__ = ["sfc_matmul"]


def sfc_matmul(a: torch.Tensor, b: torch.Tensor, *, schedule: str = "morton",
               bm: int = 128, bn: int = 128, bk: int = 128, out_dtype=None,
               use_prefetch: bool = True, g: int = 0, bias=None,
               activation: str = "none", residual=None) -> torch.Tensor:
    """C = act(A @ B + bias) + residual, tiles visited in ``schedule``
    order.  ``bias`` (N,), ``activation`` in {none, relu, gelu, silu}
    and ``residual`` (M, N) form the fused epilogue, applied to the f32
    accumulator before one cast to ``out_dtype`` (default ``a.dtype``).
    """
    if schedule == "auto":
        raise NotImplementedError(
            "schedule='auto' needs the tuner (repro.tune), which is not "
            "ported yet (ROADMAP queue A); pass a curve schedule or 'xla'")
    if schedule == "xla":
        return matmul_fused_ref(a, b, bias=bias, activation=activation,
                                residual=residual, out_dtype=out_dtype)
    return sfc_matmul_cuda(a, b, schedule=schedule, bm=bm, bn=bn, bk=bk,
                           out_dtype=out_dtype, use_prefetch=use_prefetch,
                           g=g, bias=bias, activation=activation,
                           residual=residual)

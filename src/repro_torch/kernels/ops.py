"""Public GEMM entry points (port of ``repro.kernels.ops``).

``sfc_matmul`` is the GEMM every model projection routes through
(``repro_torch.models.layers.DotEngine``).  A curve schedule runs the
hand-written SFC kernel (:func:`repro_torch.kernels.sfc_matmul.sfc_matmul_cuda`),
which masks ragged edges itself, so nothing is padded or cropped here.
``sfc_matmul_batched`` is the einsum-style ``bij,bjk->bik`` entry: any
number of leading batch dims, flattened into one for the batched kernel
(:func:`repro_torch.kernels.sfc_matmul.sfc_matmul_batched_cuda`), or
run as one B1 launch per element with ``per_element=True`` (the
reference's ``via_vmap=True``).
``schedule="xla"`` is the library baseline the reference leaves to XLA
(``jnp.dot(a, b, preferred_element_type=f32)``: products in the input
dtype, f32 accumulation), :func:`library_matmul`: on a CUDA tensor with
bf16 operands one bf16 GEMM with f32 output (``torch.mm`` /
``torch.bmm`` with ``out_dtype=torch.float32``), then the f32 epilogue
and one cast -- the product is never rounded to bf16 before the
epilogue; everywhere else :func:`repro_torch.kernels.ref.
matmul_fused_ref` (``torch.matmul`` on f32 operands, the same epilogue),
which on the CPU is exact for bf16 operands as well.

``schedule="auto"`` consults the autotuner (``repro_torch.tune``): the
(shape bucket, dtype, backend, epilogue) winner comes from the on-disk
cache when present, otherwise from a search, analytic on the CPU and
measured on the card (``"cuda"`` is the backend of a CUDA tensor).  The
winner may be ``"xla"``, the library call, where it measures faster.
"""
from __future__ import annotations

import functools

import torch

from .ref import apply_epilogue_ref, matmul_fused_ref
from .sfc_matmul import sfc_matmul_batched_cuda, sfc_matmul_cuda

__all__ = ["sfc_matmul", "sfc_matmul_batched", "library_matmul"]


@functools.cache
def _check_mm_out_dtype() -> None:
    """The bf16-in, f32-out GEMM needs ``aten::mm.dtype`` and
    ``aten::bmm.dtype`` on CUDA; a torch without them raises here, on
    the first call, instead of computing another baseline."""
    for op in ("aten::mm.dtype", "aten::bmm.dtype"):
        if not torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA"):
            raise RuntimeError(
                f"torch {torch.__version__} has no CUDA kernel for {op}: "
                f"the 'xla' baseline (bf16 GEMM, f32 output) cannot run")


def library_matmul(a: torch.Tensor, b: torch.Tensor, bias=None,
                   activation: str = "none", residual=None,
                   out_dtype=None) -> torch.Tensor:
    """The ``schedule="xla"`` GEMM, ``(..., M, K) @ (..., K, N)`` with
    the fused epilogue: on CUDA with bf16 operands a bf16 GEMM with f32
    output, then the epilogue in f32 and one cast to ``out_dtype``
    (default ``a.dtype``); otherwise :func:`matmul_fused_ref`."""
    if not (a.is_cuda and a.dtype == b.dtype == torch.bfloat16):
        return matmul_fused_ref(a, b, bias=bias, activation=activation,
                                residual=residual, out_dtype=out_dtype)
    _check_mm_out_dtype()
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if a.dim() == 2:
        acc = torch.mm(a, b, out_dtype=torch.float32)
    else:
        acc = torch.bmm(a.reshape(-1, m, k), b.reshape(-1, k, n),
                        out_dtype=torch.float32).reshape(*a.shape[:-2], m, n)
    return apply_epilogue_ref(acc, bias, activation, residual,
                              out_dtype or a.dtype)


def _resolve_auto(a: torch.Tensor, m: int, n: int, k: int,
                  batched: bool = False, objective: str = "time",
                  has_bias: bool = False, activation: str = "none",
                  has_residual: bool = False, comm=None):
    """Map schedule="auto" to a concrete (schedule, blocks, prefetch, g)
    for operand ``a``'s dtype and device (``comm``: the mesh keyspace).

    The epilogue shape keys the tuner (a fused epilogue removes whole
    passes from the traffic model).  The winner's DVFS point
    (``TuneConfig.f_scale``) is dropped here: it parameterises scoring
    and energy accounting (``repro_torch.tune.resolved_f_scale``), never
    the launch.  Imported lazily: the tuner imports this module to
    measure."""
    from repro_torch.tune import EpilogueSpec, resolve_config

    ep = EpilogueSpec(bias=has_bias, activation=activation,
                      residual=has_residual)
    cfg = resolve_config(int(m), int(n), int(k), a.dtype,
                         backend="cuda" if a.is_cuda else "cpu",
                         batched=batched, objective=objective,
                         epilogue=None if ep.is_noop else ep, comm=comm)
    return cfg.schedule, cfg.bm, cfg.bn, cfg.bk, cfg.use_prefetch, cfg.g


def sfc_matmul(a: torch.Tensor, b: torch.Tensor, *, schedule: str = "morton",
               bm: int = 128, bn: int = 128, bk: int = 128, out_dtype=None,
               use_prefetch: bool = True, g: int = 0,
               objective: str = "time", bias=None,
               activation: str = "none", residual=None,
               comm=None) -> torch.Tensor:
    """C = act(A @ B + bias) + residual, tiles visited in ``schedule``
    order.  ``bias`` (N,), ``activation`` in {none, relu, gelu, silu}
    and ``residual`` (M, N) form the fused epilogue, applied to the f32
    accumulator before one cast to ``out_dtype`` (default ``a.dtype``).
    ``schedule="auto"`` resolves (schedule, blocks, prefetch, g) through
    the tuner under ``objective`` ("time", "energy" or "edp"; ignored
    for explicit schedules) and ``comm``, the ``CommSpec`` of the
    collective the output feeds on a mesh (None: the single-device keys).
    """
    if schedule == "auto":
        schedule, bm, bn, bk, use_prefetch, g = _resolve_auto(
            a, a.shape[0], b.shape[1], a.shape[1], objective=objective,
            has_bias=bias is not None, activation=activation,
            has_residual=residual is not None, comm=comm)
    if schedule == "xla":
        return library_matmul(a, b, bias=bias, activation=activation,
                              residual=residual, out_dtype=out_dtype)
    return sfc_matmul_cuda(a, b, schedule=schedule, bm=bm, bn=bn, bk=bk,
                           out_dtype=out_dtype, use_prefetch=use_prefetch,
                           g=g, bias=bias, activation=activation,
                           residual=residual)


def sfc_matmul_batched(a: torch.Tensor, b: torch.Tensor, *,
                       schedule: str = "morton", bm: int = 128,
                       bn: int = 128, bk: int = 128, out_dtype=None,
                       use_prefetch: bool = True, per_element: bool = False,
                       g: int = 0, objective: str = "time", bias=None,
                       activation: str = "none", residual=None) -> torch.Tensor:
    """Einsum ``bij,bjk->bik`` with SFC tile traversal per batch element.

    ``a`` (..., M, K) and ``b`` (..., K, N) have identical leading dims,
    flattened into one batch axis for the kernel and restored on return.
    ``bias`` (N,) is shared across batch elements; ``residual`` matches
    the (..., M, N) output; both ride the fused epilogue.
    ``per_element=True`` runs one B1 launch per element instead of the
    batched kernel; the two agree bit for bit on the card.
    ``schedule="auto"`` resolves through the tuner's batched keyspace,
    keyed on the per-element GEMM shape and the epilogue.
    """
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"bad batched GEMM operands {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    lead = a.shape[:-2]
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if residual is not None and residual.shape != (*lead, m, n):
        raise ValueError(f"residual shape {tuple(residual.shape)} != "
                         f"{(*lead, m, n)}")
    if schedule == "auto":
        schedule, bm, bn, bk, use_prefetch, g = _resolve_auto(
            a, m, n, k, batched=True, objective=objective,
            has_bias=bias is not None, activation=activation,
            has_residual=residual is not None)
    if schedule == "xla":
        return library_matmul(a, b, bias=bias, activation=activation,
                              residual=residual, out_dtype=out_dtype)
    a3 = a.reshape(-1, m, k)
    b3 = b.reshape(-1, k, n)
    res3 = residual.reshape(-1, m, n) if residual is not None else None
    kw = dict(schedule=schedule, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
              use_prefetch=use_prefetch, g=g, bias=bias,
              activation=activation)
    if per_element:
        if a3.shape[0] == 0:
            raise ValueError(f"empty GEMM batch {tuple(a.shape)}")
        out = torch.stack([
            sfc_matmul_cuda(a3[i], b3[i],
                            residual=res3[i] if res3 is not None else None,
                            **kw)
            for i in range(a3.shape[0])])
    else:
        out = sfc_matmul_batched_cuda(a3, b3, residual=res3, **kw)
    return out.reshape(*lead, m, n)

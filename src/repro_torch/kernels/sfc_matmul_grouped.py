"""Grouped SFC GEMM over a moe layer's experts (B5): the wrapper of the
CUDA kernel ``csrc/sfc_matmul_grouped.cu`` and its plain version.

The routed rows of a moe layer, sorted by expert, are one matrix ``a``
(R, K) whose rows ``[offsets[e], offsets[e + 1])`` go to expert e;
``offsets`` (E + 1,) int32 lives on the device (a cumsum of the counts),
so the host never learns the counts.  For each segment the kernel computes
``a_e @ w[e]``, or, gated, ``silu(a_e @ w[e]) * (a_e @ w3[e])`` (the
SwiGLU's up-projection and gate in one pass over ``a_e``), summed in f32
and cast once.  One launch covers every expert: its grid covers the worst
case and empty tiles exit; untouched experts' weights are never read.
Inside an expert the output tiles follow the curve's order on that
expert's tile grid (:func:`grouped_tables`).  The row tile is 8 rows
where every segment holds at most 8 (a decode step: ``seg_max``, the
caller's bound, is the token count) and 64 otherwise (a prefill chunk).

CUDA tensors launch the kernel or raise; CPU tensors take
:func:`sfc_matmul_grouped_plain`.  There is no fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.schedule import grid_schedule
from repro_torch.kernels import _build, launch_counts

__all__ = ["sfc_matmul_grouped", "sfc_matmul_grouped_plain",
           "grouped_tables", "grouped_row_tile", "grouped_launches"]

# kernel launches made by sfc_matmul_grouped (CPU calls are not counted)
grouped_launches = 0
launch_counts.register(__name__, "grouped_launches")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"sfc_matmul_grouped_launch": (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    ctypes.c_int)}
_BN = 128        # output columns of a tile (csrc: 128, 8 warps x 16)
_MAX_E = 1024    # experts a launch takes (csrc: kMaxE)
_TABLES: dict[tuple, torch.Tensor] = {}


def grouped_row_tile(seg_max: int) -> int:
    """Rows of an output tile: 8 where no segment holds more, else 64."""
    return 8 if seg_max <= 8 else 64


def grouped_tables(schedule: str, mt_max: int, nt: int,
                   device=None) -> torch.Tensor:
    """The (sum_mt mt * nt, 2) int32 tile orders of the mt x nt grids, mt
    = 1 .. ``mt_max``, concatenated (the grid of mt rows starts at entry
    ``nt * mt * (mt - 1) / 2``), each ``grid_schedule(schedule, mt, nt)``;
    cached per device."""
    key = (schedule, mt_max, nt, str(device))
    tab = _TABLES.get(key)
    if tab is None:
        tab = torch.from_numpy(np.concatenate(
            [grid_schedule(schedule, mt, nt) for mt in range(1, mt_max + 1)]
        ).astype(np.int32)).to(device).contiguous()
        _TABLES[key] = tab
    return tab


def sfc_matmul_grouped_plain(a, w, offsets, *, w3=None, out_dtype=None):
    """B5's arithmetic in plain PyTorch: per expert, the f32 product of its
    rows (and, gated, ``silu(g) * u`` in f32), then one cast."""
    out_dtype = out_dtype or a.dtype
    off = offsets.tolist()
    out = torch.empty(a.shape[0], w.shape[2], dtype=out_dtype,
                      device=a.device)
    for e in range(w.shape[0]):
        lo, hi = off[e], off[e + 1]
        if hi <= lo:
            continue
        ae = a[lo:hi].float()
        acc = ae @ w[e].float()
        if w3 is not None:
            acc = F.silu(acc) * (ae @ w3[e].float())
        out[lo:hi] = acc.to(out_dtype)
    return out


def sfc_matmul_grouped(a: torch.Tensor, w: torch.Tensor,
                       offsets: torch.Tensor, *, seg_max: int, w3=None,
                       schedule: str = "morton",
                       out_dtype=None) -> torch.Tensor:
    """(R, N) = each segment of ``a`` (R, K) times its expert's ``w[e]``
    (E, K, N) (gated by ``w3[e]``: ``silu(a_e w[e]) * (a_e w3[e])``).
    ``offsets`` (E + 1,) int32 on a's device: expert e's rows are
    ``[offsets[e], offsets[e + 1])``; ``seg_max`` bounds a segment's rows
    (it picks the row tile, :func:`grouped_row_tile`); ``schedule`` the
    curve of each expert's tiles.  CUDA: bf16 operands, K and N multiples
    of 8; ``out_dtype`` bf16 or f32 (default a's)."""
    global grouped_launches
    out_dtype = out_dtype or a.dtype
    r, k = a.shape
    e, k2, n = w.shape
    if k2 != k or offsets.shape != (e + 1,) or (
            w3 is not None and w3.shape != w.shape):
        raise ValueError(f"bad grouped GEMM operands a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}, offsets {tuple(offsets.shape)}"
                         + ("" if w3 is None else f", w3 {tuple(w3.shape)}"))
    if a.device.type == "cpu":
        return sfc_matmul_grouped_plain(a, w, offsets, w3=w3,
                                        out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_matmul_grouped runs on cuda (or the plain "
                         f"version on cpu), got {a.device}")
    if r == 0:
        return torch.empty(0, n, dtype=out_dtype, device=a.device)
    ops = [("a", a), ("w", w), ("w3", w3)]
    if any(t is not None and t.dtype != torch.bfloat16 for _, t in ops):
        raise TypeError("the grouped kernel takes bf16 operands")
    if out_dtype not in _DTYPE_CODE or offsets.dtype != torch.int32:
        raise TypeError(f"out_dtype {out_dtype}, offsets {offsets.dtype}: "
                        f"want f32/bf16 and int32")
    if k % 8 or n % 8 or e > _MAX_E:
        raise ValueError(f"the grouped kernel takes K and N in multiples of "
                         f"8 and at most {_MAX_E} experts, got K {k}, N {n}, "
                         f"E {e}")
    for name, t in ops + [("offsets", offsets)]:
        if t is None:
            continue
        if t.device != a.device or not t.is_contiguous() or (
                t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned on {a.device}")
    bm = grouped_row_tile(seg_max)
    nt = -(-n // _BN)
    tab = grouped_tables(schedule, -(-min(seg_max, r) // bm), nt, a.device)
    out = torch.empty(r, n, dtype=out_dtype, device=a.device)
    lib = _build.load("sfc_matmul_grouped", _SIGNATURES)
    err = lib.sfc_matmul_grouped_launch(
        a.data_ptr(), w.data_ptr(), w3.data_ptr() if w3 is not None else None,
        offsets.data_ptr(), tab.data_ptr(), out.data_ptr(), r, e, k, n,
        _DTYPE_CODE[out_dtype], int(bm == 8),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sfc_matmul_grouped kernel launch failed: "
                           f"cudaError {err}")
    grouped_launches += 1
    return out

"""Paged decode attention: the wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (port of
``repro.kernels.paged_attention.paged_decode_attention_pallas``).

One query token per decode slot attends to that slot's KV pages,
resolved through its block table of physical pool rows.  CUDA tensors
launch the kernel or raise; CPU tensors take the plain version
:func:`repro_torch.kernels.ref.paged_decode_attention_ref`.  There is
no fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention_cuda", "launches"]

# kernel launches made by paged_decode_attention_cuda (CPU calls are not
# counted)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"paged_attention_launch": (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                phys_tables: torch.Tensor,
                                cur_pos) -> torch.Tensor:
    """q: (B, H, dh); k_pages/v_pages: (R, page_size, Hkv, dh) physical
    pool (last row reserved zero); phys_tables: (B, max_pages) int32
    physical rows; cur_pos: newest position, a scalar (int or 0-d
    tensor, broadcast to every slot) or a (B,) vector.  Returns
    (B, H, dh) in the cache dtype.  Head counts come from the operands."""
    global launches
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    b, h, dh = q.shape
    _, page_size, hkv, dh2 = k_pages.shape
    if dh != dh2 or h % hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    if phys_tables.dim() != 2 or phys_tables.shape[0] != b:
        raise ValueError(f"phys_tables {tuple(phys_tables.shape)} is not "
                         f"({b}, max_pages)")
    dev = q.device
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, phys_tables,
                                          cur_pos)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention_cuda runs on cuda (or the "
                         f"plain version on cpu), got {dev}")
    if q.dtype not in _DTYPE_CODE or not (
            q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"q and pages must share a float32/bfloat16 dtype, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if phys_tables.dtype != torch.int32:
        raise TypeError(f"phys_tables must be int32, got {phys_tables.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("phys_tables", phys_tables)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    pos = torch.as_tensor(cur_pos, device=dev).to(torch.int32).reshape(-1)
    if pos.numel() not in (1, b):
        raise ValueError(f"cur_pos must be a scalar or ({b},), got "
                         f"{pos.numel()} values")
    pos = pos.expand(b).contiguous()
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _SIGNATURES)
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        phys_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, h, hkv, dh, page_size, phys_tables.shape[1],
        1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out

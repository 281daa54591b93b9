"""Plain PyTorch versions of the SFC GEMMs, their epilogue and paged
decode attention (port of ``repro.kernels.ref``).

They are the CPU path of the kernel wrappers, the yardstick that
``chip_smoke.py`` holds each CUDA kernel against on the card, and, for
``matmul_fused_ref`` and ``matmul_batched_fused_ref``, the
``schedule="xla"`` library baselines.  On the
card a float32 yardstick needs ``torch.backends.cuda.matmul.allow_tf32 =
False`` (the PyTorch default, which ``chip_smoke.py`` sets explicitly).
"""
from __future__ import annotations

import math

import torch

__all__ = ["ACTIVATIONS", "apply_activation", "apply_epilogue_ref",
           "matmul_ref", "matmul_batched_ref", "matmul_fused_ref",
           "matmul_batched_fused_ref", "matmul_blocked_ref",
           "paged_decode_attention_ref"]

# epilogue activations the fused kernel supports
ACTIVATIONS = ("none", "relu", "gelu", "silu")

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def apply_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Elementwise activation of the fused epilogue; gelu is the tanh
    approximation, as in the reference and in the CUDA kernel."""
    if activation == "none":
        return x
    if activation == "relu":
        return torch.clamp_min(x, 0)
    if activation == "gelu":
        return x * (0.5 * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + 0.044715 * (x ** 3)))))
    if activation == "silu":
        return x * torch.sigmoid(x)
    raise ValueError(
        f"unknown activation {activation!r}; choose from {ACTIVATIONS}")


def apply_epilogue_ref(acc: torch.Tensor, bias=None, activation: str = "none",
                       residual=None, out_dtype=None) -> torch.Tensor:
    """out = act(acc + bias) + residual, computed in f32, then one cast."""
    acc = acc.float()
    if bias is not None:
        acc = acc + bias.float()
    acc = apply_activation(acc, activation)
    if residual is not None:
        acc = acc + residual.float()
    return acc.to(out_dtype) if out_dtype is not None else acc


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """f32-accumulated matmul, the semantics every GEMM kernel matches."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def matmul_batched_ref(a: torch.Tensor, b: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """f32-accumulated batched matmul (``bij,bjk->bik`` over any leading
    dims), the semantics ``sfc_matmul_batched`` matches."""
    return matmul_ref(a, b, out_dtype)


def matmul_fused_ref(a: torch.Tensor, b: torch.Tensor, bias=None,
                     activation: str = "none", residual=None,
                     out_dtype=None) -> torch.Tensor:
    """dot -> bias -> activation -> residual -> cast, f32 throughout."""
    out_dtype = out_dtype or a.dtype
    acc = torch.matmul(a.float(), b.float())
    return apply_epilogue_ref(acc, bias, activation, residual, out_dtype)


def matmul_batched_fused_ref(a: torch.Tensor, b: torch.Tensor, bias=None,
                             activation: str = "none", residual=None,
                             out_dtype=None) -> torch.Tensor:
    """Batched ``matmul_fused_ref``; bias (N,) broadcasts over all leading
    dims, residual matches the (..., M, N) output shape."""
    return matmul_fused_ref(a, b, bias, activation, residual, out_dtype)


def matmul_blocked_ref(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
                       bk: int, order, out_dtype=None) -> torch.Tensor:
    """Loop-nest oracle that accumulates block by block in the given
    output tile ``order``: the schedule changes the result by f32
    addition order at most (k order is fixed per tile)."""
    out_dtype = out_dtype or a.dtype
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"bad GEMM operands {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    kt = k // bk
    out = torch.zeros(m, n, dtype=torch.float32, device=a.device)
    for (i, j) in order:
        i, j = int(i), int(j)
        acc = torch.zeros(bm, bn, dtype=torch.float32, device=a.device)
        for kk in range(kt):
            ab = a[i * bm:(i + 1) * bm, kk * bk:(kk + 1) * bk]
            bb = b[kk * bk:(kk + 1) * bk, j * bn:(j + 1) * bn]
            acc += torch.matmul(ab.float(), bb.float())
        out[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] = acc
    return out.to(out_dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               phys_tables: torch.Tensor,
                               cur_pos) -> torch.Tensor:
    """Gather-then-softmax paged decode attention.

    q: (B, H, dh); k_pages/v_pages: (R, page_size, Hkv, dh) physical
    pool whose last row is the reserved zero row; phys_tables:
    (B, max_pages) physical rows; cur_pos: newest valid position, a
    scalar or a (B,) vector.  Scores are taken in the cache dtype and
    widened to f32, and the softmax weights are cast back to the value
    dtype before P.V, exactly as the reference does.
    """
    b, h, dh = q.shape
    _, page_size, hkv, _ = k_pages.shape
    g = h // hkv
    max_pages = phys_tables.shape[1]
    span = max_pages * page_size
    idx = phys_tables.long()
    k = k_pages[idx].reshape(b, span, hkv, dh)
    v = v_pages[idx].reshape(b, span, hkv, dh)
    pos = torch.as_tensor(cur_pos, device=q.device).to(torch.int64)
    pos = pos.reshape(-1).expand(b)
    valid = torch.arange(span, device=q.device)[None, :] <= pos[:, None]
    qg = q.reshape(b, hkv, g, dh)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(dh))
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v)
    return out.reshape(b, h, dh)

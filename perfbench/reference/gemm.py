"""Plain PyTorch reference of the locality study's batched GEMM: C = A @ B
per batch element, float32 with TF32 off (the configuration's
precision).  ``precision="tf32"`` is the control: the same product with
TF32 on, the nearest precision below float32 on this card."""
from __future__ import annotations

import torch

__all__ = ["bmm", "rel_error"]


@torch.no_grad()
def bmm(a: torch.Tensor, b: torch.Tensor, precision: str = "f32"):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return torch.bmm(a.float(), b.float())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@torch.no_grad()
def rel_error(c: torch.Tensor, ref: torch.Tensor) -> float:
    """max |C - ref| over max |ref|; not finite anywhere -> inf."""
    diff = (c.float() - ref).abs().max()
    if not bool(torch.isfinite(c).all()):
        return float("inf")
    return float(diff / ref.abs().max().clamp(min=1e-30))

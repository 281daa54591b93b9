"""Space-filling curve index arithmetic (port of ``repro.core.curves``).

Morton (Z-order) en/decoding uses Raman--Wise dilation/contraction: a
constant sequence of shift+mask operations on 16-bit coordinates.
Hilbert en/decoding is the iterative quadrant-rotation scan, oriented
as in the paper's Table I (quadrant serials (0,0)=0, (0,1)=1, (1,1)=2,
(1,0)=3).

The ``*_py`` functions work on Python ints and generate the host-side
schedule tables.  The tensor functions work elementwise on integer
tensors (held in int64, values below 2**32) and give the plain version
of the SFC GEMM's closed-form tile decode; the CUDA kernel carries the
same bit operations (``kernels/csrc/sfc_matmul.cu``).
"""
from __future__ import annotations

import torch

__all__ = [
    "dilate16", "contract32", "morton_encode", "morton_decode",
    "hilbert_encode", "hilbert_decode",
    "morton_encode_py", "morton_decode_py",
    "hilbert_encode_py", "hilbert_decode_py",
    "morton_index_cost_ops", "hilbert_index_cost_ops",
]


# ---------------------------------------------------------------------------
# Tensor versions (elementwise on integer tensors)
# ---------------------------------------------------------------------------

def dilate16(x: torch.Tensor) -> torch.Tensor:
    """Dilate a 16-bit integer: abcd -> 0a0b0c0d."""
    x = x.to(torch.int64) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def contract32(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dilate16` (keeps even-position bits)."""
    x = x.to(torch.int64) & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def morton_encode(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Morton index of (y, x) with y as the major coordinate."""
    return (dilate16(y) << 1) | dilate16(x)


def morton_decode(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`morton_encode`: d -> (y, x)."""
    d = d.to(torch.int64) & 0xFFFFFFFF
    return contract32(d >> 1), contract32(d)


def hilbert_encode(y: torch.Tensor, x: torch.Tensor,
                   order: int) -> torch.Tensor:
    """Hilbert index of (y, x) on a 2**order square grid."""
    # the scan's "x" is our major coordinate y (paper orientation)
    xx = y.to(torch.int64)
    yy = x.to(torch.int64)
    d = torch.zeros_like(xx)
    for i in range(order):
        s = 1 << (order - 1 - i)
        rx = ((xx & s) > 0).to(torch.int64)
        ry = ((yy & s) > 0).to(torch.int64)
        d = d + s * s * ((3 * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        xx_f = torch.where(flip, s - 1 - xx, xx)
        yy_f = torch.where(flip, s - 1 - yy, yy)
        xx = torch.where(swap, yy_f, xx_f)
        yy = torch.where(swap, xx_f, yy_f)
    return d


def hilbert_decode(d: torch.Tensor,
                   order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`hilbert_encode`: d -> (y, x)."""
    t = d.to(torch.int64)
    xx = torch.zeros_like(t)
    yy = torch.zeros_like(t)
    for i in range(order):
        s = 1 << i
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        swap = ry == 0
        flip = swap & (rx == 1)
        xx_f = torch.where(flip, s - 1 - xx, xx)
        yy_f = torch.where(flip, s - 1 - yy, yy)
        xx = torch.where(swap, yy_f, xx_f) + s * rx
        yy = torch.where(swap, xx_f, yy_f) + s * ry
        t = t // 4
    return xx, yy  # swapped roles (see hilbert_encode): scan-x is our y


# ---------------------------------------------------------------------------
# Python-int versions (host-side schedule generation)
# ---------------------------------------------------------------------------

def _dilate16_py(x: int) -> int:
    x &= 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _contract32_py(x: int) -> int:
    x &= 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def morton_encode_py(y: int, x: int) -> int:
    return (_dilate16_py(y) << 1) | _dilate16_py(x)


def morton_decode_py(d: int) -> tuple[int, int]:
    return _contract32_py(d >> 1), _contract32_py(d)


def hilbert_encode_py(y: int, x: int, order: int) -> int:
    y, x = x, y  # paper Table I orientation (see hilbert_encode)
    d = 0
    s = 1 << (order - 1)
    while s > 0:
        rx = 1 if (x & s) > 0 else 0
        ry = 1 if (y & s) > 0 else 0
        d += s * s * ((3 * rx) ^ ry)
        if ry == 0:
            if rx == 1:
                x = s - 1 - x
                y = s - 1 - y
            x, y = y, x
        s //= 2
    return d


def hilbert_decode_py(d: int, order: int) -> tuple[int, int]:
    x = y = 0
    t = d
    s = 1
    while s < (1 << order):
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        if ry == 0:
            if rx == 1:
                x = s - 1 - x
                y = s - 1 - y
            x, y = y, x
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y  # paper Table I orientation (see hilbert_encode)


# ---------------------------------------------------------------------------
# Index-computation cost (paper claim 1: curves trade index work for locality)
# ---------------------------------------------------------------------------

def morton_index_cost_ops() -> int:
    """Static op count of one Morton (y,x)->d translation (paper Table cost).

    Two dilations (4 shift + 5 mask + 4 or each) + 1 shift + 1 or.
    """
    return 2 * (4 + 5 + 4) + 2


def hilbert_index_cost_ops(order: int) -> int:
    """Approximate op count of one Hilbert translation: linear in bits."""
    per_bit = 14  # cmp/mask/select/arith per bit-pair in the scan loop
    return order * per_bit

"""Blocked SFC storage layouts (port of ``repro.core.layout``; paper §II
applied to linear memory), on tensors.

Two granularities:

* **Tile-level**: a matrix is cut into (bm, bn) tiles and the tiles are
  stored contiguously in curve order, so consecutive curve steps read
  contiguous device memory.
* **Element-level** (paper-faithful): every element is placed at its
  Morton/Hilbert serial index in a flat array.

Both directions are gathers or scatters with host-precomputed
permutations (numpy, as in the reference), applied on the tensor's own
device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .curves import hilbert_encode, morton_encode
from .schedule import grid_schedule, is_pow2

__all__ = [
    "tile_permutation",
    "to_blocked",
    "from_blocked",
    "element_permutation",
    "to_element_order",
    "from_element_order",
]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tile_permutation(rows: int, cols: int, schedule: str) -> np.ndarray:
    """Permutation p of length rows*cols: p[t] = row-major tile id of the
    t-th tile in curve order."""
    order = grid_schedule(schedule, rows, cols)
    return (order[:, 0] * cols + order[:, 1]).astype(np.int32)


def _index(perm: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(perm.astype(np.int64)).to(device)


def to_blocked(x: torch.Tensor, bm: int, bn: int,
               schedule: str = "morton") -> torch.Tensor:
    """(M, N) -> (T, bm, bn) tiles in curve-order storage (pads to tiles)."""
    m, n = x.shape
    mt, nt = _ceil_div(m, bm), _ceil_div(n, bn)
    pm, pn = mt * bm - m, nt * bn - n
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    tiles = x.reshape(mt, bm, nt, bn).permute(0, 2, 1, 3).reshape(
        mt * nt, bm, bn)
    return tiles[_index(tile_permutation(mt, nt, schedule), x.device)]


def from_blocked(tiles: torch.Tensor, m: int, n: int, bm: int, bn: int,
                 schedule: str = "morton") -> torch.Tensor:
    """Inverse of :func:`to_blocked`, cropping padding."""
    mt, nt = _ceil_div(m, bm), _ceil_div(n, bn)
    perm = tile_permutation(mt, nt, schedule)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    tiles = tiles[_index(inv, tiles.device)]
    x = tiles.reshape(mt, nt, bm, bn).permute(0, 2, 1, 3).reshape(
        mt * bm, nt * bn)
    return x[:m, :n]


def element_permutation(n: int, schedule: str) -> np.ndarray:
    """For an n x n matrix (n a power of two): flat row-major index ->
    curve serial index.  ``a_curve[perm] = a_flat`` linearises in curve
    order."""
    if not is_pow2(n):
        raise ValueError(
            f"element-level layout requires power-of-two n, got {n}")
    idx = torch.arange(n * n, dtype=torch.int64)
    y, x = idx // n, idx % n
    if schedule == "morton":
        ser = morton_encode(y, x)
    elif schedule == "hilbert":
        ser = hilbert_encode(y, x, n.bit_length() - 1)
    elif schedule == "rowmajor":
        ser = idx
    else:
        raise ValueError(f"unsupported element schedule {schedule!r}")
    return ser.numpy().astype(np.int64)


def to_element_order(x: torch.Tensor, schedule: str) -> torch.Tensor:
    """(n, n) -> flat (n*n,) tensor in curve element order (paper-faithful)."""
    n = x.shape[0]
    ser = _index(element_permutation(n, schedule), x.device)
    flat = x.reshape(-1)
    out = torch.zeros_like(flat)
    out[ser] = flat
    return out


def from_element_order(flat: torch.Tensor, n: int,
                       schedule: str) -> torch.Tensor:
    ser = _index(element_permutation(n, schedule), flat.device)
    return flat[ser].reshape(n, n)

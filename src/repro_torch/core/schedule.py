"""Grid traversal schedules (port of ``repro.core.schedule``).

A *schedule* is the order in which the output-tile grid of a blocked
matmul is visited.  Schedules are built host-side as read-only
``(T, 2) int32`` numpy tables, one ``(i, j)`` entry per tile; the SFC
GEMM kernel reads its tile from the table copied to device memory.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .curves import hilbert_decode, morton_decode

__all__ = [
    "SCHEDULES", "is_pow2", "schedule_extra_kwargs", "grid_schedule",
    "schedule_rowmajor", "schedule_colmajor", "schedule_morton",
    "schedule_hilbert", "schedule_peano", "schedule_supertile",
    "schedule_boustrophedon", "matmul_block_trace",
]


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def is_pow2(n: int) -> bool:
    """True for positive powers of two."""
    return n > 0 and (n & (n - 1)) == 0


def schedule_extra_kwargs(name: str, g: int = 0) -> dict:
    """grid_schedule kwargs carried by a config: the supertile factor."""
    return {"g": g} if (name == "supertile" and g) else {}


def schedule_rowmajor(rows: int, cols: int) -> np.ndarray:
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return np.stack([i.ravel(), j.ravel()], axis=1).astype(np.int32)


def schedule_colmajor(rows: int, cols: int) -> np.ndarray:
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return np.stack([i.T.ravel(), j.T.ravel()], axis=1).astype(np.int32)


def schedule_boustrophedon(rows: int, cols: int) -> np.ndarray:
    """Serpentine row-major: even rows left->right, odd rows right->left."""
    out = []
    for i in range(rows):
        js = range(cols) if i % 2 == 0 else range(cols - 1, -1, -1)
        out.extend((i, j) for j in js)
    return np.asarray(out, dtype=np.int32)


def _filtered(y: torch.Tensor, x: torch.Tensor, rows: int,
              cols: int) -> np.ndarray:
    """The curve's points that fall inside the rows x cols grid, in
    curve order."""
    keep = (y < rows) & (x < cols)
    return torch.stack([y[keep], x[keep]], dim=1).numpy().astype(np.int32)


def schedule_morton(rows: int, cols: int) -> np.ndarray:
    """Morton order over the bounding power-of-two square, filtered
    (decoded elementwise over all of the square's indices at once)."""
    side = _ceil_pow2(max(rows, cols))
    y, x = morton_decode(torch.arange(side * side))
    return _filtered(y, x, rows, cols)


def schedule_hilbert(rows: int, cols: int) -> np.ndarray:
    """Hilbert order over the bounding power-of-two square, filtered."""
    side = _ceil_pow2(max(rows, cols))
    order = side.bit_length() - 1
    if order == 0:
        return np.asarray([[0, 0]], dtype=np.int32)
    y, x = hilbert_decode(torch.arange(side * side), order)
    return _filtered(y, x, rows, cols)


def _peano_points(k: int, fx: int = 0, fy: int = 0):
    """Peano curve on a 3^k grid (switchback construction)."""
    if k == 0:
        return [(0, 0)]
    s = 3 ** (k - 1)
    pts = []
    xs = range(3) if not fx else range(2, -1, -1)
    for jj_i, jj in enumerate(xs):
        ys = range(3) if (fy ^ (jj_i % 2)) == 0 else range(2, -1, -1)
        for ii in ys:
            sub = _peano_points(k - 1, fx ^ (ii % 2), fy ^ (jj % 2))
            pts.extend((ii * s + y, jj * s + x) for (y, x) in sub)
    return pts


def schedule_peano(rows: int, cols: int) -> np.ndarray:
    """Peano order over the bounding power-of-three square, filtered."""
    side, k = 1, 0
    while side < max(rows, cols):
        side *= 3
        k += 1
    pts = _peano_points(k)
    out = [(y, x) for (y, x) in pts if y < rows and x < cols]
    return np.asarray(out, dtype=np.int32)


def schedule_supertile(rows: int, cols: int, g: int = 2,
                       inner: str = "rowmajor") -> np.ndarray:
    """Two-level blocking: g x g supertiles row-major, ``inner`` order
    inside; partial edge supertiles are clipped to the grid."""
    inner_fn = SCHEDULES[inner] if inner != "supertile" \
        else schedule_rowmajor
    out = []
    for si in range(0, rows, g):
        for sj in range(0, cols, g):
            h = min(g, rows - si)
            w = min(g, cols - sj)
            for (di, dj) in inner_fn(h, w):
                out.append((si + di, sj + dj))
    return np.asarray(out, dtype=np.int32)


SCHEDULES = {
    "rowmajor": schedule_rowmajor,
    "colmajor": schedule_colmajor,
    "boustrophedon": schedule_boustrophedon,
    "morton": schedule_morton,
    "hilbert": schedule_hilbert,
    "peano": schedule_peano,
    "supertile": schedule_supertile,
}


@functools.lru_cache(maxsize=512)
def _grid_schedule_cached(name: str, rows: int, cols: int,
                          kw_items: tuple) -> np.ndarray:
    sched = SCHEDULES[name](rows, cols, **dict(kw_items))
    if sched.shape != (rows * cols, 2):
        raise AssertionError((name, sched.shape))
    # shared by every caller through the memo: freeze it so an in-place
    # edit cannot poison later lookups
    sched.setflags(write=False)
    return sched


def grid_schedule(name: str, rows: int, cols: int, **kw) -> np.ndarray:
    """The (T, 2) visit order of ``name`` over a rows x cols grid.

    Memoised on (name, rows, cols, kwargs); the returned array is
    read-only."""
    if name not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {name!r}; choose from {sorted(SCHEDULES)}")
    return _grid_schedule_cached(name, rows, cols, tuple(sorted(kw.items())))


def matmul_block_trace(
    order: np.ndarray, kt: int, k_inner: bool = True
) -> list[tuple[str, int, int]]:
    """Expand an output-tile schedule into the full block access trace.

    C[i,j] += A[i,k] @ B[k,j] for k in range(kt).  Returns a list of
    ``(tensor, r, c)`` accesses, the input to the locality simulator
    (:mod:`repro_torch.core.locality`).

    k_inner=True matches the GEMM kernels (k innermost for each tile);
    k_inner=False visits the full schedule per k slice (k outermost).
    """
    trace: list[tuple[str, int, int]] = []
    if k_inner:
        for (i, j) in order:
            for k in range(kt):
                trace.append(("A", int(i), int(k)))
                trace.append(("B", int(k), int(j)))
                trace.append(("C", int(i), int(j)))
    else:
        for k in range(kt):
            for (i, j) in order:
                trace.append(("A", int(i), int(k)))
                trace.append(("B", int(k), int(j)))
                trace.append(("C", int(i), int(j)))
    return trace

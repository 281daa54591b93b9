"""Mesh construction and curve placement of ranks (port of
``repro.launch.mesh``).

``make_smoke_mesh`` and ``make_production_mesh`` build a
:class:`~repro_torch.distributed.ctx.Mesh` over the ranks of the
current ``torch.distributed`` world (one rank per card under NCCL, CPU
ranks under gloo); a mesh needs ``prod(shape)`` ranks and raises on a
smaller world.  ``device_order`` lays the logical mesh along a curve
over an assumed physical 2-D grid of ranks (:func:`device_permutation`,
the rank-to-coordinate bijection), as the reference lays it over a
TPU pod's ICI torus.

:func:`link_distance` is pure numpy on the mesh's shape and is the
reference's, so the tuner's ``CommSpec`` (``launch/steps._comm_for``)
and its mesh cache keys (``comm=tp8-h2.50``) equal the reference's.
Its hop model is a TPU's 2-D ICI torus with wraparound; it does not
describe an NVSwitch node, where every pair of cards is one hop apart.
"""
from __future__ import annotations

import weakref

import numpy as np

from repro_torch.distributed.ctx import Mesh

__all__ = ["DEVICE_ORDERS", "default_torus", "device_permutation",
           "link_distance", "make_production_mesh", "make_smoke_mesh",
           "mesh_chips", "mesh_device_order"]

# every supported device_order; anything else is a ValueError
DEVICE_ORDERS = ("rowmajor", "hilbert", "morton")

# which curve a mesh was built under, so link_distance(mesh) scores the
# embedding that actually ran.  Weak: meshes die, the record follows.
_MESH_DEVICE_ORDER: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _check_order(order: str) -> None:
    if order not in DEVICE_ORDERS:
        raise ValueError(
            f"unknown device_order {order!r}; supported orders: "
            f"{', '.join(DEVICE_ORDERS)}")


def _record_device_order(mesh, order: str):
    try:
        _MESH_DEVICE_ORDER[mesh] = order
    except TypeError:  # non-weakref-able mesh stand-ins (tests)
        pass
    return mesh


def mesh_device_order(mesh) -> str:
    """The ``device_order`` a mesh was built under ("rowmajor" for
    meshes built elsewhere)."""
    return _MESH_DEVICE_ORDER.get(mesh, "rowmajor")


def default_torus(n: int) -> tuple[int, int]:
    """Assumed physical 2-D grid for ``n`` chips: the near-square
    power-of-two factorisation (256 -> 16x16, 8 -> 2x4)."""
    if n < 1 or n & (n - 1):
        raise ValueError(
            f"physical torus model needs a power-of-two chip count, "
            f"got {n}")
    rows = 1 << ((n.bit_length() - 1) // 2)
    return rows, n // rows


def device_permutation(order: str, rows: int, cols: int, devices) -> list:
    """Permute ``devices`` -- physically row-major over a (rows x cols)
    grid -- so that walking the flattened logical mesh follows the named
    curve over the grid.  The visit order is
    :func:`repro_torch.core.schedule.grid_schedule`'s (the GEMM kernels'
    tables), bijection-checked: a curve that skipped or repeated a
    position would give two logical ranks one device."""
    from repro_torch.core.schedule import grid_schedule

    _check_order(order)
    devices = list(devices)
    if len(devices) != rows * cols:
        raise ValueError(
            f"{len(devices)} devices cannot tile a {rows}x{cols} torus")
    if order == "rowmajor":
        return devices
    visits = np.asarray(grid_schedule(order, rows, cols))
    in_bounds = ((visits[:, 0] >= 0) & (visits[:, 0] < rows)
                 & (visits[:, 1] >= 0) & (visits[:, 1] < cols))
    counts = np.bincount(
        visits[in_bounds, 0] * cols + visits[in_bounds, 1],
        minlength=rows * cols)
    if not in_bounds.all() or (counts != 1).any():
        raise ValueError(
            f"schedule {order!r} is not a bijection over "
            f"{rows}x{cols}: {int((~in_bounds).sum())} out of bounds, "
            f"{int((counts != 1).sum())} tiles not visited exactly once")
    grid = np.asarray(devices, dtype=object).reshape(rows, cols)
    return [grid[i, j] for (i, j) in visits]


def _torus_hops(a: np.ndarray, b: np.ndarray,
                torus: tuple[int, int]) -> np.ndarray:
    """Per-pair hop count (torus Manhattan distance with wraparound)
    between physical coordinates ``a`` and ``b``, both (N, 2)."""
    rows, cols = torus
    dr = np.abs(a[:, 0] - b[:, 0])
    dc = np.abs(a[:, 1] - b[:, 1])
    return np.minimum(dr, rows - dr) + np.minimum(dc, cols - dc)


def link_distance(mesh, *, device_order: str | None = None,
                  torus: tuple[int, int] | None = None,
                  wrap: bool = True) -> dict[str, float]:
    """Per-axis mean hops between logical ring neighbours on a TPU pod's
    2-D ICI torus (the reference's model, kept so the tuner's comm keys
    agree; an NVSwitch node has no such hop structure).

    ``mesh`` is anything with ``axis_names`` and a ``shape`` mapping.
    ``device_order`` defaults to the order the mesh was built under;
    ``torus`` to the :func:`default_torus` of the per-pod chip count.
    ``wrap=True`` includes the last->first ring step.  The ``"pod"``
    axis is reported as 0.0 hops and left out of the in-pod embedding.
    """
    from repro_torch.core.schedule import grid_schedule

    names = tuple(mesh.axis_names)
    sizes = {a: int(mesh.shape[a]) for a in names}
    if device_order is None:
        device_order = mesh_device_order(mesh)
    _check_order(device_order)
    ici_axes = tuple(a for a in names if a != "pod")
    shape = tuple(sizes[a] for a in ici_axes)
    n = int(np.prod(shape)) if shape else 1
    out = {a: 0.0 for a in names}
    if n <= 1:
        return out
    rows, cols = torus or default_torus(n)
    if rows * cols != n:
        raise ValueError(
            f"torus {rows}x{cols} does not hold {n} in-pod chips")
    if device_order == "rowmajor":
        ranks = np.arange(n)
        coords = np.stack([ranks // cols, ranks % cols], axis=1)
    else:
        coords = np.asarray(grid_schedule(device_order, rows, cols))
    multi = np.stack(np.unravel_index(np.arange(n), shape), axis=1)
    for k, axis in enumerate(ici_axes):
        if shape[k] == 1:
            continue
        nxt = multi.copy()
        nxt[:, k] = (nxt[:, k] + 1) % shape[k]
        nbr = np.ravel_multi_index(tuple(nxt.T), shape)
        hops = _torus_hops(coords, coords[nbr], (rows, cols))
        if not wrap:
            hops = hops[multi[:, k] != shape[k] - 1]
        out[axis] = float(hops.mean()) if hops.size else 0.0
    return out


def _placed_ranks(shape, axes, device_order: str, per_pod: int) -> list:
    """The world ranks in logical mesh order: the identity under
    row-major, else each pod's ranks permuted along the curve over the
    :func:`default_torus` of ``per_pod`` (placement is per pod)."""
    n = int(np.prod(shape))
    if device_order == "rowmajor":
        return list(range(n))
    pods = n // per_pod
    rows, cols = default_torus(per_pod)
    ordered = []
    for p in range(pods):
        ordered += device_permutation(
            device_order, rows, cols,
            range(p * per_pod, (p + 1) * per_pod))
    return ordered


def make_production_mesh(*, multi_pod: bool = False,
                         device_order: str = "rowmajor") -> Mesh:
    """The reference's production meshes, (16, 16) or (2, 16, 16): 256
    or 512 ranks."""
    _check_order(device_order)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = _placed_ranks(shape, axes, device_order, 256)
    return _record_device_order(Mesh(shape, axes, ranks), device_order)


def make_smoke_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), *,
                    device_order: str = "rowmajor") -> Mesh:
    """A small mesh (8 CPU ranks under gloo in the tests; one card at
    world size 1).  ``device_order`` lays the non-pod axes on the
    :func:`default_torus` of their rank count, as production."""
    _check_order(device_order)
    shape, axes = tuple(shape), tuple(axes)
    pods = shape[axes.index("pod")] if "pod" in axes else 1
    per_pod = int(np.prod(shape)) // pods
    ranks = _placed_ranks(shape, axes, device_order, per_pod)
    return _record_device_order(Mesh(shape, axes, ranks), device_order)


def mesh_chips(mesh) -> int:
    n = 1
    for s in mesh.devices.shape:
        n *= s
    return n

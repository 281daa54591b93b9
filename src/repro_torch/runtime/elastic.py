"""Elastic re-mesh planning (port of ``repro.runtime.elastic``): shrink
the data axis after node loss, then reshard from a checkpoint.

Elastic restart is a *plan + reshard*: (1) pick the largest surviving
mesh (shrink "data": gradient accumulation makes up the lost batch;
"model" and "pod" are topology-bound), (2) build the new mesh's specs,
(3) slice the checkpoint's full trees for it
(``checkpoint.restore_with_shardings``).  The reference's
``reshard_tree`` is that function here.
"""
from __future__ import annotations

import numpy as np

__all__ = ["plan_elastic_mesh"]


def plan_elastic_mesh(axis_names: tuple, axis_sizes: tuple,
                      failed_chips: int, chips_per_host: int = 4):
    """Returns (new_sizes, grad_accum_scale) after losing
    ``failed_chips``: "data" shrinks to the largest power-of-two slice
    the surviving chips hold; the other axes keep their sizes."""
    sizes = dict(zip(axis_names, axis_sizes))
    total = int(np.prod(axis_sizes))
    survivors = total - failed_chips
    other = total // sizes["data"]
    new_data = sizes["data"]
    while new_data > 1 and new_data * other > survivors:
        new_data //= 2
    if new_data * other > survivors:
        raise RuntimeError(
            f"cannot form a mesh from {survivors} surviving chips")
    scale = sizes["data"] // new_data
    new_sizes = tuple(new_data if a == "data" else sizes[a]
                      for a in axis_names)
    return new_sizes, scale

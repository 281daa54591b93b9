"""Pipeline parallelism, GPipe-style, over a mesh axis (port of
``repro.launch.pp``).

Layers are split into S contiguous stages along a mesh axis
(canonically "pod"); microbatches stream through with send/recv
hand-offs between neighbouring stages, and the bubble is the usual
(S-1)/(S-1+M).  Forward only, as the reference's.

    y = pipeline_apply(stage_fn, layer_params, x_mb, mesh, axis="pod")

* ``layer_params``: a tree whose leaves have a leading dim L (stacked
  layers), the same on every rank; rank s along ``axis`` runs stage s.
* ``x_mb``: (M, mb, ...) microbatched input, the same on every rank.
* ``stage_fn(stage_layers, x) -> y``: applies one stage's layers.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import _tree_map

__all__ = ["pipeline_apply", "split_stages"]


def split_stages(layer_params, n_stages: int):
    """Reshape stacked-layer leaves (L, ...) -> (S, L/S, ...)."""
    def one(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return x.reshape((n_stages, n // n_stages) + tuple(x.shape[1:]))

    return _tree_map(one, layer_params)


@torch.no_grad()
def pipeline_apply(stage_fn, layer_params, x_mb, mesh, axis: str = "pod"):
    """GPipe forward: returns the (M, mb, ...) outputs on every rank.

    T = M + S - 1 ticks; at tick t stage s runs microbatch t - s (if in
    range) on the activation stage s - 1 sent at tick t - 1 (stage 0 on
    the input).  The last stage's outputs are summed over ``axis`` (the
    others contribute zeros), which broadcasts them, as the reference's
    ``psum``."""
    s_count = mesh.shape[axis]
    m = x_mb.shape[0]
    sid = mesh.coord[axis]
    stage = _tree_map(lambda x: x[sid], split_stages(layer_params, s_count))
    zero = torch.zeros_like(x_mb[0])
    prev = zero
    outs = torch.zeros_like(x_mb)
    for t in range(m + s_count - 1):
        recv = mesh.shift(prev, axis)
        j = t - sid
        active = 0 <= j < m
        x_in = x_mb[min(max(j, 0), m - 1)] if sid == 0 else recv
        prev = stage_fn(stage, x_in) if active else zero
        if sid == s_count - 1 and active:
            outs[j] = prev
    return mesh.all_reduce(outs, axis)

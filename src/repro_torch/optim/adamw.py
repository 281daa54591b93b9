"""AdamW with f32 master weights and global-norm clipping (port of
``repro.optim.adamw``).

The optimizer state is a dict ``{m, v, master, count}``: ``m``, ``v``
and ``master`` are float32 trees shaped like the parameters, ``count``
a 0-d int32 tensor.  Trees are nested dicts of tensors; leaves are
visited in sorted-key order, the order ``jax.tree.leaves`` gives the
reference's dicts.

Unlike the reference's pure function, :func:`adamw_update` works in
place: ``master``, ``m``, ``v`` and the parameters themselves are
updated where they lie, and the returned trees are the objects passed
in.  At qwen3-1.7b (2.03e9 parameters) fresh f32 copies of
``master``, ``m`` and ``v`` would be ~24 GB of temporaries a step; in
place, the peak is a few leaf-sized f32 temporaries of one leaf.  A
caller that needs the old state copies it first.  The arithmetic
follows the reference's order, in float32.

:func:`adamw_update_sharded` is the same update on a mesh, ZeRO-1: each
rank holds and updates its slice of ``m``, ``v`` and ``master`` (sliced
over "data" on the first free dim "data" divides,
``distributed.sharding.zero1_spec``), then all-gathers its parameters
in their own dtype; the clipping norm sums every slice's squares once
across the mesh (:func:`sharded_global_norm`)."""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

__all__ = ["AdamWConfig", "init_opt_state", "global_norm", "adamw_update",
           "adamw_update_sharded", "sharded_global_norm", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params) -> dict:
    """Zero ``m`` and ``v``, ``master`` the parameters in f32, count 0,
    on the parameters' device."""
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "m": _tree_map(zeros, params),
        "v": _tree_map(zeros, params),
        "master": _tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _coefficients(state, cfg: AdamWConfig, gnorm, lr_fn):
    """(step, lr, clip scale, c1, c2) of the next update, on the device."""
    from .schedule import cosine_schedule

    step = state["count"] + 1
    lr = (lr_fn or (lambda s: cosine_schedule(
        s, peak_lr=cfg.peak_lr, warmup=cfg.warmup,
        total=cfg.total_steps)))(step)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    sf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                    device=sf.device), sf)
    c2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                    device=sf.device), sf)
    return step, lr, scale, c1, c2


def _update_leaf(g, m, v, w, cfg: AdamWConfig, lr, scale, c1, c2) -> None:
    """m, v and the master w updated in place from gradient g."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.to(torch.float32) * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    del g
    upd = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps))
    upd.add_(cfg.weight_decay * w)
    w.sub_(lr * upd)


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig,
                 lr_fn: Callable | None = None):
    """One AdamW step; returns ``(params, state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` (0-d f32 tensors).

    Gradients are scaled by ``min(1, clip_norm / max(norm, 1e-9))``
    (the norm over every gradient, in f32), the moments and the f32
    master are updated in place, and each parameter is overwritten with
    its master cast to the parameter's dtype.  No host sync: the step
    count, the rate and the norm stay on the device."""
    gnorm = global_norm(grads)
    step, lr, scale, c1, c2 = _coefficients(state, cfg, gnorm, lr_fn)
    for g, m, v, w, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                             tree_leaves(state["v"]),
                             tree_leaves(state["master"]),
                             tree_leaves(params)):
        _update_leaf(g, m, v, w, cfg, lr, scale, c1, c2)
        p.copy_(w)
    state["count"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def sharded_global_norm(leaves, splits, mesh) -> torch.Tensor:
    """The global norm of a tree held in pieces: ``leaves[i]`` is this
    rank's piece of leaf i, split over the mesh axes ``splits[i]`` (and
    the same on every rank along the others).  Each group's sum of
    squares is all-reduced over its axes once."""
    sums: dict[tuple, torch.Tensor] = {}
    for x, axes in zip(leaves, splits):
        s = torch.sum(torch.square(x.to(torch.float32)))
        sums[axes] = sums[axes] + s if axes in sums else s
    total = None
    for axes in sorted(sums):
        s = sums[axes]
        if axes:
            s = mesh.all_reduce(s, axes)
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update_sharded(grads, state, params, cfg: AdamWConfig, mesh,
                         zero, splits, lr_fn: Callable | None = None):
    """ZeRO-1 AdamW on a mesh.  ``grads``: this rank's gradient slices,
    leaf for leaf in ``tree_leaves`` order, already summed over the data
    axes and sliced as ``m``; ``zero[i]``: the ``(dim, axis)`` ZeRO-1
    sliced leaf i over (None: not sliced); ``splits[i]``: every axis its
    slice is split over (for the norm).  Each rank updates its slices of
    ``m``, ``v`` and ``master`` in place, then every parameter leaf is
    the all-gather of the masters' slices cast to its dtype.  Returns
    ``(params, state, metrics)`` as :func:`adamw_update`."""
    gnorm = sharded_global_norm(grads, splits, mesh)
    step, lr, scale, c1, c2 = _coefficients(state, cfg, gnorm, lr_fn)
    for g, m, v, w, p, z in zip(grads, tree_leaves(state["m"]),
                                tree_leaves(state["v"]),
                                tree_leaves(state["master"]),
                                tree_leaves(params), zero):
        _update_leaf(g, m, v, w, cfg, lr, scale, c1, c2)
        if z is None:
            p.copy_(w)
        else:
            dim, axis = z
            p.copy_(mesh.all_gather(w.to(p.dtype), axis, dim))
    state["count"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

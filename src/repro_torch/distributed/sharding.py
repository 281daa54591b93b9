"""Sharding rules (port of ``repro.distributed.sharding``): the
parameter, optimizer, batch and decode-state layouts over a mesh, and
the two conversions between a full tree and this rank's shards.

A spec is a tuple with one entry per leading dim of its leaf (missing
trailing entries: unsharded): ``None``, an axis name, or a tuple of
axis names (the dim split over their product, first axis major) -- the
reference's ``PartitionSpec`` as a plain tuple, leaf for leaf, so
``tuple(P(...))`` of the reference equals the port's spec.

Parallelism layout (the reference's):

* DP  -- batch over ("pod", "data");
* TP  -- column -> row pairs over "model" on every GEMM weight; the
  port runs attention head-local on each rank's column shards
  (``models/attention.py``), where the reference shards the query
  sequence: the same function;
* SP  -- decode KV caches sequence-sharded (``sp_attention``);
* EP  -- moe experts over "model" (padded to divisibility);
* ZeRO-1 -- m, v and the f32 master also sliced over "data" on the
  first free dim it divides.

SSM blocks are replicated.  ``shard_tree`` slices a full tree into this
rank's shards (the reference's ``device_put`` under ``to_shardings``;
``shard_leaf`` one leaf, as it is drawn); ``gather_tree`` all-gathers
the shards back into the full tree on every rank, and
``gather_to_root`` assembles it on one rank's host only, leaf by leaf
(what a checkpoint needs).
"""
from __future__ import annotations

import itertools
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from .ctx import dp_axes

__all__ = ["param_specs", "opt_state_specs", "batch_specs",
           "decode_seq_axes", "decode_state_specs",
           "paged_decode_state_specs", "zero1_spec", "shard_tree",
           "shard_leaf", "gather_tree", "gather_to_root", "tree_map_specs",
           "zero_slice"]


def _layer_specs(cfg: ArchConfig) -> dict:
    """Specs for one layer dict; leading L (stack) dim added by caller."""
    col = (None, "model")   # (d_in, d_out_sharded)
    row = ("model", None)   # (d_in_sharded, d_out)
    rep = ()
    s: dict = {"norm1": rep}
    if cfg.family in ("dense", "encoder", "vlm", "moe", "hybrid"):
        attn = {"wq": col, "wk": col, "wv": col, "wo": row}
        if cfg.qk_norm:
            attn["q_norm"] = rep
            attn["k_norm"] = rep
        s["attn"] = attn
        s["norm2"] = rep
    if cfg.family in ("dense", "encoder", "vlm", "hybrid"):
        s["mlp"] = {"w1": col, "w3": col, "w2": row}
    if cfg.family == "moe":
        s["moe"] = {
            "router": rep,
            "w1": ("model", None, None),   # (E, d, ff): expert-parallel
            "w3": ("model", None, None),
            "w2": ("model", None, None),
        }
    if cfg.family in ("ssm", "hybrid"):
        s["ssm"] = {k: rep for k in
                    ("in_proj", "out_proj", "conv_w", "A_log", "D",
                     "dt_bias", "norm")}
    if cfg.family == "hybrid":
        s["attn_out_norm"] = rep
        s["ssm_out_norm"] = rep
    return s


def _add_layer_dim(spec_tree):
    if isinstance(spec_tree, dict):
        return {k: _add_layer_dim(v) for k, v in spec_tree.items()}
    return (None,) + tuple(spec_tree)


def param_specs(cfg: ArchConfig) -> dict:
    specs: dict = {
        "layers": _add_layer_dim(_layer_specs(cfg)),
        "final_norm": (),
    }
    if cfg.vocab:
        specs["embed"] = ("model", None)
        specs["lm_head"] = (None, "model")
    if cfg.frontend:
        specs["frontend_proj"] = ()
    return specs


def zero1_spec(p: tuple, shape: tuple, mesh, axis: str = "data") -> tuple:
    """Add ZeRO-1 sharding over ``axis`` on the first divisible free dim."""
    n = mesh.shape[axis]
    parts = list(p) + [None] * (len(shape) - len(p))
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and dim % n == 0 and dim >= n:
            parts[i] = axis
            return tuple(parts)
    return tuple(parts)


def tree_map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure
    (dicts and :class:`~repro_torch.serve.state.DecodeState`; tuples
    are spec leaves)."""
    if isinstance(specs, Mapping):
        out = {k: tree_map_specs(fn, specs[k], *(t[k] for t in trees))
               for k in specs}
        layout = getattr(trees[0] if trees else specs, "layout", None)
        if layout is not None:
            from repro_torch.serve.state import DecodeState
            return DecodeState(out, layout)
        return out
    return fn(specs, *trees)


def opt_state_specs(cfg: ArchConfig, params_shapes, mesh) -> dict:
    """Specs for AdamW state {m, v, master}: param spec + ZeRO-1."""
    zero = tree_map_specs(
        lambda spec, leaf: zero1_spec(spec, tuple(leaf.shape), mesh),
        param_specs(cfg), params_shapes)
    return {"m": zero, "v": zero, "master": zero, "count": ()}


def _dp_if_divisible(dp: tuple, batch: int, mesh):
    n = 1
    for a in dp:
        n *= mesh.shape[a]
    return dp if batch % n == 0 else None


def _entry(axes):
    """One dim's spec entry for a tuple of axes, as ``PartitionSpec``
    writes it: None, a single axis by its name, or the tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def batch_specs(cfg: ArchConfig, mesh, global_batch: int) -> dict:
    dp = _entry(_dp_if_divisible(dp_axes(mesh), global_batch, mesh))
    specs = {}
    if cfg.family == "encoder":
        specs["features"] = (dp, None, None)
        specs["labels"] = (dp, None)
        return specs
    specs["tokens"] = (dp, None)
    specs["labels"] = (dp, None)
    if cfg.family == "vlm":
        specs["vision_embeds"] = (dp, None, None)
        specs["loss_mask"] = (dp, None)
    return specs


def decode_seq_axes(cfg: ArchConfig, mesh, global_batch: int) -> tuple:
    """SP axes for the decode KV cache: "model" when batch shards over
    dp; every mesh axis when it cannot (long_500k batch=1)."""
    if _dp_if_divisible(dp_axes(mesh), global_batch, mesh):
        return ("model",)
    return tuple(mesh.axis_names)


def _count(name: str) -> None:
    from repro_torch.obs.metrics import default_registry
    default_registry().counter(name).inc()


def paged_decode_state_specs(cfg: ArchConfig, mesh) -> dict:
    """Paged KV state: the pool sharded along **kv-heads** over "model"
    when divisible, so each rank holds ``n_kv_heads / model`` head
    slices of every page and the paged decode kernel runs on its local
    kv-heads with no collective inside attention.  The row (page) dim
    stays unsharded (the Morton (layer, page) interleave scatters one
    layer's rows over the pool).  Block tables and the page permutation
    are replicated.  Kv-heads that do not divide the model axis leave
    the pool replicated, counted as ``distributed.paged_kv_replicated``."""
    m = mesh.shape["model"]
    if m > 1 and cfg.n_kv_heads and cfg.n_kv_heads % m == 0:
        kv = (None, None, "model", None)
    else:
        if m > 1:
            _count("distributed.paged_kv_replicated")
        kv = ()
    return {"k_pages": kv, "v_pages": kv, "page_perm": (),
            "block_tables": ()}


def decode_state_specs(cfg: ArchConfig, mesh, global_batch: int,
                       cache_len: int) -> dict:
    """KV caches: batch over dp, **sequence over the SP axes**; SSM
    states: batch over dp, heads over model when divisible.  A
    ``cache_len`` the SP axes' product does not divide steps down to
    "model"-only SP if "model" divides it, else the cache replicates,
    counted as ``distributed.seq_shard_fallback_replicated``."""
    dp = _entry(_dp_if_divisible(dp_axes(mesh), global_batch, mesh))
    m = mesh.shape["model"]
    seq = decode_seq_axes(cfg, mesh, global_batch)
    seq_sz = 1
    for a in seq:
        seq_sz *= mesh.shape[a]
    if cache_len % seq_sz == 0:
        sspec = seq
    elif cache_len % m == 0:
        sspec = ("model",)
    else:
        _count("distributed.seq_shard_fallback_replicated")
        sspec = (None,)
    sspec = sspec if len(sspec) > 1 else sspec[0]
    s: dict = {}
    if cfg.has_attention:
        s["k"] = (None, dp, sspec, None, None)
        s["v"] = (None, dp, sspec, None, None)
        s["kv_pos"] = (sspec,)
    if cfg.has_ssm:
        hspec = "model" if cfg.ssm_heads % m == 0 else None
        s["ssm_h"] = (None, dp, hspec, None, None)
        s["ssm_conv"] = (None, dp, None, None)
    return s


def _dims(spec) -> list:
    """(dim, axes) of every sharded dim of a spec."""
    out = []
    for dim, s in enumerate(spec):
        if s is not None:
            out.append((dim, (s,) if isinstance(s, str) else tuple(s)))
    return out


def shard_leaf(spec, t, mesh):
    """This rank's shard of the full leaf ``t`` under ``spec`` (a copy,
    so it owns its storage and ``t`` may be freed)."""
    for dim, axes in _dims(spec):
        n = mesh.size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split over {axes} ({n})")
        t = t.chunk(n, dim=dim)[mesh.index(axes)]
    return t.contiguous().clone()


def shard_tree(full, specs, mesh):
    """This rank's shards of a full tree (every leaf sliced along each
    sharded dim at this rank's mesh index; copies, so the shards own
    their storage)."""
    return tree_map_specs(lambda s, t: shard_leaf(s, t, mesh), specs, full)


def _gather_leaf(spec, t, mesh):
    for dim, axes in _dims(spec):
        t = mesh.all_gather(t, axes, dim)
    return t


def gather_tree(local, specs, mesh):
    """The full tree from every rank's shards, on every rank of the
    mesh (one all-gather per sharded dim)."""
    return tree_map_specs(lambda s, t: _gather_leaf(s, t, mesh), specs,
                          local)


def _gather_leaf_to(spec, t, mesh, root: int):
    """The full leaf in host memory on the global rank ``root`` (None on
    the others): every distinct shard sent once, point to point, by the
    rank that shares ``root``'s coordinates on the axes the leaf is not
    split over, and written into the host buffer as it arrives."""
    dims = _dims(spec)
    split = [a for a in mesh.axis_names
             if any(a in axes for _, axes in dims)]
    where = dict(zip(mesh.axis_names,
                     (int(c) for c in np.argwhere(mesh.devices == root)[0])))
    is_root = mesh.rank == root
    full = None
    if is_root:
        shape = list(t.shape)
        for dim, axes in dims:
            shape[dim] *= mesh.size(axes)
        full = torch.empty(shape, dtype=t.dtype, device="cpu")
    for combo in itertools.product(*(range(mesh.shape[a]) for a in split)):
        coord = {**where, **dict(zip(split, combo))}
        owner = int(mesh.devices[tuple(coord[a] for a in mesh.axis_names)])
        if not is_root:
            if mesh.rank == owner:
                mesh.send(t, root)
            continue
        shard = t if owner == root else mesh.recv(t, owner)
        view = full
        for dim, axes in dims:
            idx = 0
            for a in mesh.axis_names:
                if a in axes:
                    idx = idx * mesh.shape[a] + coord[a]
            n = shard.shape[dim]
            view = view.narrow(dim, idx * n, n)
        view.copy_(shard)
        del shard
    return full


def gather_to_root(local, specs, mesh, root: int = 0):
    """The full tree from every rank's shards, in host memory on the
    global rank ``root`` and None on the others, one leaf at a time: no
    rank holds a full leaf on its device, and only ``root`` holds one,
    on the host.  Every rank of the mesh calls it."""
    out = tree_map_specs(lambda s, t: _gather_leaf_to(s, t, mesh, root),
                         specs, local)
    return out if mesh.rank == root else None


def zero_slice(spec, zspec):
    """``(dim, axis)`` that ZeRO-1 added to a param spec (None if none)."""
    for dim, (a, b) in enumerate(zip(tuple(zspec),
                                     tuple(spec) + (None,) * len(zspec))):
        if a is not None and b is None:
            return dim, a
    return None

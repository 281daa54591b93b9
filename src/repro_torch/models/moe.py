"""Token-choice top-k MoE, granite-3.0 style (port of ``repro.models.moe``).

Three paths:

* :func:`moe_dense`: every expert on every token, gates combined by a
  sum of one-hots; dropless, the decode path and the oracle.
* :func:`moe_capacity`: sort-based capacity dispatch (GShard style),
  ``c = max(1, int(T * k / E * capacity_factor))`` slots per expert;
  assignments past an expert's capacity drop (weight zero).
* :func:`moe_ep`: expert parallelism over a mesh's model axis: each rank
  routes its own slice of the tokens, two all-to-alls carry the buckets
  to their experts' ranks and back, and the expert GEMMs run through
  :class:`~repro_torch.models.layers.DotEngine`.

:func:`moe_ffn` picks between them as the reference does.  Under an
active mesh context the experts are sharded over the model axis
(padded to a multiple of it, :func:`padded_experts`): the dense and
capacity paths run this rank's experts and all-gather their outputs.

The router's f32 product and the expert einsums are plain products
outside any Pallas kernel in the reference (XLA); here they are torch
ops.  The dispatch writes only through unique indices (kept buckets,
or a discarded spare row), and the combine sums each token's ``k``
assignments in a fixed order, so a step is bit-equal run to run on the
card (no atomic adds).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import DotEngine, copy_to, gather, init_linear, reduce_sum, \
    scatter, tp_context

__all__ = ["init_moe", "padded_experts", "moe_dense", "moe_capacity",
           "moe_ep", "moe_ffn"]


def padded_experts(cfg, model_axis_size: int | None = None) -> int:
    """The expert count rounded up to a multiple of the model axis."""
    e = cfg.moe_experts
    if model_axis_size:
        e = -(-e // model_axis_size) * model_axis_size
    return e


def init_moe(generator, cfg, dtype=torch.float32, *, lead=(), device=None,
             model_axis_size: int | None = None):
    """The reference's expert weights, stacked on ``lead``: per stacked
    element a router (d, E) in f32 and one SwiGLU drawn once and
    repeated over the experts (w1 scaled by 1 + 0.01 e in ``dtype``),
    each element drawn on its own (no whole-stack f32 temporary).  E is
    :func:`padded_experts` of ``model_axis_size`` (the pad experts are
    never routed)."""
    d, ff = cfg.d_model, cfg.moe_dff
    e = padded_experts(cfg, model_axis_size)
    p = {"router": torch.empty((*lead, d, e), dtype=torch.float32,
                               device=device),
         "w1": torch.empty((*lead, e, d, ff), dtype=dtype, device=device),
         "w3": torch.empty((*lead, e, d, ff), dtype=dtype, device=device),
         "w2": torch.empty((*lead, e, ff, d), dtype=dtype, device=device)}
    scale = 1 + 0.01 * torch.arange(e, dtype=dtype, device=device)
    flat = {k: v.view(-1, *v.shape[len(lead):]) for k, v in p.items()}
    for i in range(flat["router"].shape[0]):
        flat["router"][i] = init_linear(generator, d, e, torch.float32,
                                        device=device)
        w1 = init_linear(generator, d, ff, dtype, device=device)
        flat["w1"][i] = w1[None] * scale[:, None, None]
        flat["w3"][i] = init_linear(generator, d, ff, dtype, device=device)
        flat["w2"][i] = init_linear(generator, ff, d, dtype, device=device)
    return p


def _one_hot(idx, n: int):
    """``F.one_hot(idx, n)``'s values as a bool comparison: the same ops
    on every device (``F.one_hot`` reads its indices' range on the host
    on the CPU and builds another graph on meta)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _router(xf, params, cfg):
    """xf: (T, d) -> (weights (T, k) f32, idx (T, k), aux loss).

    Softmax over the f32 logits (pad experts masked: a tree the
    reference padded for expert parallelism, through
    ``params_from_jax``), top-k by a stable descending sort, so ties go
    to the lower index as under ``jax.lax.top_k``; weights
    renormalised; the Switch load-balance loss E * sum_e f_e p_e with
    f_e the top-1 fractions."""
    e_real = cfg.moe_experts
    logits = xf.float() @ params["router"]
    e_pad = logits.shape[-1]
    if e_pad > e_real:
        logits = torch.cat([logits[..., :e_real],
                            logits[..., e_real:] - 1e30], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.moe_topk], idx[:, :cfg.moe_topk]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    pe = probs.mean(0)
    fe = _one_hot(idx[:, 0], e_pad).float().mean(0)
    aux = e_real * torch.sum(fe * pe)
    return w, idx, aux


def _expert_ffn(buf, params):
    """buf: (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    g = torch.einsum("ecd,edf->ecf", buf, params["w1"])
    u = torch.einsum("ecd,edf->ecf", buf, params["w3"])
    return torch.einsum("ecf,efd->ecd", F.silu(g) * u, params["w2"])


def moe_dense(x, params, cfg, engine: DotEngine):
    """Every expert on every token, combined by the gates (T, E), a sum
    of one-hots weighted by the router: x (B, S, d) -> (y, aux).  On a
    mesh this rank's experts run on every token and their outputs are
    all-gathered over the model axis."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    w, idx, aux = _router(xf, params, cfg)
    e_loc = params["w1"].shape[0]
    xe = copy_to(xf)
    y_all = gather(_expert_ffn(xe.expand(e_loc, *xf.shape), params), 0)
    e = y_all.shape[0]                                        # (E, T, d)
    gate = (_one_hot(idx, e).to(xf.dtype)
            * w[..., None].to(xf.dtype)).sum(dim=1)           # (T, E)
    y = torch.einsum("te,etd->td", gate, y_all)
    return y.reshape(b, s, d), aux


def _dispatch_indices(idx, w, e: int, capacity: int):
    """Sort-based bucket placement of the (T, k) assignments ->
    ``(bucket (T*k,), keep (T*k,), src_token (T*k,))``: each
    assignment's slot in [0, E * capacity), its rank within its expert
    (stable order of assignment) below ``capacity``, and its token.  A
    dropped assignment gets keep False and its expert's last slot."""
    t, k = idx.shape
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = torch.arange(t * k, device=idx.device)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=idx.device, dtype=sorted_e.dtype),
        side="left")
    rank = pos - seg_start[sorted_e]
    keep_sorted = rank < capacity
    bucket_sorted = sorted_e * capacity + torch.clamp(rank, max=capacity - 1)
    inv = torch.argsort(order, stable=True)
    return bucket_sorted[inv], keep_sorted[inv], pos // k


def moe_capacity(x, params, cfg, engine: DotEngine,
                 capacity_factor: float = 1.25, capacity: int | None = None):
    """Single-device capacity dispatch: x (B, S, d) -> (y, aux).

    The reference scatter-adds the kept assignments into the buckets and
    the weighted expert outputs back into the tokens.  Here each token
    is expanded over its k assignments, the buckets are written by an
    index write whose dropped entries all land on a spare row (thrown
    away), the outputs are read back through the same indices from a
    zero-padded buffer, and each token sums its k weighted outputs in
    one reduction: the same sums with no atomic add, forward or
    backward."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    e = params["router"].shape[-1]
    k = cfg.moe_topk
    c = capacity or max(1, int(t * k / e * capacity_factor))
    w, idx, aux = _router(xf, params, cfg)
    bucket, keep, _ = _dispatch_indices(idx, w, e, c)
    wf = torch.where(keep, w.reshape(-1), torch.zeros_like(w.reshape(-1)))
    slot = torch.where(keep, bucket, torch.full_like(bucket, e * c))
    xa = xf[:, None, :].expand(t, k, d).reshape(t * k, d)    # src = pos // k
    buf = xf.new_zeros((e * c + 1, d)).index_put((slot,), xa)
    # on a mesh: this rank's experts' buckets, outputs all-gathered
    out_buf = gather(_expert_ffn(scatter(buf[:e * c].reshape(e, c, d), 0),
                                 params), 0)
    out_pad = torch.cat([out_buf.reshape(e * c, d), xf.new_zeros((1, d))])
    y = (out_pad[slot] * wf[:, None].to(xf.dtype)).reshape(t, k, d).sum(1)
    return y.reshape(b, s, d), aux


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all over ``axes``; its backward is the reverse
    all-to-all (split and concat dims swapped)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return mesh.all_to_all(x, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return (mesh.all_to_all(g, axes, concat_dim, split_dim),
                None, None, None, None)


def _all_to_all(x, mesh, axes, split_dim, concat_dim):
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, mesh, axes, split_dim, concat_dim)
    return mesh.all_to_all(x, axes, split_dim, concat_dim)


def _expert_ffn_dot(buf, params, engine: DotEngine):
    """buf: (E_loc, C', d) -> (E_loc, C', d), each expert's SwiGLU as
    three ``engine.dot`` GEMMs (the silu in the up-projection's
    epilogue)."""
    outs = []
    for i in range(buf.shape[0]):
        g = engine.dot(buf[i], params["w1"][i], activation="silu")
        u = engine.dot(buf[i], params["w3"][i])
        outs.append(engine.dot(g * u, params["w2"][i]))
    return torch.stack(outs)


def moe_ep(x, params, cfg, mesh, engine: DotEngine,
           capacity_factor: float = 1.25, data_axes=("data",),
           model_axis: str = "model"):
    """Expert-parallel MoE on this rank's shards (the reference's
    ``shard_map`` body): x (B_loc, S/m, d), this rank's distinct tokens;
    ``router`` replicated, ``w1``/``w3``/``w2`` this rank's E/m experts.

    Each rank routes its tokens into (E, C, d) buckets (C from its own
    token count), an all-to-all over ``model_axis`` sends every expert's
    buckets to the rank that owns it ((E/m, m C, d)), the experts run
    through ``engine.dot``, and the reverse all-to-all brings the
    outputs back for the combine.  Returns (y (B_loc, S/m, d), aux): the
    router's load-balance loss averaged over the model axis and over
    ``data_axes`` (pass ``()`` to keep it per data shard)."""
    m = mesh.shape[model_axis]
    e_loc = params["w1"].shape[0]
    e = e_loc * m
    bl, sl, dl = x.shape
    k = cfg.moe_topk
    xf = x.reshape(-1, dl)
    tl = xf.shape[0]
    c = max(1, int(tl * k / e * capacity_factor))
    # the router is replicated but reads this rank's tokens only
    w, idx, aux = _router(xf, {"router": copy_to(params["router"])}, cfg)
    bucket, keep, _ = _dispatch_indices(idx, w, e, c)
    wf = torch.where(keep, w.reshape(-1), torch.zeros_like(w.reshape(-1)))
    slot = torch.where(keep, bucket, torch.full_like(bucket, e * c))
    xa = xf[:, None, :].expand(tl, k, dl).reshape(tl * k, dl)
    buf = xf.new_zeros((e * c + 1, dl)).index_put((slot,), xa)
    buf = _all_to_all(buf[:e * c].reshape(e, c, dl), mesh, (model_axis,),
                      0, 1)                               # (E_loc, m C, d)
    out = _expert_ffn_dot(buf, params, engine)
    out = _all_to_all(out, mesh, (model_axis,), 1, 0)     # (E, C, d)
    out_pad = torch.cat([out.reshape(e * c, dl), xf.new_zeros((1, dl))])
    y = (out_pad[slot] * wf[:, None].to(xf.dtype)).reshape(tl, k, dl).sum(1)
    aux = reduce_sum(aux, (model_axis,)) / m
    if data_axes:
        aux = reduce_sum(aux, tuple(data_axes)) / mesh.size(data_axes)
    return y.reshape(bl, sl, dl), aux


def moe_ffn(x, params, cfg, engine: DotEngine, mesh=None, impl="auto",
            model_axis="model", capacity=None):
    """The reference's dispatcher: ``impl="dense"``, or ``"auto"`` on at
    most 256 tokens (``x.shape[0] * x.shape[1]``), runs
    :func:`moe_dense`; a ``mesh`` with ``impl`` "auto" or "ep" runs
    :func:`moe_ep` under the active mesh context (``x`` replicated over
    the model axis: its sequence is split before routing and the outputs
    gathered after; the load-balance loss stays per data shard, the
    loss averages it); anything else :func:`moe_capacity` with
    ``capacity``."""
    if impl == "dense" or (impl == "auto" and x.shape[0] * x.shape[1] <= 256):
        return moe_dense(x, params, cfg, engine)
    if mesh is not None and impl in ("auto", "ep"):
        if tp_context() is None:
            raise ValueError("moe_ffn on a mesh runs under its "
                             "mesh_context (repro_torch.distributed.ctx)")
        m = mesh.shape[model_axis]
        if x.shape[1] % m:
            raise ValueError(f"expert parallelism splits the sequence over "
                             f"the {m}-way model axis: {x.shape[1]} tokens "
                             f"do not divide")
        y, aux = moe_ep(scatter(x, 1, (model_axis,)), params, cfg, mesh,
                        engine, data_axes=(), model_axis=model_axis)
        return gather(y, 1, (model_axis,)), aux
    return moe_capacity(x, params, cfg, engine, capacity=capacity)

"""Token-choice top-k MoE, granite-3.0 style (port of ``repro.models.moe``).

Two paths on one device:

* :func:`moe_dense`: every expert on every token, gates combined by a
  sum of one-hots; dropless, the decode path and the oracle.
* :func:`moe_capacity`: sort-based capacity dispatch (GShard style),
  ``c = max(1, int(T * k / E * capacity_factor))`` slots per expert;
  assignments past an expert's capacity drop (weight zero).

:func:`moe_ffn` picks between them as the reference does.  Expert
parallelism (``moe_ep``, the reference's ``mesh`` branch) waits for the
distributed slice (ROADMAP.md queue A, A15).

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

from .layers import DotEngine, init_linear

__all__ = ["init_moe", "moe_dense", "moe_capacity", "moe_ep", "moe_ffn"]


def init_moe(generator, cfg, dtype=torch.float32, *, lead=(), device=None):
    """The reference's expert weights, stacked on ``lead``: per stacked
    element a router (d, E) in f32 and one SwiGLU drawn once and
    repeated over the experts (w1 scaled by 1 + 0.01 e in ``dtype``),
    each element drawn on its own (no whole-stack f32 temporary).  The
    reference's padding of E to a multiple of the model axis serves
    expert parallelism and comes with it (ROADMAP.md queue A, A15)."""
    d, ff = cfg.d_model, cfg.moe_dff
    e = cfg.moe_experts
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
    fe = F.one_hot(idx[:, 0], e_pad).float().mean(0)
    aux = e_real * torch.sum(fe * pe)
    return w, idx, aux


def _expert_ffn(buf, params):
    """buf: (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    g = torch.einsum("ecd,edf->ecf", buf, params["w1"])
    u = torch.einsum("ecd,edf->ecf", buf, params["w3"])
    return torch.einsum("ecf,efd->ecd", F.silu(g) * u, params["w2"])


def moe_dense(x, params, cfg, engine: DotEngine):
    """Every expert on every token, combined by the gates (T, E), a sum
    of one-hots weighted by the router: x (B, S, d) -> (y, aux)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    w, idx, aux = _router(xf, params, cfg)
    e = params["w1"].shape[0]
    y_all = _expert_ffn(xf.expand(e, *xf.shape), params)     # (E, T, d)
    gate = (F.one_hot(idx, e).to(xf.dtype)
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
    e = params["w1"].shape[0]
    k = cfg.moe_topk
    c = capacity or max(1, int(t * k / e * capacity_factor))
    w, idx, aux = _router(xf, params, cfg)
    bucket, keep, _ = _dispatch_indices(idx, w, e, c)
    wf = torch.where(keep, w.reshape(-1), torch.zeros_like(w.reshape(-1)))
    slot = torch.where(keep, bucket, torch.full_like(bucket, e * c))
    xa = xf[:, None, :].expand(t, k, d).reshape(t * k, d)    # src = pos // k
    buf = xf.new_zeros((e * c + 1, d)).index_put((slot,), xa)
    out_buf = _expert_ffn(buf[:e * c].reshape(e, c, d), params)
    out_pad = torch.cat([out_buf.reshape(e * c, d), xf.new_zeros((1, d))])
    y = (out_pad[slot] * wf[:, None].to(xf.dtype)).reshape(t, k, d).sum(1)
    return y.reshape(b, s, d), aux


def moe_ep(*args, **kwargs):
    raise NotImplementedError(
        "expert parallelism (moe_ep) is not ported yet (ROADMAP.md queue A, "
        "A15)")


def moe_ffn(x, params, cfg, engine: DotEngine, mesh=None, impl="auto",
            capacity=None):
    """The reference's dispatcher: ``impl="dense"``, or ``"auto"`` on at
    most 256 tokens (``x.shape[0] * x.shape[1]``), runs
    :func:`moe_dense`; a ``mesh`` with ``impl`` "auto" or "ep" runs
    expert parallelism (raises until A15); anything else
    :func:`moe_capacity` with ``capacity``."""
    if impl == "dense" or (impl == "auto" and x.shape[0] * x.shape[1] <= 256):
        return moe_dense(x, params, cfg, engine)
    if mesh is not None and impl in ("auto", "ep"):
        return moe_ep(x, params, cfg, mesh, engine)
    return moe_capacity(x, params, cfg, engine, capacity=capacity)

"""GQA attention (port of ``repro.models.attention``): q/k/v projection
with qwen3's per-head qk-norm and RoPE, full-sequence (prefill)
attention with the reference's q-chunked exact softmax, and one-token
decode against the paged KV pool (the paged decode kernel) or against
per-slot contiguous strips, a ring of one window under SWA (plain torch
ops, as the reference's are XLA).

On a mesh (an active :func:`repro_torch.distributed.ctx.mesh_context`)
the projections are tensor-parallel (``layers.copy_to`` /
``layers.out_proj``): the forward runs attention head-local on each
rank's ``n_heads / m`` query and ``n_kv_heads / m`` kv-heads where the
heads divide the m-way model axis, and otherwise as the reference does
for any head count, sequence-parallel (:func:`_seq_parallel_attention`:
every head gathered, each rank attending its rows of every query chunk
against all keys).  The paged decode runs the kernel on each rank's
kv-head shard of the pool; the contiguous decode gathers every head and
runs the sequence-parallel online softmax over the cache's sequence
shards (``distributed.sp_attention``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention import paged_decode_attention_cuda

from .layers import DotEngine, apply_rope, copy_to, gather, init_linear, \
    init_rms, out_proj, rms_norm, scatter, tp_context

__all__ = ["init_attention", "attention", "prefill_kv",
           "decode_attention", "decode_plan", "paged_decode_attention"]


def init_attention(generator, cfg, dtype=torch.float32, *, lead=(),
                   device=None, place=None):
    """``place(name, leaf)``, when given, takes each leaf as soon as it
    is drawn and the dict holds what it returns."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kw = dict(lead=lead, device=device)
    put = place or (lambda _, t: t)
    p = {
        "wq": put("wq", init_linear(generator, d, h * dh, dtype, **kw)),
        "wk": put("wk", init_linear(generator, d, hkv * dh, dtype, **kw)),
        "wv": put("wv", init_linear(generator, d, hkv * dh, dtype, **kw)),
        "wo": put("wo", init_linear(generator, h * dh, d, dtype, **kw)),
    }
    if cfg.qk_norm:
        p["q_norm"] = put("q_norm", init_rms(dh, dtype, **kw))
        p["k_norm"] = put("k_norm", init_rms(dh, dtype, **kw))
    return p


def heads_divide(cfg, m: int) -> bool:
    """Whether both head counts divide an m-way model axis (head-local
    tensor-parallel attention)."""
    return cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0


def local_heads(cfg) -> tuple[int, int]:
    """(query heads, kv-heads) of this rank: all of them on one device,
    ``n / m`` each on a mesh's m-way model axis (both must divide)."""
    c = tp_context()
    if c is None:
        return cfg.n_heads, cfg.n_kv_heads
    m = c.tp
    if not heads_divide(cfg, m):
        raise ValueError(
            f"{cfg.name}: {cfg.n_heads} query heads and {cfg.n_kv_heads} "
            f"kv-heads do not both divide the {m}-way model axis; "
            f"head-local tensor-parallel attention needs them to")
    return cfg.n_heads // m, cfg.n_kv_heads // m


def _project_qkv(x, p, cfg, engine: DotEngine, cos, sin,
                 full_heads: bool = False):
    """q, k, v (B, S, heads, dh) after qk-norm and rope.  On a mesh the
    column shards give this rank's heads (:func:`local_heads`), or with
    ``full_heads`` (decode, no grad) every head, all-gathered."""
    b, s, _ = x.shape
    dh = cfg.d_head
    x = copy_to(x)
    q = engine.dot(x, p["wq"])
    k = engine.dot(x, p["wk"])
    v = engine.dot(x, p["wv"])
    c = tp_context()
    if full_heads and c is not None and c.tp > 1:
        q, k, v = (gather(t, -1) for t in (q, k, v))
    elif not full_heads:
        local_heads(cfg)
    q = q.reshape(b, s, -1, dh)
    k = k.reshape(b, s, -1, dh)
    v = v.reshape(b, s, -1, dh)
    if cfg.qk_norm:  # before rope, as the reference
        q = rms_norm(q, copy_to(p["q_norm"]))
        k = rms_norm(k, copy_to(p["k_norm"]))
    if cfg.rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """q: (B, Sq, H, dh), k/v: (B, Sk, Hkv, dh) -> (B, Sq, H, dh); GQA by
    grouping.  The reference's rounding points: scores in the operands'
    dtype, then f32, scaled, masked with -1e30 (``mask`` broadcasts
    against (B, Hkv, G, Sq, Sk)), softmax in f32, weights cast to
    ``v.dtype`` before the second product.  Plain torch ops, as the
    reference's are XLA's."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, sq, h, dh)


def attention(x, p, cfg, engine: DotEngine, cos, sin, *,
              q_chunk: int = 1024, residual=None, return_kv: bool = False,
              window=...):
    """Full-sequence attention (prefill).  x: (B, S, d).

    Causal iff ``cfg.causal``, sliding-window iff ``window`` (the layer's,
    :meth:`~repro_torch.models.config.ArchConfig.layer_window`; ``...``
    means ``cfg.swa_window``).
    Causal attention runs in q chunks of ``q_chunk`` rows (S must be a
    multiple): chunk i attends to keys [lo, (i + 1) * q_chunk) with an
    exact softmax, lo = 0 or the window's start aligned down to a chunk.
    ``residual`` rides the out-projection's fused epilogue;
    ``return_kv=True`` also returns the post-rope/qk-norm (k, v), what
    the decode cache stores."""
    b, s, _ = x.shape
    if window is ...:
        window = cfg.swa_window
    c = tp_context()
    if c is not None and c.tp > 1 and not heads_divide(cfg, c.tp) \
            and not return_kv:
        return _seq_parallel_attention(x, p, cfg, engine, cos, sin,
                                       q_chunk, residual, window)
    q, k, v = _project_qkv(x, p, cfg, engine, cos, sin)
    scale = 1.0 / math.sqrt(cfg.d_head)
    if not cfg.causal:
        out = _sdpa(q, k, v, None, scale)
    else:
        ch = min(q_chunk, s)
        if s % ch:
            raise ValueError(f"sequence {s} is not a multiple of q_chunk "
                             f"{ch}")
        outs = []
        for i in range(s // ch):
            qpos = torch.arange(i * ch, (i + 1) * ch, device=x.device)
            lo, hi, mask = _chunk_keys(i, ch, qpos, window)
            outs.append(_sdpa(q[:, i * ch:hi], k[:, lo:hi], v[:, lo:hi],
                              mask, scale))
        out = torch.cat(outs, dim=1)
    out = out_proj(engine, out.reshape(b, s, -1), p["wo"], residual)
    return (out, k, v) if return_kv else out


def _chunk_keys(i: int, ch: int, qpos, window):
    """(lo, hi, mask) of causal q chunk ``i`` of ``ch`` rows: it attends
    to keys [lo, (i + 1) * ch), lo = 0 or the ``window``'s start aligned
    down to a chunk; ``mask`` broadcasts against the scores of the
    query positions ``qpos``."""
    hi = (i + 1) * ch
    lo = 0
    if window is not None:
        lo = max(0, hi - ch - window + 1)
        lo = (lo // ch) * ch
    kpos = torch.arange(lo, hi, device=qpos.device)[None, :]
    mask = kpos <= qpos[:, None]
    if window is not None:
        mask &= kpos > qpos[:, None] - window
    return lo, hi, mask[None, None, None]


def _seq_parallel_attention(x, p, cfg, engine: DotEngine, cos, sin,
                            q_chunk: int, residual, window):
    """Full-sequence attention on a mesh whose m-way model axis the head
    counts do not divide: the reference's sequence-parallel core (its
    queries sharded over the model axis, head-count independent).

    The column shards of q, k and v are gathered into every head; each
    rank takes its ``ch / m`` rows of every q chunk of ``ch`` rows (each
    chunk split evenly, so every rank does 1/m of the work) and attends
    them against the chunk's keys, all heads; the outputs are gathered
    back into sequence order and this rank's columns go through the
    row-parallel out-projection.  The collectives' backward (``gather``:
    this rank's chunk; ``scatter``: an all-gather; ``copy_to``: an
    all-reduce) sums each rank's share of every gradient, so the step
    equals the one-device step.  A non-causal sequence is one chunk."""
    b, s, _ = x.shape
    ctx = tp_context()
    m, r = ctx.tp, ctx.mesh.index(ctx.model_axis)
    dh = cfg.d_head
    ch = min(q_chunk, s) if cfg.causal else s
    if s % ch or ch % m:
        raise ValueError(f"{cfg.name}: sequence {s} in q chunks of {ch} "
                         f"rows does not split over the {m}-way model "
                         f"axis")
    n, rows = s // ch, ch // m
    x = copy_to(x)
    q = gather(engine.dot(x, p["wq"]), -1)
    # k and v: every rank attends its rows against all of them, so
    # their gradients are summed over the model axis
    k = copy_to(gather(engine.dot(x, p["wk"]), -1)).reshape(b, s, -1, dh)
    v = copy_to(gather(engine.dot(x, p["wv"]), -1)).reshape(b, s, -1, dh)
    q = scatter(q.reshape(b, n, m, rows, -1), 2).reshape(b, n * rows, -1, dh)
    qpos = torch.arange(s, device=x.device).reshape(n, m, rows)[:, r]
    if cfg.qk_norm:  # before rope, as the reference
        q = rms_norm(q, copy_to(p["q_norm"]))
        k = rms_norm(k, copy_to(p["k_norm"]))
    if cfg.rope:
        q = apply_rope(q, cos[..., qpos.reshape(-1), :],
                       sin[..., qpos.reshape(-1), :])
        k = apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for i in range(n):
        lo, hi, mask = _chunk_keys(i, ch, qpos[i], window) if cfg.causal \
            else (0, s, None)
        outs.append(_sdpa(q[:, i * rows:(i + 1) * rows], k[:, lo:hi],
                          v[:, lo:hi], mask, scale))
    out = torch.cat(outs, dim=1).reshape(b, n, 1, rows, -1)
    out = scatter(gather(out, 2).reshape(b, s, -1), -1)
    return out_proj(engine, out, p["wo"], residual)


def prefill_kv(x, p, cfg, engine: DotEngine, cos, sin):
    """(k, v) for cache seeding, no attention compute."""
    _, k, v = _project_qkv(x, p, cfg, engine, cos, sin)
    return k, v


def paged_decode_attention(x, p, cfg, engine: DotEngine, k_pages, v_pages,
                           phys_tables, write_tables, cur_pos, cos, sin,
                           row_mask=None, residual=None, window=None):
    """One-token decode against the paged KV pool.

    x: (B, 1, d); k_pages/v_pages: (R, page_size, Hkv, dh) physical pool
    (last row reserved zero); phys_tables: (B, max_pages) int32 physical
    rows for this layer; write_tables: (B, max_pages) logical block
    table (-1 = unallocated); cur_pos: (B,) int positions (or a scalar);
    row_mask: (B,) bool, rows with False write nothing; ``window``: the
    layer's sliding window (None: every key up to ``cur_pos``).

    The new token's K/V is written **in place** into the pool, at
    (cur_pos // page_size, cur_pos % page_size) of each slot's page, for
    rows whose logical entry is allocated and whose row_mask is set.
    Every other row writes its location's current value back (the
    reference's gather-select-scatter, with no host sync): written rows
    own distinct pages, and rows that write back may repeat a location
    (the zero row) only with the value it already holds, so the index
    write is deterministic.  Returns (out (B, 1, d), k_pages, v_pages).

    On a mesh the pool holds this rank's kv-heads (sharded over the
    model axis) and the kernel runs on them and their query heads, with
    no collective; a pool the kv-heads do not divide is replicated, and
    every head is gathered, attended, and this rank's columns kept.
    """
    b = x.shape[0]
    page_size = k_pages.shape[1]
    max_pages = phys_tables.shape[1]
    c = tp_context()
    full = c is not None and c.tp > 1 and k_pages.shape[2] == cfg.n_kv_heads
    q, k_new, v_new = _project_qkv(x, p, cfg, engine, cos, sin,
                                   full_heads=full)

    pos = torch.as_tensor(cur_pos, device=x.device).to(torch.int64)
    pos = pos.reshape(-1).expand(b)
    page_idx = pos // page_size
    offset = pos % page_size
    # a stale position of an idle slot may point past its table: it
    # writes nothing, and the gather index is clamped
    in_table = page_idx < max_pages
    pidx = page_idx.clamp(max=max_pages - 1)[:, None]
    rows = torch.gather(phys_tables, 1, pidx)[:, 0].long()
    wmask = (torch.gather(write_tables, 1, pidx)[:, 0] >= 0) & in_table
    if row_mask is not None:
        wmask = wmask & row_mask
    sel = wmask[:, None, None]
    k_pages[rows, offset] = torch.where(sel, k_new[:, 0], k_pages[rows, offset])
    v_pages[rows, offset] = torch.where(sel, v_new[:, 0], v_pages[rows, offset])

    out = paged_decode_attention_cuda(q[:, 0].contiguous(), k_pages, v_pages,
                                      phys_tables, pos, window=window
                                      ).reshape(b, 1, -1)
    if full:
        out = _local_columns(out)
    out = out_proj(engine, out, p["wo"], residual)
    return out, k_pages, v_pages


def _local_columns(out):
    """This rank's chunk of the flattened heads (the rows of its ``wo``
    shard)."""
    m = tp_context().mesh
    return out.chunk(m.size("model"), -1)[m.index("model")]


def ring_positions(cur_pos, c: int):
    """(B, c) token position each ring entry of a row holds when the row
    writes position ``cur_pos[b]`` at entry ``cur_pos[b] % c``: entry j
    holds ``cur_pos[b] - ((cur_pos[b] - j) mod c)`` (negative: never
    written)."""
    j = torch.arange(c, device=cur_pos.device)
    return cur_pos[:, None] - torch.remainder(cur_pos[:, None] - j, c)


def decode_plan(cfg, b: int, c: int, cache_positions, write_slot, cur_pos,
                row_mask=None, device=None, window=...):
    """What every layer of one contiguous decode step shares, since it
    depends on the positions alone: ``(index, select, mask)``, the
    index of the entry each row writes in a layer's (B, C, ...) strip
    (index tensors of one entry a row, so a read gives (B, 1, ...) and
    no index is read on the host), the rows that write ((B, 1, 1, 1)
    bool, ``row_mask`` or all) and the attention mask over the C
    entries, broadcast against :func:`_sdpa`'s (B, Hkv, G, 1, C).  The
    rules are :func:`decode_attention`'s, under ``window`` (``...``:
    ``cfg.swa_window``)."""
    if window is ...:
        window = cfg.swa_window
    cur = torch.as_tensor(cur_pos, device=device).to(torch.int64)
    ws = torch.as_tensor(write_slot, device=device).to(torch.int64)
    sel = torch.ones(b, dtype=torch.bool, device=device) \
        if row_mask is None else row_mask
    if cur.dim() > 0:
        ws = ws.reshape(-1).expand(b)
        cur = cur.reshape(-1).expand(b)
        held = ring_positions(cur, c)                          # (B, C)
        valid = held >= 0
        if window is not None:
            valid &= held > cur[:, None] - window
        return (torch.arange(b, device=device)[:, None], ws[:, None]), \
            sel[:, None, None, None], valid[:, None, None, None, :]
    slots = torch.arange(c, device=device)
    held = torch.where(slots == ws, cur, cache_positions.to(torch.int64))
    valid = (held >= 0) & (held <= cur)
    if window is not None:
        valid &= held > cur - window
    return (slice(None), ws.reshape(1)), sel[:, None, None, None], \
        valid[None, None, None, None, :]


def decode_attention(x, p, cfg, engine: DotEngine, k_cache, v_cache,
                     cache_positions, write_slot, cur_pos, cos, sin,
                     row_mask=None, residual=None, plan=None):
    """One-token decode against contiguous per-slot strips.

    x: (B, 1, d); k_cache/v_cache: (B, C, Hkv, dh); cache_positions:
    (C,) position each entry holds, -1 if empty, shared by every row;
    write_slot: the entry the new token goes to; cur_pos: its position.
    ``row_mask`` (B,) bool: rows with False write nothing.  The new
    token's K/V is written **in place** into the strips.

    Scalar ``write_slot``/``cur_pos`` (lockstep): validity comes from
    ``cache_positions`` (with the entry being written at ``cur_pos``),
    ``0 <= pos <= cur_pos`` and, under SWA, ``pos > cur_pos - window``:
    the reference's ring of one window.

    (B,) vectors (each row on its own clock): row b writes at
    ``write_slot[b]``, which must be ``cur_pos[b] % C``, and its validity
    comes from ``cur_pos[b]`` alone (:func:`ring_positions`): entry j is
    valid iff its position is >= 0 and, under SWA, > ``cur_pos[b] -
    window``.  So a row never reads an entry another row's clock marked.
    Without a window and before a row wraps this is the reference's
    vector path exactly (entries ``[0, cur_pos[b]]``); the reference
    rejects SWA there, the port carries the same rule to the ring.

    ``plan``: :func:`decode_plan` of these arguments, computed once for
    all layers of a step (the positions and ``row_mask`` are then not
    read again); None computes it here.

    On a mesh the strips hold this rank's sequence shard (the entries
    ``cache_positions`` describes): every head is gathered and the
    sequence-parallel online softmax combines the shards
    (:func:`repro_torch.distributed.sp_attention.sp_decode_attention`);
    ``write_slot`` is then the global entry, and a vector position
    raises, as in the reference.

    Returns (out (B, 1, d), k_cache, v_cache)."""
    c_ = tp_context()
    if c_ is not None:
        return _sp_decode(x, p, cfg, engine, k_cache, v_cache,
                          cache_positions, write_slot, cur_pos, cos, sin,
                          row_mask, residual, c_)
    b, c = k_cache.shape[:2]
    q, k_new, v_new = _project_qkv(x, p, cfg, engine, cos, sin)
    idx, sel, mask = plan or decode_plan(cfg, b, c, cache_positions,
                                         write_slot, cur_pos, row_mask,
                                         x.device)
    k_cache[idx] = torch.where(sel, k_new, k_cache[idx])
    v_cache[idx] = torch.where(sel, v_new, v_cache[idx])
    out = _sdpa(q, k_cache, v_cache, mask, 1.0 / math.sqrt(cfg.d_head))
    out = engine.dot(out.reshape(b, 1, -1), p["wo"], residual=residual)
    return out, k_cache, v_cache


def _sp_decode(x, p, cfg, engine, k_cache, v_cache, cache_positions,
               write_slot, cur_pos, cos, sin, row_mask, residual, c):
    from repro_torch.distributed.sp_attention import sp_decode_attention

    if torch.as_tensor(cur_pos).dim() > 0:
        raise NotImplementedError(
            "per-slot position vectors are single-device only; the "
            "sequence-parallel decode path takes a scalar position")
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(x, p, cfg, engine, cos, sin,
                                   full_heads=True)
    out, k_cache, v_cache = sp_decode_attention(
        q, k_cache, v_cache, cache_positions, k_new, v_new, write_slot,
        cur_pos, mesh=c.mesh, window=cfg.swa_window,
        seq_axes=c.sp, row_mask=row_mask)
    out = _local_columns(out.reshape(b, 1, -1))
    return out_proj(engine, out, p["wo"], residual), k_cache, v_cache

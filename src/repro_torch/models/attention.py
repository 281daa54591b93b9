"""GQA attention (port of ``repro.models.attention``): q/k/v projection
with qwen3's per-head qk-norm and RoPE, full-sequence (prefill)
attention with the reference's q-chunked exact softmax, and one-token
decode against the paged KV pool (the paged decode kernel) or against
per-slot contiguous strips, a ring of one window under SWA (plain torch
ops, as the reference's are XLA).  The sequence-parallel decode waits
for the distributed slice (ROADMAP.md queue A, A15)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention import paged_decode_attention_cuda

from .layers import DotEngine, apply_rope, init_linear, init_rms, rms_norm

__all__ = ["init_attention", "attention", "prefill_kv",
           "decode_attention", "decode_plan", "paged_decode_attention"]


def init_attention(generator, cfg, dtype=torch.float32, *, lead=(),
                   device=None):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kw = dict(lead=lead, device=device)
    p = {
        "wq": init_linear(generator, d, h * dh, dtype, **kw),
        "wk": init_linear(generator, d, hkv * dh, dtype, **kw),
        "wv": init_linear(generator, d, hkv * dh, dtype, **kw),
        "wo": init_linear(generator, h * dh, d, dtype, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms(dh, dtype, **kw)
        p["k_norm"] = init_rms(dh, dtype, **kw)
    return p


def _project_qkv(x, p, cfg, engine: DotEngine, cos, sin):
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = engine.dot(x, p["wq"]).reshape(b, s, h, dh)
    k = engine.dot(x, p["wk"]).reshape(b, s, hkv, dh)
    v = engine.dot(x, p["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:  # before rope, as the reference
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
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
              q_chunk: int = 1024, residual=None, return_kv: bool = False):
    """Full-sequence attention (prefill).  x: (B, S, d).

    Causal iff ``cfg.causal``, sliding-window iff ``cfg.swa_window``.
    Causal attention runs in q chunks of ``q_chunk`` rows (S must be a
    multiple): chunk i attends to keys [lo, (i + 1) * q_chunk) with an
    exact softmax, lo = 0 or the window's start aligned down to a chunk.
    ``residual`` rides the out-projection's fused epilogue;
    ``return_kv=True`` also returns the post-rope/qk-norm (k, v), what
    the decode cache stores."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, engine, cos, sin)
    scale = 1.0 / math.sqrt(cfg.d_head)
    window = cfg.swa_window
    if not cfg.causal:
        out = _sdpa(q, k, v, None, scale)
    else:
        c = min(q_chunk, s)
        if s % c:
            raise ValueError(f"sequence {s} is not a multiple of q_chunk {c}")
        outs = []
        for i in range(s // c):
            hi = (i + 1) * c
            lo = 0
            if window is not None:
                lo = max(0, hi - c - window + 1)
                lo = (lo // c) * c
            qpos = torch.arange(i * c, hi, device=x.device)[:, None]
            kpos = torch.arange(lo, hi, device=x.device)[None, :]
            mask = kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            outs.append(_sdpa(q[:, i * c:hi], k[:, lo:hi], v[:, lo:hi],
                              mask[None, None, None], scale))
        out = torch.cat(outs, dim=1)
    out = engine.dot(out.reshape(b, s, -1), p["wo"], residual=residual)
    return (out, k, v) if return_kv else out


def prefill_kv(x, p, cfg, engine: DotEngine, cos, sin):
    """(k, v) for cache seeding, no attention compute."""
    _, k, v = _project_qkv(x, p, cfg, engine, cos, sin)
    return k, v


def paged_decode_attention(x, p, cfg, engine: DotEngine, k_pages, v_pages,
                           phys_tables, write_tables, cur_pos, cos, sin,
                           row_mask=None, residual=None):
    """One-token decode against the paged KV pool.

    x: (B, 1, d); k_pages/v_pages: (R, page_size, Hkv, dh) physical pool
    (last row reserved zero); phys_tables: (B, max_pages) int32 physical
    rows for this layer; write_tables: (B, max_pages) logical block
    table (-1 = unallocated); cur_pos: (B,) int positions (or a scalar);
    row_mask: (B,) bool, rows with False write nothing.

    The new token's K/V is written **in place** into the pool, at
    (cur_pos // page_size, cur_pos % page_size) of each slot's page, for
    rows whose logical entry is allocated and whose row_mask is set.
    Every other row writes its location's current value back (the
    reference's gather-select-scatter, with no host sync): written rows
    own distinct pages, and rows that write back may repeat a location
    (the zero row) only with the value it already holds, so the index
    write is deterministic.  Returns (out (B, 1, d), k_pages, v_pages).
    """
    b = x.shape[0]
    page_size = k_pages.shape[1]
    max_pages = phys_tables.shape[1]
    q, k_new, v_new = _project_qkv(x, p, cfg, engine, cos, sin)

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
                                      phys_tables, pos)
    out = engine.dot(out.reshape(b, 1, -1), p["wo"], residual=residual)
    return out, k_pages, v_pages


def ring_positions(cur_pos, c: int):
    """(B, c) token position each ring entry of a row holds when the row
    writes position ``cur_pos[b]`` at entry ``cur_pos[b] % c``: entry j
    holds ``cur_pos[b] - ((cur_pos[b] - j) mod c)`` (negative: never
    written)."""
    j = torch.arange(c, device=cur_pos.device)
    return cur_pos[:, None] - torch.remainder(cur_pos[:, None] - j, c)


def decode_plan(cfg, b: int, c: int, cache_positions, write_slot, cur_pos,
                row_mask=None, device=None):
    """What every layer of one contiguous decode step shares, since it
    depends on the positions alone: ``(index, select, mask)``, the
    index of the entry each row writes in a layer's (B, C, ...) strip,
    the rows that write ((B, 1, 1) bool, ``row_mask`` or all) and the
    attention mask over the C entries, broadcast against
    :func:`_sdpa`'s (B, Hkv, G, 1, C).  The rules are
    :func:`decode_attention`'s."""
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
        return (torch.arange(b, device=device), ws), sel[:, None, None], \
            valid[:, None, None, None, :]
    slots = torch.arange(c, device=device)
    held = torch.where(slots == ws, cur, cache_positions.to(torch.int64))
    valid = (held >= 0) & (held <= cur)
    if window is not None:
        valid &= held > cur - window
    return (slice(None), ws), sel[:, None, None], \
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

    Returns (out (B, 1, d), k_cache, v_cache)."""
    b, c = k_cache.shape[:2]
    q, k_new, v_new = _project_qkv(x, p, cfg, engine, cos, sin)
    idx, sel, mask = plan or decode_plan(cfg, b, c, cache_positions,
                                         write_slot, cur_pos, row_mask,
                                         x.device)
    k_cache[idx] = torch.where(sel, k_new[:, 0], k_cache[idx])
    v_cache[idx] = torch.where(sel, v_new[:, 0], v_cache[idx])
    out = _sdpa(q, k_cache, v_cache, mask, 1.0 / math.sqrt(cfg.d_head))
    out = engine.dot(out.reshape(b, 1, -1), p["wo"], residual=residual)
    return out, k_cache, v_cache

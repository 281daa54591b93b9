"""GQA attention (port of ``repro.models.attention``): q/k/v projection
with qwen3's per-head qk-norm and RoPE, and one-token decode against
the paged KV pool.  Prefill attention and the contiguous decode are not
ported yet (ROADMAP.md queue A item 7)."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import paged_decode_attention_cuda

from .layers import DotEngine, apply_rope, init_linear, init_rms, rms_norm

__all__ = ["init_attention", "paged_decode_attention"]


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

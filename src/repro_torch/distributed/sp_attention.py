"""Sequence-parallel (SP) decode attention (port of
``repro.distributed.sp_attention``): KV caches sharded along the
*sequence* over the SP axes, combined with a distributed online softmax.

Each rank owns cache entries ``[i * S_loc, (i + 1) * S_loc)`` (i its
index over the SP axes); the new token's K/V is written by the owning
rank only.  The combine is explicit, with the reference's three
collectives:

    m*  = all-reduce MAX of m_loc
    l*  = all-reduce SUM of l_loc * e^(m_loc - m*)
    o*  = all-reduce SUM of w_loc @ v_loc,
          w_loc = softmax_loc(s) * l_loc * e^(m_loc - m*) / l*

The weights are normalised before the second product and cast to V's
dtype there, the rounding points of the port's one-device attention
(``models.attention._sdpa``): on one shard the factor is exactly 1 and
the result that attention's bit for bit; the reference normalises after
the product, the same function.  A rank whose entries are all masked
keeps a finite max (-1e30) so its terms vanish, and ``l*`` is floored at
1e-30, as in the reference.  The partial outputs are summed in f32.
Works for dense and SWA-ring caches.
"""
from __future__ import annotations

import math

import torch

__all__ = ["sp_decode_attention"]


def sp_decode_attention(q, k_cache, v_cache, kv_pos, k_new, v_new,
                        slot, pos, *, mesh, window=None,
                        seq_axes=("model",), row_mask=None):
    """One-token attention against this rank's sequence shard.

    q: (B, 1, H, dh) every query head; k_cache/v_cache: (B, S_loc, Hkv,
    dh) this rank's entries, written **in place**; kv_pos: (S_loc,) the
    position each local entry holds (-1 empty), not written (the decode
    step sets the owner's entry after its layers); k_new/v_new: (B, 1,
    Hkv, dh); slot/pos: scalars (the global entry and the position);
    row_mask: (B,) bool, rows with False write nothing.  ``seq_axes``
    empty: the cache is replicated (no combine).  Returns (out (B, 1, H,
    dh), k_cache, v_cache)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s_loc = k_cache.shape[1]
    dev = q.device
    start = mesh.index(seq_axes) * s_loc
    pos = torch.as_tensor(pos, device=dev).to(torch.int64)
    lslot = torch.as_tensor(slot, device=dev).to(torch.int64) - start
    sel_slot = torch.arange(s_loc, device=dev) == lslot
    sel = sel_slot[None, :, None, None]
    if row_mask is not None:
        sel = sel & row_mask[:, None, None, None]
    k_cache.copy_(torch.where(sel, k_new, k_cache))
    v_cache.copy_(torch.where(sel, v_new, v_cache))
    held = torch.where(sel_slot, pos, kv_pos.to(torch.int64))
    valid = (held >= 0) & (held <= pos)
    if window is not None:
        valid &= held > pos - window
    b, _, h, dh = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache).float() * scale
    s_inf = s.masked_fill(~valid, -math.inf)
    m_loc = s_inf.amax(dim=-1, keepdim=True)         # (b, hkv, g, 1, 1)
    # a fully masked shard: exp(-inf - -inf) -> use a finite max
    m_safe = torch.where(torch.isfinite(m_loc), m_loc,
                         torch.full_like(m_loc, -1e30))
    l_loc = torch.exp(s_inf - m_safe).sum(dim=-1, keepdim=True)
    m_g = m_safe.clone()
    if seq_axes:
        mesh.all_reduce(m_g, seq_axes, "max")
    part = l_loc * torch.exp(m_safe - m_g)           # this shard's share
    l_g = mesh.all_reduce(part.clone(), seq_axes) if seq_axes else part
    # the local softmax (the one-device attention's, masked with -1e30)
    # rescaled to the global one: exactly itself on one shard
    w = torch.softmax(s.masked_fill(~valid, -1e30), dim=-1) \
        * (part / torch.clamp(l_g, min=1e-30))
    w = w.to(v_cache.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache)
    if seq_axes:
        out = mesh.all_reduce(out.float(), seq_axes).to(out.dtype)
    out = out.reshape(b, 1, h, dh)
    return out.to(q.dtype), k_cache, v_cache

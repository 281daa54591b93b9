"""Dense transformer backbone (port of ``repro.models.transformer``):
parameter init with the reference's distributions and the paged decode
step.  Per-layer parameters are stacked on a leading ``n_layers`` axis
as in the reference; a Python loop over that axis takes the place of
``lax.scan``.  The full-sequence forward, the loss, bulk and chunked
prefill and the contiguous decode wait for later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device

from . import attention as attn_mod
from .config import ArchConfig
from .layers import DotEngine, init_linear, init_rms, init_swiglu, rms_norm, \
    rope, swiglu_mlp

__all__ = ["init_model", "decode_step"]


def init_model(cfg: ArchConfig, generator: torch.Generator | None = None,
               device=None) -> dict[str, Any]:
    """Random parameters with the reference's distributions: linears
    normal / sqrt(d_in), ``embed`` 0.02 * normal at ``padded_vocab``
    rows, norms ones; per-layer tensors stacked on a leading n_layers
    axis.  Drawn with ``generator`` (seed 0 on ``device`` when None)
    straight on ``device`` (``cuda`` unless the caller asks for cpu).
    The numbers differ from the reference's jax.random draws; use
    :func:`repro_torch.models.convert.params_from_jax` for identical
    weights."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue A)")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    dtype = cfg.param_torch_dtype()
    lead = (cfg.n_layers,)
    kw = dict(lead=lead, device=dev)
    layers = {
        "norm1": init_rms(cfg.d_model, dtype, **kw),
        "attn": attn_mod.init_attention(generator, cfg, dtype, **kw),
        "norm2": init_rms(cfg.d_model, dtype, **kw),
        "mlp": init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype, **kw),
    }
    params: dict[str, Any] = {
        "layers": layers,
        "final_norm": init_rms(cfg.d_model, dtype, device=dev),
    }
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator,
                        dtype=torch.float32, device=dev)
    params["embed"] = (embed * 0.02).to(dtype)
    params["lm_head"] = init_linear(generator, cfg.d_model, cfg.padded_vocab,
                                    dtype, device=dev)
    return params


def _layer(tree, i: int):
    """Layer ``i``'s slice of the stacked per-layer parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _mask_padded_vocab(logits, cfg: ArchConfig):
    if cfg.vocab and cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    return logits


def _decode_rope(cfg: ArchConfig, pos, device):
    """(cos, sin) for a decode step's position(s): (1|B, 1, dh/2)."""
    pvec = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    cos, sin = rope(pvec, cfg.d_head, cfg.rope_theta)
    return cos[:, None], sin[:, None]


def _decode_step_paged(params, cfg: ArchConfig, state, tokens, pos,
                       engine: DotEngine, row_mask):
    from repro_torch.serve.paged_kv import physical_rows, zero_row_index

    dev = tokens.device
    x = params["embed"][tokens.long()].to(cfg.act_torch_dtype())
    cos, sin = _decode_rope(cfg, pos, dev) if cfg.rope else (None, None)
    kp, vp = state["k_pages"], state["v_pages"]
    bt = state["block_tables"]
    # physical rows of every layer at once: (n_layers, B, max_pages);
    # unallocated entries read the reserved zero row
    phys = physical_rows(state["page_perm"], bt, zero_row_index(kp))
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["norm1"])
        x, kp, vp = attn_mod.paged_decode_attention(
            h, lp["attn"], cfg, engine, kp, vp, phys[i], bt, pos, cos, sin,
            row_mask, residual=x)
        x = swiglu_mlp(rms_norm(x, lp["norm2"]), lp["mlp"], engine,
                       residual=x)
    x = rms_norm(x, params["final_norm"])
    logits = engine.dot(x, params["lm_head"], out_dtype=torch.float32)
    return _mask_padded_vocab(logits, cfg), state


def decode_step(params, cfg: ArchConfig, state, tokens, pos,
                engine: DotEngine | None = None, row_mask=None):
    """One decode step.  tokens: (B, 1) int; pos: a scalar position
    shared by every row or a (B,) vector of per-row positions; row_mask
    (B,) bool: rows with False leave the cache untouched.

    Returns (logits (B, 1, padded_vocab) f32, state).  The paged pool
    in ``state`` is updated **in place** (the returned state is the
    same object); clone the state first to keep the old one.  Only the
    paged layout is ported: a contiguous state raises."""
    engine = engine or DotEngine()
    layout = getattr(state, "layout", None)
    if layout is None or not layout.is_paged:
        raise NotImplementedError(
            "only the paged KV layout is ported (ROADMAP.md queue A); "
            "build the state with serve.paged_kv.init_paged_serving")
    return _decode_step_paged(params, cfg, state, tokens, pos, engine,
                              row_mask)

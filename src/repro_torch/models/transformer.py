"""Backbone assembly (port of ``repro.models.transformer``) for every
family (dense, moe, ssm, hybrid, encoder, vlm): parameter init with the
reference's distributions, the decode state of either KV layout
(:func:`init_decode_state`; ssm and hybrid states are contiguous and
carry the SSD's ``ssm_h``/``ssm_conv``), single-shot and chunked
prefill (pure-attention families) and the decode step, each into the
paged pool or into the contiguous per-slot strips (a ring of one window
under SWA).  Per-layer parameters are stacked on a leading ``n_layers``
axis as in the reference, drawn a layer at a time; a Python loop over
that axis takes the place of ``lax.scan``.  The full-sequence
:func:`forward` and :func:`loss_fn` train through autograd: every
projection is B1's autograd ``Function`` (``repro_torch.kernels.grad``),
the stacked parameters are unbound once per forward, and ``cfg.remat``
selects a per-layer checkpoint (``"full"``) or the GEMM-output-keeping
``"dots"``.  The encoder (bidirectional, no decode step) and the vlm
(decoding, prefilling and serving as dense) take their modality stub's
embeddings through ``frontend_proj`` (:func:`embed_inputs`).

On a mesh (an active :func:`repro_torch.distributed.ctx.mesh_context`,
parameters sharded by ``distributed.sharding.param_specs``) the forward,
the loss and the decode step run tensor-parallel: ``embed`` is
vocab-parallel (a masked local lookup, then an all-reduce), the layers'
GEMMs column- and row-parallel (``layers``, ``attention``), the vocab
head column-parallel with the loss's max and sum-exp taken across the
shards, and the batch split over the context's ``dp`` axes (the loss
over the global batch; each rank's gradients are its own share, summed
over ``dp`` by the train step).  The prefills are single-device.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.device import resolve_device

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ArchConfig
from .layers import DotEngine, copy_to, init_linear, init_rms, init_swiglu, \
    reduce_sum, rms_norm, rope, swiglu_mlp, tp_context

__all__ = ["init_model", "forward", "embed_inputs", "loss_fn",
           "init_decode_state", "decode_step", "prefill_kv",
           "prefill_kv_chunk", "fused_epilogue_savings_bytes"]


def fused_epilogue_savings_bytes(cfg: ArchConfig, tokens: int) -> float:
    """Modeled device-memory bytes one forward pass over ``tokens`` no
    longer moves because the epilogues are fused: each fused site drops
    the C round trip (re-read + re-write of the projection output) a
    dot-then-elementwise pipeline pays.  Dense: the attention
    out-projection's residual (2*T*d), the MLP up-projection's
    activation (2*T*d_ff) and down-projection's residual (2*T*d); the
    vocab head's dtype cast (2*T*V_padded).  Other families as the
    reference counts them."""
    act_bytes = cfg.act_torch_dtype().itemsize
    per_tok = 0.0
    if cfg.family in ("dense", "encoder", "vlm"):
        per_tok += 2.0 * cfg.d_model          # attn out-proj residual
        per_tok += 2.0 * cfg.d_ff             # MLP up-proj activation
        per_tok += 2.0 * cfg.d_model          # MLP down-proj residual
    elif cfg.family == "moe":
        per_tok += 2.0 * cfg.d_model          # attn out-proj residual
    elif cfg.family == "hybrid":
        per_tok += 2.0 * cfg.d_ff + 2.0 * cfg.d_model   # MLP sites only
    saved = cfg.n_layers * per_tok * tokens * act_bytes
    if cfg.vocab:
        saved += 2.0 * tokens * cfg.padded_vocab * act_bytes  # head cast
    return saved


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")


def _require_family(cfg: ArchConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _require_decode(cfg: ArchConfig):
    """Raise for a family without a decode step (the encoder)."""
    _require_family(cfg)
    if not cfg.has_decode:
        raise NotImplementedError(
            f"{cfg.name} is an {cfg.family}: an encoder has no decode step "
            f"(no decode state, prefill or serving loop)")


def init_model(cfg: ArchConfig, generator: torch.Generator | None = None,
               device=None, moe_pad: int | None = None,
               place=None) -> dict[str, Any]:
    """Random parameters with the reference's distributions: linears
    normal / sqrt(d_in), ``embed`` 0.02 * normal at ``padded_vocab``
    rows, norms ones, the moe and ssm families' own
    (:func:`~repro_torch.models.moe.init_moe`,
    :func:`~repro_torch.models.ssm.init_ssm`); per-layer tensors stacked
    on a leading n_layers axis, each layer drawn on its own into the
    stack (the f32 temporary is one layer's matrix).  Drawn with
    ``generator`` (seed 0 on ``device`` when None) straight on
    ``device`` (``cuda`` unless the caller asks for cpu).  The numbers
    differ from the reference's jax.random draws; use :func:`repro_torch.models.convert.params_from_jax` for
    identical weights.  ``moe_pad``: pad the moe experts to a multiple
    of it (the model axis, for expert parallelism; never routed).

    ``place(path, leaf)``, when given, takes each leaf (``path`` its
    keys) as soon as it is drawn -- the moe and ssm blocks' leaves, drawn
    interleaved, as soon as their block is -- and the tree holds what it
    returns: a sharded run keeps only its shard of each
    (``distributed.sharding.shard_leaf``), so the full tree never
    exists.  The draws are the same with and without it."""
    _require_family(cfg)
    dev = resolve_device(device)
    # "meta" (the builders' abstract state) draws with a CPU generator
    gen_dev = "cpu" if dev.type == "meta" else dev
    if generator is None:
        generator = torch.Generator(device=gen_dev).manual_seed(0)
    if generator.device.type != torch.device(gen_dev).type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    dtype = cfg.param_torch_dtype()
    d = cfg.d_model
    kw = dict(lead=(cfg.n_layers,), device=dev)
    put = place or (lambda _, t: t)

    def under(*path):
        if place is None:
            return None
        return lambda name, t: place((*path, name), t)

    def put_all(path, block):
        return {k: put((*path, k), v) for k, v in block.items()}

    layers: dict[str, Any] = {
        "norm1": put(("layers", "norm1"), init_rms(d, dtype, **kw))}
    if cfg.has_attention:
        layers["attn"] = attn_mod.init_attention(
            generator, cfg, dtype, **kw, place=under("layers", "attn"))
    if cfg.has_ssm:
        layers["ssm"] = put_all(("layers", "ssm"), ssm_mod.init_ssm(
            generator, cfg, dtype, **kw))
    if cfg.family == "hybrid":
        for k in ("attn_out_norm", "ssm_out_norm"):
            layers[k] = put(("layers", k), init_rms(d, dtype, **kw))
    if cfg.family != "ssm":
        layers["norm2"] = put(("layers", "norm2"), init_rms(d, dtype, **kw))
    if cfg.family == "moe":
        layers["moe"] = put_all(("layers", "moe"), moe_mod.init_moe(
            generator, cfg, dtype, **kw, model_axis_size=moe_pad))
    elif cfg.family != "ssm":
        layers["mlp"] = init_swiglu(generator, d, cfg.d_ff, dtype, **kw,
                                    place=under("layers", "mlp"))
    params: dict[str, Any] = {
        "layers": layers,
        "final_norm": put(("final_norm",), init_rms(d, dtype, device=dev)),
    }
    embed = torch.randn((cfg.padded_vocab, d), generator=generator,
                        dtype=torch.float32, device=dev)
    params["embed"] = put(("embed",), (embed * 0.02).to(dtype))
    del embed
    params["lm_head"] = put(("lm_head",), init_linear(
        generator, d, cfg.padded_vocab, dtype, device=dev))
    if cfg.frontend:
        params["frontend_proj"] = put(("frontend_proj",), init_linear(
            generator, cfg.frontend_dim, d, dtype, device=dev))
    return params


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype=None, *, layout=None, page_size: int = 8,
                      num_pages: int | None = None,
                      max_pages_per_slot: int | None = None, device=None):
    """The decode state of ``layout`` (a
    :class:`~repro_torch.serve.state.KVLayout` or its name; None means
    CONTIGUOUS, as in the reference).

    PAGED: :func:`~repro_torch.serve.paged_kv.init_paged_decode_state`
    (``cache_len`` only sizes the default pool; pure-attention families).
    CONTIGUOUS, for a family with attention: ``k`` and ``v`` strips of
    shape (n_layers, batch, c, n_kv_heads, d_head), c = ``cache_len``
    or, under SWA, ``min(cache_len, swa_window)`` (a ring of one
    window), zero, and ``kv_pos`` (c,) int32 filled with -1, the
    position each entry holds; for a family with an SSD: ``ssm_h``
    (n_layers, batch, H, P, N) f32 and ``ssm_conv`` (n_layers, batch,
    3, conv_dim) in ``dtype``, zero.  On ``device`` (``cuda`` unless the
    caller asks for cpu)."""
    from repro_torch.serve.state import DecodeState, KVLayout, \
        resolve_layout

    _require_decode(cfg)
    layout = resolve_layout(layout)
    if layout is KVLayout.PAGED:
        from repro_torch.serve.paged_kv import init_paged_decode_state
        return init_paged_decode_state(
            cfg, batch, page_size=page_size, num_pages=num_pages,
            max_pages_per_slot=max_pages_per_slot, cache_len=cache_len,
            dtype=dtype, device=device)
    dev = resolve_device(device)
    dtype = dtype or cfg.act_torch_dtype()
    st: dict[str, Any] = {}
    if cfg.has_attention:
        c = cache_len if cfg.swa_window is None \
            else min(cache_len, cfg.swa_window)
        shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.d_head)
        st["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        st["v"] = torch.zeros(shape, dtype=dtype, device=dev)
        st["kv_pos"] = torch.full((c,), -1, dtype=torch.int32, device=dev)
    if cfg.has_ssm:
        shp = ssm_mod.ssm_state_shape(cfg, batch)
        st["ssm_h"] = torch.zeros((cfg.n_layers, *shp["h"]),
                                  dtype=torch.float32, device=dev)
        st["ssm_conv"] = torch.zeros((cfg.n_layers, *shp["conv"]),
                                     dtype=dtype, device=dev)
    return DecodeState(st, KVLayout.CONTIGUOUS)


def _layer(tree, i: int):
    """Layer ``i``'s slice of the stacked per-layer parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind_layers(tree, n: int) -> list[dict]:
    """The stacked per-layer tree as ``n`` per-layer trees, each leaf
    unbound once: under autograd the backward then stacks each leaf's
    gradients in one pass, where indexing layer by layer (``_layer``)
    would materialise a zero tensor of the whole stack for every
    layer."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind_layers(v, n) if isinstance(v, dict) \
            else torch.unbind(v, 0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _layer_fwd(x, lp, cfg: ArchConfig, engine: DotEngine, cos, sin,
               window=...):
    """One layer of the full-sequence forward -> (x, aux), the
    reference's branch per family, attention under the layer's
    ``window`` (``...``: ``cfg.swa_window``).  The residual adds ride the
    out-projection's and the down-projection's fused epilogues where
    the reference fuses them; ``aux`` is the moe router's load-balance
    loss (0 for the other families)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        return x + ssm_mod.ssd_forward(rms_norm(x, lp["norm1"]), lp["ssm"],
                                       cfg, engine, chunk=cfg.ssd_chunk), zero
    if cfg.family == "hybrid":
        h = rms_norm(x, lp["norm1"])
        a = attn_mod.attention(h, lp["attn"], cfg, engine, cos, sin,
                               q_chunk=cfg.attn_q_chunk, window=window)
        s = ssm_mod.ssd_forward(h, lp["ssm"], cfg, engine,
                                chunk=cfg.ssd_chunk)
        x = x + 0.5 * (rms_norm(a, lp["attn_out_norm"])
                       + rms_norm(s, lp["ssm_out_norm"]))
    else:
        x = attn_mod.attention(rms_norm(x, lp["norm1"]), lp["attn"], cfg,
                               engine, cos, sin, q_chunk=cfg.attn_q_chunk,
                               residual=x, window=window)
    x, aux = _ffn(x, lp, cfg, engine, impl="auto")
    return x, zero if aux is None else aux


def _remat_layer_fwd(x, lp, cfg: ArchConfig, engine: DotEngine, cos, sin,
                     window=...):
    """:func:`_layer_fwd` under a per-layer checkpoint (non-reentrant).
    ``"full"`` keeps only the layer's input and recomputes the layer in
    the backward, GEMMs included; ``"dots"`` keeps the layer's GEMM
    outputs too (:class:`~repro_torch.kernels.grad.DotCache`) and
    recomputes only the elementwise chains between them (norms, rope,
    attention, the gate product).  Neither changes a value."""
    from repro_torch.kernels.grad import DotCache

    if cfg.remat_policy == "dots":
        context_fn = DotCache().contexts
    elif cfg.remat_policy == "full":
        context_fn = torch.utils.checkpoint.noop_context_fn
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"choose 'dots' or 'full'")
    return torch.utils.checkpoint.checkpoint(
        _layer_fwd, x, lp, cfg, engine, cos, sin, window, use_reentrant=False,
        context_fn=context_fn, preserve_rng_state=False)


def embed_inputs(params, cfg: ArchConfig, batch, engine: DotEngine):
    """tokens (and the frontend stub's embeddings) -> (B, S, d)
    activations in the activation dtype.  Encoder: the precomputed frame
    features (B, S, frontend_dim) @ ``frontend_proj``; the token embedding
    is not read.  Otherwise the tokens' rows of ``embed`` (``F.embedding``,
    whose backward sums the rows of repeated tokens without atomics);
    a vlm batch with ``vision_embeds`` (B, nv, frontend_dim) has the
    projected patches in place of its first nv positions (LLaVA-style).
    Both projections are ``engine.dot``, so B1 on the card."""
    dtype = cfg.act_torch_dtype()
    if cfg.family == "encoder":
        return engine.dot(batch["features"].to(dtype),
                          params["frontend_proj"].to(dtype))
    x = _embed(params["embed"], batch["tokens"], dtype)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        v = engine.dot(batch["vision_embeds"].to(dtype),
                       params["frontend_proj"].to(dtype))
        x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
    return x


def forward(params, cfg: ArchConfig, batch, engine: DotEngine | None = None):
    """Full-sequence forward -> (logits (B, S, padded_vocab) f32, aux).

    Rope over ``arange(S)`` (one table per kind of layer,
    :func:`_layer_ropes`), the layer loop (each layer checkpointed
    when ``cfg.remat`` and grad mode are on), ``final_norm``, and the
    vocab head with its f32 output fused into the GEMM; padded vocab
    columns are masked to -1e30.  ``aux`` is the mean of the layers'
    auxiliary losses (the moe router's load-balance loss; 0 for the
    other families)."""
    engine = engine or DotEngine()
    x = embed_inputs(params, cfg, batch, engine)
    s = x.shape[1]
    ropes = _layer_ropes(cfg, torch.arange(s, device=x.device))
    layer = _remat_layer_fwd if cfg.remat and torch.is_grad_enabled() \
        else _layer_fwd
    auxs = []
    for i, lp in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
        x, aux = layer(x, lp, cfg, engine, *ropes[i], cfg.layer_window(i))
        auxs.append(aux)
    x = rms_norm(x, params["final_norm"])
    logits = _head(x, params, cfg, engine) if cfg.vocab else x
    return logits, torch.stack(auxs).mean()


def loss_fn(params, cfg: ArchConfig, batch, engine: DotEngine | None = None,
            aux_weight: float = 0.01):
    """Next-token (causal) or per-position cross entropy in f32 ->
    ``(ce + aux_weight * aux, {"ce": ce, "aux": aux})``.  ``loss_mask``
    (optional, (B, S)) weights the positions; the mean is over its sum
    (at least 1), else over every position.

    On a mesh the logits are this rank's vocab shard: the log-partition
    takes its max (all-reduce MAX) and its sum of exponentials (SUM)
    across the model axis and the gold logit from the shard that holds
    the label; the mean runs over the global batch (every ``dp`` rank's
    positions or mask), and the value returned is the global loss on
    every rank."""
    logits, aux = forward(params, cfg, batch, engine)
    labels = batch["labels"].long()
    if cfg.causal:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    mask = batch.get("loss_mask")
    if mask is not None and cfg.causal:
        mask = mask[:, 1:]
    c = tp_context()
    if c is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        logz, gold = _sharded_logz_gold(logits, labels, c)
    nll = logz - gold
    n_dp = c.mesh.size(c.dp) if c is not None and c.dp else 1
    if mask is not None:
        nll = nll * mask
        msum = mask.sum().detach().float()
        if n_dp > 1:
            c.mesh.all_reduce(msum, c.dp)
        denom = torch.clamp(msum, min=1.0)
    else:
        denom = nll.numel() * n_dp
    loss = nll.sum() / denom
    if n_dp > 1:
        loss = reduce_sum(loss, c.dp)
        aux = reduce_sum(aux, c.dp) / n_dp
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _vocab_offset(n: int) -> int:
    """The first vocab row or column of this rank's ``n``-wide shard."""
    c = tp_context()
    return 0 if c is None else c.mesh.index(c.model_axis) * n


def _sharded_logz_gold(logits, labels, c):
    """log-partition and gold logit over a vocab-sharded head: each
    shard's log-sum-exp, combined by their max (all-reduce MAX) and the
    sum of their exponentials (SUM); on one shard exactly
    ``torch.logsumexp`` of the logits, forward and backward."""
    n = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    mx = lse.detach().clone()
    c.mesh.all_reduce(mx, c.model_axis, "max")
    logz = mx + torch.log(reduce_sum(torch.exp(lse - mx)))
    t = labels - _vocab_offset(n)
    inside = (t >= 0) & (t < n)
    gold = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    return logz, reduce_sum(gold * inside)


def _embed(table, tokens, dtype):
    """The tokens' rows of ``embed``; on a mesh (vocab-parallel rows) a
    masked lookup of the rows this rank holds, then an all-reduce."""
    tokens = tokens.long()
    if tp_context() is None:
        return F.embedding(tokens, table).to(dtype)
    n = table.shape[0]
    t = tokens - _vocab_offset(n)
    inside = (t >= 0) & (t < n)
    x = F.embedding(torch.where(inside, t, torch.zeros_like(t)), table)
    return reduce_sum(x * inside[..., None].to(x.dtype)).to(dtype)


def _head(x, params, cfg: ArchConfig, engine: DotEngine):
    """The vocab head (column-parallel on a mesh: this rank's vocab
    shard) with its f32 output fused into the GEMM, padded columns
    masked."""
    logits = engine.dot(copy_to(x), params["lm_head"],
                        out_dtype=torch.float32)
    return _mask_padded_vocab(logits, cfg)


def _mask_padded_vocab(logits, cfg: ArchConfig):
    if cfg.vocab and cfg.padded_vocab != cfg.vocab:
        n = logits.shape[-1]
        lo = _vocab_offset(n)
        pad = torch.arange(lo, lo + n, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    return logits


def _decode_rope(cfg: ArchConfig, pos, device):
    """(cos, sin) for a decode step's position(s): (1|B, 1, dh/2)."""
    pvec = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    cos, sin = rope(pvec, cfg.d_head, cfg.rope_theta)
    return cos[:, None], sin[:, None]


def _layer_ropes(cfg: ArchConfig, positions) -> list[tuple]:
    """Each layer's (cos, sin) at ``positions`` (``rope`` of its kind,
    :meth:`~repro_torch.models.config.ArchConfig.layer_rope`): one table
    a kind, built once and shared by its layers; (None, None) without
    rope."""
    if not (cfg.has_attention and cfg.rope):
        return [(None, None)] * cfg.n_layers
    tables: dict = {}
    out = []
    for i in range(cfg.n_layers):
        key = cfg.layer_rope(i)
        if key not in tables:
            tables[key] = rope(positions, cfg.d_head, *key)
        out.append(tables[key])
    return out


def _decode_ropes(cfg: ArchConfig, pos, device) -> list[tuple]:
    """:func:`_layer_ropes` for a decode step's position(s): (1|B, 1,
    dh/2) a table."""
    pvec = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    return [(c if c is None else c[:, None], s if s is None else s[:, None])
            for c, s in _layer_ropes(cfg, pvec)]


def _ffn(x, lp, cfg: ArchConfig, engine: DotEngine, impl: str = "serve",
         rows=None, moe_log=None):
    """The block's second half -> (x, aux): the SwiGLU MLP (its residual
    fused; aux None), or the moe layer.  ``impl="serve"`` (decode and
    prefill) runs the routed path where ``cfg.routed_moe``
    (:func:`_routed_ffn`: only ``rows``, flat indices of x's valid rows,
    are routed) and otherwise ``moe_ffn(impl="dense")``, dropless, as in
    the reference; any other ``impl`` goes to ``moe_ffn`` (``"auto"`` in
    training)."""
    h = rms_norm(x, lp["norm2"])
    if cfg.family == "moe":
        if impl == "serve" and cfg.routed_moe:
            return _routed_ffn(x, h, lp["moe"], cfg, engine, rows,
                               moe_log), None
        c = tp_context()
        y, aux = moe_mod.moe_ffn(h, lp["moe"], cfg, engine,
                                 mesh=c.mesh if c else None,
                                 impl="dense" if impl == "serve" else impl)
        return x + y, aux
    return swiglu_mlp(h, lp["mlp"], engine, residual=x), None


def _routed_ffn(x, h, params, cfg: ArchConfig, engine: DotEngine, rows,
                moe_log):
    """x + the routed experts' output on the rows ``rows`` (flat indices
    into x's rows; None: every row), summed in f32 and rounded once; the
    other rows keep x.  ``moe_log`` (a :class:`~repro_torch.models.moe.
    MoeLog`) gains the layer's expert counts and routes."""
    d = x.shape[-1]
    xf, hf = x.reshape(-1, d), h.reshape(-1, d)
    if rows is None:
        y = moe_mod.moe_routed(hf, params, cfg, engine, moe_log)
        return (xf.float() + y).to(x.dtype).reshape(x.shape)
    out = xf.clone()
    if rows.numel():
        y = moe_mod.moe_routed(hf[rows], params, cfg, engine, moe_log)
        out[rows] = (xf[rows].float() + y).to(x.dtype)
    return out.reshape(x.shape)


def _ssm_step(h, lp, cfg: ArchConfig, engine: DotEngine, state, i: int,
              row_mask):
    """Layer ``i``'s SSD decode from the state's ``ssm_h``/``ssm_conv``
    rows, written back in place (rows off ``row_mask`` keep theirs)."""
    y, new = ssm_mod.ssm_decode(
        h, lp["ssm"], cfg, engine,
        {"h": state["ssm_h"][i], "conv": state["ssm_conv"][i]},
        row_mask=row_mask)
    state["ssm_h"][i] = new["h"]
    state["ssm_conv"][i] = new["conv"]
    return y


def _decode_step_paged(params, cfg: ArchConfig, state, tokens, pos,
                       engine: DotEngine, row_mask, rows=None,
                       moe_log=None):
    from repro_torch.serve.paged_kv import physical_rows, zero_row_index

    dev = tokens.device
    x = _embed(params["embed"], tokens, cfg.act_torch_dtype())
    ropes = _decode_ropes(cfg, pos, dev)
    kp, vp = state["k_pages"], state["v_pages"]
    bt = state["block_tables"]
    # physical rows of every layer at once: (n_layers, B, max_pages);
    # unallocated entries read the reserved zero row
    phys = physical_rows(state["page_perm"], bt, zero_row_index(kp))
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["norm1"])
        x, kp, vp = attn_mod.paged_decode_attention(
            h, lp["attn"], cfg, engine, kp, vp, phys[i], bt, pos, *ropes[i],
            row_mask, residual=x, window=cfg.layer_window(i))
        x, _ = _ffn(x, lp, cfg, engine, rows=rows, moe_log=moe_log)
    x = rms_norm(x, params["final_norm"])
    return _head(x, params, cfg, engine), state


def _decode_step_contiguous(params, cfg: ArchConfig, state, tokens, pos,
                            engine: DotEngine, row_mask, rows=None,
                            moe_log=None):
    """The contiguous strips: the new token goes to entry ``pos % c``
    of its row (c the strips' length: a ring when SWA bounds it).  The
    write index and the attention mask are computed once for all
    layers (:func:`~repro_torch.models.attention.decode_plan`, one a
    window where the layers' windows differ).  A
    scalar ``pos`` then sets ``kv_pos`` at that entry, as the reference
    does; per-row positions leave ``kv_pos`` alone, since their
    validity comes from each row's own clock and never reads it.  The
    SSD's rows (ssm and hybrid) are updated in place; the ssm family
    reads no position.

    On a mesh the strips hold this rank's sequence shard of every entry
    (``seq_axes`` of the context: the global entry ``pos % C`` is
    written by the rank that owns it, ``kv_pos`` likewise) and the
    attention is sequence-parallel."""
    dev = tokens.device
    x = _embed(params["embed"], tokens, cfg.act_torch_dtype())
    p = torch.as_tensor(pos, device=dev).to(torch.int64)
    c = tp_context()
    plans: dict = {}
    if cfg.has_attention:
        ropes = _decode_ropes(cfg, pos, dev)
        k, v, kv_pos = state["k"], state["v"], state["kv_pos"]
        seq = c.sp if c is not None else ()
        n_seq = c.mesh.size(seq) if seq else 1
        slot = torch.remainder(p, k.shape[2] * n_seq)
        if c is None:
            for w in {cfg.layer_window(i) for i in range(cfg.n_layers)}:
                plans[w] = attn_mod.decode_plan(
                    cfg, k.shape[1], k.shape[2], kv_pos, slot, p, row_mask,
                    dev, window=w)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["norm1"])
        if cfg.has_attention:
            cos, sin = ropes[i]
            plan = plans.get(cfg.layer_window(i))
        if cfg.family == "ssm":
            x = x + _ssm_step(h, lp, cfg, engine, state, i, row_mask)
            continue
        if cfg.family == "hybrid":
            a, _, _ = attn_mod.decode_attention(
                h, lp["attn"], cfg, engine, k[i], v[i], kv_pos, slot, p, cos,
                sin, row_mask, plan=plan)
            s = _ssm_step(h, lp, cfg, engine, state, i, row_mask)
            x = x + 0.5 * (rms_norm(a, lp["attn_out_norm"])
                           + rms_norm(s, lp["ssm_out_norm"]))
        else:
            x, _, _ = attn_mod.decode_attention(
                h, lp["attn"], cfg, engine, k[i], v[i], kv_pos, slot, p,
                cos, sin, row_mask, residual=x, plan=plan)
        x, _ = _ffn(x, lp, cfg, engine, rows=rows, moe_log=moe_log)
    if cfg.has_attention and p.dim() == 0:
        # a (1,) index: a 0-d index tensor would be read on the host
        if c is None:
            kv_pos[slot.reshape(1)] = p.to(kv_pos.dtype)
        else:   # the owning rank writes its entry
            s_loc = kv_pos.shape[0]
            local = slot - (c.mesh.index(seq) * s_loc if seq else 0)
            own = (local >= 0) & (local < s_loc)
            local = local.clamp(0, s_loc - 1).reshape(1)
            kv_pos[local] = torch.where(own, p.to(kv_pos.dtype),
                                        kv_pos[local])
    x = rms_norm(x, params["final_norm"])
    return _head(x, params, cfg, engine), state


def _require_attention_only(cfg: ArchConfig, what: str):
    _require_decode(cfg)
    if not cfg.has_attention or cfg.has_ssm:
        raise ValueError(
            f"{what} needs a pure-attention family, got {cfg.family!r}")


def prefill_kv(params, cfg: ArchConfig, state, tokens, slot: int = 0,
               engine: DotEngine | None = None):
    """Prefill one slot's KV cache from a prompt in one forward.

    ``tokens``: (L,) prompt.  The per-layer post-rope (k, v), what
    ``decode_step`` would have cached token by token, are written at
    positions [0, L): paged, through the slot's block table (the pages
    must be allocated already, ``PageAllocator.ensure_range``; entries
    of -1 write nothing); contiguous, into the slot's strips at entries
    [0, L) (L must fit them), with ``kv_pos[:L] = 0 .. L-1``.  Returns
    ``(logits (1, L, padded_vocab) f32, state)``: the cache in
    ``state`` is updated **in place** (the returned state is the same
    object).  Pure-attention families (dense, moe: its all-experts
    combine); ssm and hybrid states prefill token by token through
    :func:`decode_step`."""
    engine = engine or DotEngine()
    _require_attention_only(cfg, "prefill_kv")
    paged = state.layout.is_paged
    dev = (state["k_pages"] if paged else state["k"]).device
    toks = torch.as_tensor(tokens, device=dev).to(torch.int64).reshape(1, -1)
    seq = toks.shape[1]
    if paged:
        from repro_torch.serve.paged_kv import pages_needed
        ps = state["k_pages"].shape[1]
        npg = pages_needed(seq, ps)
        if npg > state["block_tables"].shape[1]:
            raise ValueError(f"a {seq}-token prompt outgrows the block table")
    elif seq > state["k"].shape[2]:
        raise ValueError(f"a {seq}-token prompt outgrows the "
                         f"{state['k'].shape[2]}-entry strips")
    x = params["embed"][toks].to(cfg.act_torch_dtype())
    ropes = _layer_ropes(cfg, torch.arange(seq, device=dev))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["norm1"])
        # q_chunk=seq: one exact-softmax chunk for any prompt length
        x, k, v = attn_mod.attention(h, lp["attn"], cfg, engine, *ropes[i],
                                     q_chunk=seq, residual=x,
                                     return_kv=True,
                                     window=cfg.layer_window(i))
        x, _ = _ffn(x, lp, cfg, engine)
        ks.append(k[0])
        vs.append(v[0])
    if paged:
        _write_prompt_pages(state, slot, seq, npg, ks, vs)
    else:
        state["k"][:, slot, :seq] = torch.stack(ks)
        state["v"][:, slot, :seq] = torch.stack(vs)
        state["kv_pos"][:seq] = torch.arange(seq, dtype=torch.int32,
                                             device=dev)
    x = rms_norm(x, params["final_norm"])
    logits = engine.dot(x, params["lm_head"], out_dtype=torch.float32)
    return _mask_padded_vocab(logits, cfg), state


def _write_prompt_pages(state, slot: int, seq: int, npg: int, ks, vs):
    """Scatter a prompt's per-layer K/V into the slot's allocated pages."""
    from repro_torch.serve.paged_kv import physical_rows, zero_row_index

    kp, vp = state["k_pages"], state["v_pages"]
    ps = kp.shape[1]
    bt_row = state["block_tables"][slot, :npg]
    keep = bt_row >= 0
    phys = physical_rows(state["page_perm"], bt_row,
                         zero_row_index(kp))[:, keep].long()  # (L, live)

    def to_pages(a):
        a = torch.stack(a)                           # (L, seq, hkv, dh)
        a = F.pad(a, (0, 0, 0, 0, 0, npg * ps - seq))
        return a.reshape(a.shape[0], npg, ps, *a.shape[2:])[:, keep]

    kp[phys] = to_pages(ks)
    vp[phys] = to_pages(vs)


def prefill_kv_chunk(params, cfg: ArchConfig, state, tokens, slots,
                     starts, lengths, engine: DotEngine | None = None,
                     moe_log=None):
    """Chunked, batched prefill: one prompt chunk per row, written
    through the block tables into the paged pool or into the contiguous
    strips.

    tokens: (G, L) -- G gang rows padded to a common chunk width L;
    slots: (G,) distinct decode-slot ids; starts: (G,) absolute position
    of each row's first token; lengths: (G,) valid tokens per row (pad
    columns, and whole pad rows of length 0, write nothing).  Chunk
    queries attend to the slot's whole written span [0, start + length)
    (earlier chunks are read back from the cache), so chunks interleaved
    with decode steps give the single-shot :func:`prefill_kv` K/V.  On a
    layer with a window W (:meth:`~repro_torch.models.config.ArchConfig.
    layer_window`) a query at position p attends to the keys in
    (p - W, p] only, and the paged layout gathers only the pages that
    hold them: ``ceil((W + L - 1) / page_size) + 1`` a row from the
    row's first page inside the window.  The
    positions written must be covered by allocated pages
    (``PageAllocator.ensure_range``), or lie within the strips (a
    position past them raises: chunked prefill has no ring).

    Only the valid entries (paged: whose page is allocated) are written.
    The reference writes every entry back and keeps the rest unchanged;
    a pad column clamped onto the table's last page, or onto the strips'
    last entry, can alias a valid entry there: an index write with two
    values.  Contiguous, ``kv_pos`` takes the max of itself and each
    valid position at that position's entry, as in the reference (a
    loop on per-row positions never reads it).  Returns the state, whose
    cache is updated **in place** (the same object).  No logits: the
    serving loop samples the first token from a decode step fed the
    prompt's last token.  Pure-attention families, like
    :func:`prefill_kv`; a routed moe routes the valid entries only (pad
    columns and pad rows are not routed), and ``moe_log`` (a
    :class:`~repro_torch.models.moe.MoeLog`) gains their expert counts
    and routes, the valid entries in row-major order."""
    engine = engine or DotEngine()
    _require_attention_only(cfg, "chunked prefill")
    paged = state.layout.is_paged
    kc, vc = (state["k_pages"], state["v_pages"]) if paged \
        else (state["k"], state["v"])
    dev = kc.device
    toks = torch.as_tensor(tokens, device=dev).to(torch.int64)
    g, chunk = toks.shape
    slots_v = torch.as_tensor(slots, device=dev).to(torch.int64).reshape(-1)
    starts_v = torch.as_tensor(starts, device=dev).to(torch.int64).reshape(-1)
    lens_v = torch.as_tensor(lengths, device=dev).to(torch.int64).reshape(-1)
    cols = torch.arange(chunk, device=dev)
    pos2d = starts_v[:, None] + cols                           # (G, L)
    valid = cols[None, :] < lens_v[:, None]
    x = params["embed"][toks].to(cfg.act_torch_dtype())
    ropes = _layer_ropes(cfg, pos2d)                           # (G, L, dh/2)
    scale = 1.0 / math.sqrt(cfg.d_head)
    if paged:
        from repro_torch.serve.paged_kv import physical_rows, zero_row_index
        ps = kc.shape[1]
        bt = state["block_tables"]
        max_pages = bt.shape[1]
        span = max_pages * ps
        pg2d = torch.clamp(pos2d // ps, max=max_pages - 1)
        wmask = valid & (torch.gather(bt[slots_v].long(), 1, pg2d) >= 0)
        # physical rows of every layer: (n_layers, G, max_pages)
        phys_all = physical_rows(state["page_perm"], bt[slots_v],
                                 zero_row_index(kc)).long()
        ent = (pos2d % ps).reshape(-1)
    else:
        span = kc.shape[2]
        # the last valid position of each row (pad rows: -1) must fit
        last = int(torch.where(lens_v > 0, starts_v + lens_v - 1, -1).max())
        if last >= span:
            raise ValueError(f"chunked prefill writes position {last}, past "
                             f"the {span}-entry strips")
        wmask = valid
        ent = pos2d.reshape(-1)
    # the entries written, flattened over (G, L): one host sync a chunk
    wi = wmask.reshape(-1).nonzero().squeeze(1)
    ent = ent[wi]
    # causal over the written extent: key t is visible to the query at
    # position p iff t <= min(p, start + length - 1), and t > p - W on a
    # layer with a window W
    last = torch.minimum(pos2d, (starts_v + lens_v - 1)[:, None])  # (G, L)
    kpos = torch.arange(span, device=dev)[None, None, :]
    masks = {}
    first_page = {}
    for w in {cfg.layer_window(i) for i in range(cfg.n_layers)}:
        if w is None:
            masks[w] = (kpos <= last[:, :, None])[:, None, None]
        elif paged:
            # the window's pages of each row: wp from the row's first
            # page inside the window of its first query (clamped so the
            # gather stays inside the table)
            wp = min(max_pages, -(-(w + chunk - 1) // ps) + 1)
            fp = torch.clamp((starts_v - w + 1) // ps, 0, max_pages - wp)
            pages = fp[:, None] + torch.arange(wp, device=dev)   # (G, wp)
            wpos = (pages[:, :, None] * ps
                    + torch.arange(ps, device=dev)).reshape(g, 1, -1)
            masks[w] = ((wpos <= last[:, :, None])
                        & (wpos > pos2d[:, :, None] - w))[:, None, None]
            first_page[w] = pages
        else:
            masks[w] = ((kpos <= last[:, :, None])
                        & (kpos > pos2d[:, :, None] - w))[:, None, None]
    # the valid entries' flat rows, routed by a routed moe
    moe_rows = wi if cfg.routed_moe else None
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["norm1"])
        w = cfg.layer_window(i)
        q, k, v = attn_mod._project_qkv(h, lp["attn"], cfg, engine,
                                        *ropes[i])
        k_rows = k.reshape(g * chunk, *k.shape[2:])[wi]
        v_rows = v.reshape(g * chunk, *v.shape[2:])[wi]
        if paged:
            phys = phys_all[i]
            rows = torch.gather(phys, 1, pg2d).reshape(-1)[wi]
            kc[rows, ent] = k_rows
            vc[rows, ent] = v_rows
            if w in first_page:
                phys = torch.gather(phys, 1, first_page[w])
            kf = kc[phys].reshape(g, -1, *k.shape[2:])
            vf = vc[phys].reshape(g, -1, *v.shape[2:])
        else:
            rows = slots_v[:, None].expand(g, chunk).reshape(-1)[wi]
            kc[i, rows, ent] = k_rows
            vc[i, rows, ent] = v_rows
            kf = kc[i, slots_v]                                # (G, C, ...)
            vf = vc[i, slots_v]
        o = attn_mod._sdpa(q, kf, vf, masks[w], scale)
        x = engine.dot(o.reshape(g, chunk, -1), lp["attn"]["wo"], residual=x)
        x, _ = _ffn(x, lp, cfg, engine, rows=moe_rows, moe_log=moe_log)
    if not paged:
        kv_pos = state["kv_pos"]
        flat = pos2d.reshape(-1)[wi]
        kv_pos.scatter_reduce_(0, flat, flat.to(kv_pos.dtype), "amax")
    return state


def decode_step(params, cfg: ArchConfig, state, tokens, pos,
                engine: DotEngine | None = None, row_mask=None, rows=None,
                moe_log=None):
    """One decode step.  tokens: (B, 1) int; pos: a scalar position
    shared by every row or a (B,) vector of per-row positions; row_mask
    (B,) bool: rows with False leave the cache untouched.  A routed moe
    (``cfg.routed_moe``) routes only ``rows`` ((n,) int64 indices of the
    live rows; None: all B) and adds their expert counts and routes to
    ``moe_log`` (a :class:`~repro_torch.models.moe.MoeLog`).

    The layout is read off the state: the paged pool (its decode
    kernel) or the contiguous strips, a ring of one window under SWA
    (``slot = pos % c``; a vector ``pos`` then takes each row's
    validity from its own clock, :func:`~repro_torch.models.attention.
    decode_attention`).  The dense and moe families decode in either
    layout (moe through the all-experts combine); ssm and hybrid states
    are contiguous (the hybrid's attention takes no residual, its SSD
    rows and the ssm family's are updated in place).

    Returns (logits (B, 1, padded_vocab) f32, state).  The cache in
    ``state`` is updated **in place** (the returned state is the same
    object); clone the state first to keep the old one."""
    engine = engine or DotEngine()
    _require_decode(cfg)
    step = _decode_step_paged if state.layout.is_paged \
        else _decode_step_contiguous
    return step(params, cfg, state, tokens, pos, engine, row_mask, rows,
                moe_log)

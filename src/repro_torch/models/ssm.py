"""Mamba2 SSD mixer, state-space duality (port of ``repro.models.ssm``).

Chunked SSD form: inside a chunk the recurrence is a masked product
quadratic in the chunk; states pass between chunks by the linear
recurrence

    h_c = (prod decay_c) * h_{c-1} + sum_j decay_{j->end} * dt_j B_j x_j^T
    y_i = C_i h_{c-1} * decay_{0->i}  +  intra-chunk term  +  D * x_i

Decode is the O(1) recurrent update.  One B/C group, a scalar decay
a = -exp(A_log) per head, softplus dt, and a causal depthwise conv of
width 4 ahead of x/B/C, as in the reference.  ``in_proj`` and
``out_proj`` go through the engine (the SFC GEMM); the rest are torch
ops, as they are XLA in the reference.  The reference's sharding
constraints on the chunk views have no counterpart: on a mesh the port
replicates the SSD blocks (``distributed.sharding.param_specs``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import DotEngine, init_linear, init_rms, rms_norm

__all__ = ["init_ssm", "ssd_forward", "ssm_decode", "ssm_state_shape"]

CONV_K = 4  # depthwise conv kernel width


def _dims(cfg):
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state  # x, B, C
    return d_inner, conv_dim


def init_ssm(generator, cfg, dtype=torch.float32, *, lead=(), device=None):
    """The reference's SSD parameters stacked on ``lead``: ``in_proj``
    (d, [z, x, B, C, dt]) and ``out_proj`` normal / sqrt(d_in),
    ``conv_w`` 0.1 * normal, ``A_log`` and ``dt_bias`` zeros and ``D``
    ones in f32, the gate norm ones."""
    d = cfg.d_model
    d_inner, conv_dim = _dims(cfg)
    h = cfg.ssm_heads
    kw = dict(lead=lead, device=device)
    conv = torch.empty((*lead, CONV_K, conv_dim), dtype=dtype, device=device)
    for c in conv.view(-1, CONV_K, conv_dim):
        c.copy_(torch.randn((CONV_K, conv_dim), generator=generator,
                            dtype=torch.float32, device=device) * 0.1)
    return {
        "in_proj": init_linear(generator, d, d_inner + conv_dim + h, dtype,
                               **kw),
        "out_proj": init_linear(generator, d_inner, d, dtype, **kw),
        "conv_w": conv,
        "A_log": torch.zeros((*lead, h), dtype=torch.float32, device=device),
        "D": torch.ones((*lead, h), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((*lead, h), dtype=torch.float32,
                               device=device),
        "norm": init_rms(d_inner, dtype, **kw),
    }


def ssm_state_shape(cfg, batch: int):
    return {
        "h": (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv": (batch, CONV_K - 1, _dims(cfg)[1]),
    }


def _split_proj(proj, cfg):
    d_inner, _ = _dims(cfg)
    n = cfg.ssm_state
    return torch.split(proj, [d_inner, d_inner + 2 * n,
                              proj.shape[-1] - 2 * d_inner - 2 * n], dim=-1)


def _causal_conv(xbc, conv_w):
    """Depthwise causal conv along the sequence, then silu: xbc (B, S,
    C), conv_w (K, C); the K shifted products summed in order."""
    k = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    s = xbc.shape[1]
    out = pad[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * conv_w[i]
    return F.silu(out)


def _softplus(x):
    """log(1 + exp(x)), as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _bf16_round(t):
    """``t`` rounded to bf16 and back to f32."""
    return t.to(torch.bfloat16).float()


def ssd_forward(x, p, cfg, engine: DotEngine, chunk: int = 128):
    """x: (B, S, d) -> (B, S, d), the chunked SSD scan; S must be a
    multiple of min(chunk, S).

    The reference's rounding points are kept: the (B, NC, H, C, C)
    intra-chunk buffer ``att`` and the ``x * dt`` it multiplies are
    rounded to bf16 (in any model dtype) and the product accumulates in
    f32.  The upper triangle of ``exp(cum_i - cum_j)`` is never
    evaluated (the reference evaluates and masks it; at C = 128 it can
    overflow to inf, whose gradient through the mask is NaN): the values
    are the reference's, the gradient stays finite.  The inter-chunk
    recurrence is a loop over the chunks (the reference's associative
    scan: the same terms, f32 reassociation only)."""
    b, s, _ = x.shape
    h, ph, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner, _ = _dims(cfg)
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of ssd_chunk {c}")
    nc = s // c

    proj = engine.dot(x, p["in_proj"])
    z, xbc, dt = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc, p["conv_w"])
    xs, bs, cs = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = xs.reshape(b, s, h, ph)
    dt = _softplus(dt.float() + p["dt_bias"])                   # (B,S,H)
    logdec = dt * -torch.exp(p["A_log"])                        # <= 0

    xs_c = xs.reshape(b, nc, c, h, ph)
    bs_c = bs.reshape(b, nc, c, n).float()
    cs_c = cs.reshape(b, nc, c, n).float()
    dt_c = dt.reshape(b, nc, c, h)
    cum = torch.cumsum(logdec.reshape(b, nc, c, h), dim=2)     # (B,NC,C,H)
    total = cum[:, :, -1, :]                                    # (B,NC,H)

    # intra-chunk: att[h,i,j] = (C_i . B_j) exp(cum_i - cum_j), i >= j
    cum_h = cum.permute(0, 1, 3, 2)                             # (B,NC,H,C)
    ldiff = cum_h[..., :, None] - cum_h[..., None, :]           # (B,NC,H,C,C)
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(ldiff.masked_fill(~mask, float("-inf")))
    cb = torch.einsum("bgin,bgjn->bgij", cs_c, bs_c)            # (B,NC,C,C)
    att = _bf16_round(cb[:, :, None] * lmat)
    xdt = xs_c.float() * dt_c[..., None]                        # (B,NC,C,H,P)
    y_intra = torch.einsum("bghij,bgjhp->bgihp", att, _bf16_round(xdt))

    # chunk states: sum_j exp(total - cum_j) B_j xdt_j
    decay_to_end = torch.exp(total[:, :, None, :] - cum)       # (B,NC,C,H)
    sb = torch.einsum("bgjh,bgjn,bgjhp->bghpn", decay_to_end, bs_c, xdt)
    a_c = torch.exp(total)                                      # (B,NC,H)
    hprev = [torch.zeros_like(sb[:, 0])]
    for g in range(nc - 1):
        hprev.append(hprev[-1] * a_c[:, g, :, None, None] + sb[:, g])
    hprevs = torch.stack(hprev, dim=1)                          # (B,NC,H,P,N)

    y_inter = torch.einsum("bgin,bghpn->bgihp", cs_c, hprevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, ph)
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return engine.dot(y, p["out_proj"])


def ssm_decode(x, p, cfg, engine: DotEngine, state, row_mask=None):
    """One-token recurrent decode.  x: (B, 1, d); state: {"h" (B, H, P,
    N) f32, "conv" (B, K-1, conv_dim)}.  ``row_mask`` (B,) bool: masked
    rows keep their previous state.  Returns (out (B, 1, d), new
    state); the old state is not modified."""
    b = x.shape[0]
    h, ph, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner, _ = _dims(cfg)

    proj = engine.dot(x, p["in_proj"])[:, 0]                    # (B, proj)
    z, xbc, dt = _split_proj(proj, cfg)
    # conv over the ring of the last K-1 inputs and the current one
    conv_in = torch.cat([state["conv"], xbc[:, None, :]], dim=1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_in, p["conv_w"]))
    new_conv = conv_in[:, 1:, :]
    xs, bs, cs = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = xs.reshape(b, h, ph).float()
    dt = _softplus(dt.float() + p["dt_bias"])                   # (B, H)
    dec = torch.exp(dt * -torch.exp(p["A_log"]))                # (B, H)
    bx = torch.einsum("bhp,bn->bhpn", xs * dt[..., None], bs.float())
    h_new = state["h"] * dec[..., None, None] + bx
    y = torch.einsum("bn,bhpn->bhp", cs.float(), h_new)
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = engine.dot(y, p["out_proj"])[:, None, :]
    if row_mask is not None:
        h_new = torch.where(row_mask[:, None, None, None], h_new, state["h"])
        new_conv = torch.where(row_mask[:, None, None], new_conv,
                               state["conv"])
    return out, {"h": h_new, "conv": new_conv}

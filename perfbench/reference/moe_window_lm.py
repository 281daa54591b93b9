"""Plain PyTorch reference of a routed moe decoder whose layers mix
sliding-window and full attention, as the serving loop runs it: float32
throughout, TF32 off, no kernel, cache or batching of the program, a
layer at a time so that it fits beside the weights.

The block (the configuration's ``arch``): x + o(attn(rms(x))), then
x + moe(rms(x)).  RMS norm with ``rms_eps``, scaled by its weight.
Attention: causal softmax at scale ``1 / sqrt(dh)``, query head j
reading kv head ``j // (H / Hkv)``; on a layer whose ``layer_types``
entry is ``sliding_attention`` a key at position j is visible to the
query at position i iff i - ``sliding_window`` < j <= i.  Rotary
embedding over the whole head (its two halves rotated): sliding layers
at frequencies ``rope_theta ** (-2 i / dh)``; full layers with YaRN
(``yarn``: ``factor``, ``original_max_position_embeddings`` = orig,
``beta_fast``, ``beta_slow``, ``attention_factor``):
``find(b) = dh ln(orig / (2 pi b)) / (2 ln theta)``, low =
``max(floor(find(beta_fast)), 0)``, high = ``min(ceil(find(beta_slow)),
dh - 1)``, ``ramp_i = clamp((i - low) / (high - low), 0, 1)``, frequency
``(1 - ramp_i) f_i + ramp_i f_i / factor``, and cos and sin times
``attention_factor``.  The moe: softmax over the ``experts`` f32 router
logits, the ``top_k`` largest (ties to the lower index), renormalised;
or, where ``routes`` gives a layer's experts for each position (how the
program routed them), those experts with their renormalised
probabilities; each token through exactly its top-k SwiGLU experts,
``w2_e(silu(w1_e h) * w3_e h)``, weighted and summed (dropless: nothing
is capped).  A final RMS norm and the vocab head, whose columns past
``vocab`` are masked.  The weights are the raw tensors the benchmark
drew, read and converted here; nothing the program derived from them is
used.

Serving protocol (the configuration's ``serving`` block): the loop
prefills a prompt of L tokens at positions 0..L-1 and then feeds the
prompt's last token again, at position L, to sample the first new
token; new token i is fed at position L + 1 + i.  So the logits that
chose new token i are those at position L + i of the sequence
``prompt + [prompt[-1]] + new[:-1]``.

``precision="fp8"`` is the control: every matrix product (projections,
router, experts, head, both attention products) takes its operands
rounded to float8 e4m3, scaled per row of the left operand and per
column of the right one, and multiplies them in float32.
"""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["served_logits", "forward_logits", "gap_report", "fed_sequence",
           "yarn_frequencies", "routing"]

_E4M3_MAX = 448.0
_Q_BLOCK = 1024  # query rows a step of the attention


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Round to e4m3 with one scale per slice along ``dim`` (the
    reduction axis), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / _E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., K) @ b (..., K, N) in float32."""
    if precision == "fp8":
        a, b = _fp8(a, -1), _fp8(b, -2)
    return torch.matmul(a, b)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn_frequencies(dh: int, theta: float, yarn: dict) -> torch.Tensor:
    """The (dh / 2,) YaRN frequencies of the module docstring, float64
    arithmetic rounded once to float32."""
    half = dh // 2

    def find(b):
        return dh * math.log(yarn["original_max_position_embeddings"]
                             / (2 * math.pi * b)) / (2 * math.log(theta))

    low = max(math.floor(find(yarn["beta_fast"])), 0)
    high = min(math.ceil(find(yarn["beta_slow"])), dh - 1)
    if high == low:
        high += 0.001
    out = []
    for i in range(half):
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        f = theta ** (-2.0 * i / dh)
        out.append((1 - ramp) * f + ramp * f / yarn["factor"])
    return torch.tensor(out, dtype=torch.float32)


def _rope_tables(arch: dict, kind: str, pos: torch.Tensor):
    """cos, sin (S, 1, dh / 2) of a layer kind at positions ``pos``."""
    dh, theta = arch["d_head"], arch["rope_theta"]
    if kind == "full_attention" and arch.get("yarn"):
        freqs = yarn_frequencies(dh, theta, arch["yarn"]).to(pos.device)
        af = arch["yarn"]["attention_factor"]
    else:
        half = dh // 2
        freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                        device=pos.device) * 2 / dh)
        freqs = freqs.float()
        af = 1.0
    ang = pos.float()[:, None] * freqs
    return (torch.cos(ang) * af)[:, None], (torch.sin(ang) * af)[:, None]


def _rope(x, cos, sin):
    """x (S, heads, dh)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, window, precision):
    """q (S, H, dh), k/v (S, Hkv, dh): causal, GQA, under ``window``
    (None: every earlier key); queries a block at a time."""
    s, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)      # (H, S, dh)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = []
    for a in range(0, s, _Q_BLOCK):
        b = min(s, a + _Q_BLOCK)
        lo = 0 if window is None else max(0, a - window + 1)
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(lo, b, device=q.device)[None, :]
        ok = kj <= qi
        if window is not None:
            ok &= kj > qi - window
        scores = _mm(q[a:b].transpose(0, 1), k[:, lo:b].transpose(1, 2),
                     precision) / math.sqrt(dh)
        scores = scores.masked_fill(~ok, float("-inf"))
        w = torch.softmax(scores, dim=-1)
        out.append(_mm(w, v[:, lo:b], precision).transpose(0, 1))
    return torch.cat(out, dim=0)


def routing(h: torch.Tensor, router: torch.Tensor, top_k: int,
            precision: str = "f32"):
    """(weights (S, k), experts (S, k)) of rows ``h`` (S, d): softmax of
    the f32 logits, the top-k by a stable descending sort, renormalised."""
    probs = torch.softmax(_mm(h, router.float(), precision), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    return w / w.sum(-1, keepdim=True), idx


def _moe(h, moe: dict, i: int, top_k: int, precision: str, idx=None):
    """The layer's dropless top-k experts on rows h (S, d): its own top-k,
    or the (S, k) experts ``idx``."""
    if idx is None:
        w, idx = routing(h, moe["router"][i], top_k, precision)
    else:
        probs = torch.softmax(_mm(h, moe["router"][i].float(), precision), -1)
        w = probs.gather(1, idx)
        w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        he = h[tok]
        u = torch.nn.functional.silu(_mm(he, moe["w1"][i, e].float(),
                                         precision)) \
            * _mm(he, moe["w3"][i, e].float(), precision)
        y.index_add_(0, tok, _mm(u, moe["w2"][i, e].float(), precision)
                     * w[tok, slot][:, None])
    return y


def fed_sequence(prompt: list[int], new: list[int]) -> list[int]:
    """The tokens the loop fed, in position order, to choose ``new``."""
    return list(prompt) + [prompt[-1]] + list(new[:-1])


@torch.no_grad()
def _hidden(weights: dict, arch: dict, seqs: list, precision: str,
            on_layer=None, routes=None) -> list[torch.Tensor]:
    """The final-normed hidden rows of each token sequence (S, d);
    ``on_layer(i, j, h)``, when given, sees the moe input of sequence j
    at layer i; ``routes``, when given, holds per sequence an (n_layers,
    S, k) array of the experts each position takes."""
    eps = arch["rms_eps"]
    h, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    window = arch["sliding_window"]
    with _no_tf32():
        xs = [weights["embed"][s].float() for s in seqs]
        pos = [torch.arange(len(s), device=s.device) for s in seqs]
        lay = weights["layers"]
        for i in range(arch["n_layers"]):
            kind = arch["layer_types"][i]
            win = window if kind == "sliding_attention" else None
            at = {k: v[i].float() for k, v in lay["attn"].items()}
            n1, n2 = lay["norm1"][i].float(), lay["norm2"][i].float()
            for j, x in enumerate(xs):
                cos, sin = _rope_tables(arch, kind, pos[j])
                a = _rms(x, n1, eps)
                q = _rope(_mm(a, at["wq"], precision).view(-1, h, dh),
                          cos, sin)
                k = _rope(_mm(a, at["wk"], precision).view(-1, hkv, dh),
                          cos, sin)
                v = _mm(a, at["wv"], precision).view(-1, hkv, dh)
                o = _attention(q, k, v, win, precision).reshape(len(x), h * dh)
                x = x + _mm(o, at["wo"], precision)
                m = _rms(x, n2, eps)
                if on_layer is not None:
                    on_layer(i, j, m)
                idx = None if routes is None else torch.as_tensor(
                    routes[j][i], device=m.device).long()
                xs[j] = x + _moe(m, lay["moe"], i, arch["top_k"], precision,
                                 idx)
            del at
        fn = weights["final_norm"].float()
        return [_rms(x, fn, eps) for x in xs]


@torch.no_grad()
def forward_logits(weights: dict, arch: dict, tokens: list[int],
                   precision: str = "f32") -> torch.Tensor:
    """The float32 logits (S, vocab) of one token sequence."""
    seq = torch.tensor(tokens, dtype=torch.long,
                       device=weights["embed"].device)
    x = _hidden(weights, arch, [seq], precision)[0]
    with _no_tf32():
        return _mm(x, weights["lm_head"].float(),
                   precision)[:, :arch["vocab"]]


@torch.no_grad()
def served_logits(weights: dict, arch: dict, requests: list[tuple],
                  precision: str = "f32", on_layer=None, routes=None
                  ) -> list[torch.Tensor]:
    """For each (prompt, new tokens) request, the float32 logits
    (len(new), vocab) that chose its new tokens.  ``weights`` holds the
    benchmark's tensors in the program's layout: ``embed`` (Vp, d),
    ``lm_head`` (d, Vp), ``final_norm`` (d,), and ``layers`` with
    ``norm1``, ``norm2`` (L, d), ``attn`` ``wq``/``wk``/``wv``/``wo`` and
    ``moe`` ``router`` (L, d, E), ``w1``/``w3`` (L, E, d, F), ``w2``
    (L, E, F, d), stacked on a leading layer axis.  ``on_layer`` and
    ``routes``: as :func:`_hidden`'s, over the fed sequences."""
    dev = weights["embed"].device
    seqs = [torch.tensor(fed_sequence(p, n), dtype=torch.long, device=dev)
            for p, n in requests]
    xs = _hidden(weights, arch, seqs, precision, on_layer, routes)
    head = weights["lm_head"].float()
    out = []
    with _no_tf32():
        for (p, n), x in zip(requests, xs):
            out.append(_mm(x[len(p):], head, precision)[:, :arch["vocab"]])
    return out


def gap_report(ref_logits: list[torch.Tensor], chosen: list) -> dict:
    """The widest gap by which a chosen token's reference logit lies
    below the reference's best, over every position of every request;
    ``chosen`` holds per request the chosen token ids, or float logits
    whose argmax is the choice."""
    widest, n = 0.0, 0
    for ref, ch in zip(ref_logits, chosen):
        if isinstance(ch, torch.Tensor) and ch.is_floating_point():
            ch = ch.argmax(-1)
        ch = torch.as_tensor(ch, device=ref.device).long()
        gaps = ref.max(-1).values - ref.gather(1, ch[:, None])[:, 0]
        gaps = torch.nan_to_num(gaps, nan=float("inf"))
        n += len(gaps)
        widest = max(widest, float(gaps.max()))
    return {"max_gap": widest, "tokens": n}

"""Plain PyTorch reference of the dense decoder as the serving loop runs
it: float32 throughout, TF32 off, no kernel, cache or batching of the
program, a layer at a time so that it fits beside the weights.

The block (the configuration's ``arch``): x + o(attn(rms(x))), then
x + w2(silu(w1 h) * w3 h) with h = rms(x); RMS norm with ``rms_eps``,
scaled by its weight; rotary embedding over the whole head (its two
halves rotated, frequencies ``rope_theta ** (-i / (dh / 2))``); causal
softmax attention at scale ``1 / sqrt(dh)``, query head j reading kv
head ``j // (H / Hkv)``; a final RMS norm and the vocab head, whose
columns past ``vocab`` are masked.  The weights are the raw tensors the
benchmark drew, read and converted here; nothing the program derived
from them is used.

Serving protocol (the configuration's ``serving`` block): the loop
prefills a prompt of L tokens at positions 0..L-1 and then feeds the
prompt's last token again, at position L, to sample the first new
token; new token i is fed at position L + 1 + i.  So the logits that
chose new token i are those at position L + i of the sequence
``prompt + [prompt[-1]] + new[:-1]``.

``precision="fp8"`` is the control: every matrix product (projections,
head, both attention products) takes its operands rounded to float8
e4m3, scaled per row of the left operand and per column of the right
one, and multiplies them in float32.
"""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["served_logits", "gap_report", "fed_sequence"]

_E4M3_MAX = 448.0


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


def _rope(x, pos, theta):
    """x (S, heads, dh) at positions pos (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, precision):
    """q (S, H, dh), k/v (S, Hkv, dh): causal, GQA."""
    s, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = _mm(q.transpose(0, 1), k.permute(1, 2, 0), precision)
    scores = scores / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return _mm(w, v.transpose(0, 1), precision).transpose(0, 1)


def fed_sequence(prompt: list[int], new: list[int]) -> list[int]:
    """The tokens the loop fed, in position order, to choose ``new``."""
    return list(prompt) + [prompt[-1]] + list(new[:-1])


@torch.no_grad()
def served_logits(weights: dict, arch: dict, requests: list[tuple],
                  precision: str = "f32") -> list[torch.Tensor]:
    """For each (prompt, new tokens) request, the float32 logits
    (len(new), vocab) that chose its new tokens.  ``weights`` holds the
    benchmark's tensors in the program's layout: ``embed`` (Vp, d),
    ``lm_head`` (d, Vp), ``final_norm`` (d,), and ``layers`` with
    ``norm1``, ``norm2`` (L, d), ``attn`` ``wq``/``wk``/``wv``/``wo`` and
    ``mlp`` ``w1``/``w3``/``w2`` stacked on a leading layer axis."""
    dev = weights["embed"].device
    eps, theta = arch["rms_eps"], arch["rope_theta"]
    h, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    seqs = [torch.tensor(fed_sequence(p, n), dtype=torch.long, device=dev)
            for p, n in requests]
    with _no_tf32():
        xs = [weights["embed"][s].float() for s in seqs]
        pos = [torch.arange(len(s), device=dev) for s in seqs]
        lay = weights["layers"]
        for i in range(arch["n_layers"]):
            at = {k: v[i].float() for k, v in lay["attn"].items()}
            ml = {k: v[i].float() for k, v in lay["mlp"].items()}
            n1, n2 = lay["norm1"][i].float(), lay["norm2"][i].float()
            for j, x in enumerate(xs):
                a = _rms(x, n1, eps)
                q = _rope(_mm(a, at["wq"], precision).view(-1, h, dh),
                          pos[j], theta)
                k = _rope(_mm(a, at["wk"], precision).view(-1, hkv, dh),
                          pos[j], theta)
                v = _mm(a, at["wv"], precision).view(-1, hkv, dh)
                o = _attention(q, k, v, precision).reshape(len(x), h * dh)
                x = x + _mm(o, at["wo"], precision)
                m = _rms(x, n2, eps)
                u = torch.nn.functional.silu(_mm(m, ml["w1"], precision)) \
                    * _mm(m, ml["w3"], precision)
                xs[j] = x + _mm(u, ml["w2"], precision)
            del at, ml
        head = weights["lm_head"].float()
        fn = weights["final_norm"].float()
        out = []
        for (p, n), x in zip(requests, xs):
            rows = _rms(x[len(p):], fn, eps)
            logits = _mm(rows, head, precision)[:, :arch["vocab"]]
            out.append(logits)
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

"""Plain PyTorch versions of the SFC GEMMs, their epilogue and paged
decode attention (port of ``repro.kernels.ref``), and a plain mirror of
the paged attention kernel's cluster split.

They are the CPU path of the kernel wrappers, the yardstick that
``chip_smoke.py`` holds each CUDA kernel against on the card, and, for
``matmul_fused_ref`` and ``matmul_batched_fused_ref``, the
``schedule="xla"`` library baselines.  On the
card a float32 yardstick needs ``torch.backends.cuda.matmul.allow_tf32 =
False`` (the PyTorch default, which ``chip_smoke.py`` sets explicitly).
"""
from __future__ import annotations

import math

import torch

__all__ = ["ACTIVATIONS", "apply_activation", "activation_grad",
           "apply_epilogue_ref",
           "matmul_ref", "matmul_batched_ref", "matmul_fused_ref",
           "matmul_batched_fused_ref", "matmul_blocked_ref",
           "paged_decode_attention_ref", "attn_live_pages",
           "attn_first_page", "attn_page_ranges",
           "paged_decode_attention_split_ref"]

# epilogue activations the fused kernel supports
ACTIVATIONS = ("none", "relu", "gelu", "silu")

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def apply_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Elementwise activation of the fused epilogue; gelu is the tanh
    approximation, as in the reference and in the CUDA kernel."""
    if activation == "none":
        return x
    if activation == "relu":
        return torch.clamp_min(x, 0)
    if activation == "gelu":
        return x * (0.5 * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + 0.044715 * (x ** 3)))))
    if activation == "silu":
        return x * torch.sigmoid(x)
    raise ValueError(
        f"unknown activation {activation!r}; choose from {ACTIVATIONS}")


def activation_grad(z: torch.Tensor, activation: str) -> torch.Tensor:
    """d activation(z) / dz, elementwise in z's dtype (f32 in the
    gradient of the fused GEMM): relu's is 1 where z >= 0 (torch's
    ``clamp_min`` rule), silu's s (1 + z (1 - s)) with s = sigmoid(z),
    gelu's that of the tanh approximation above."""
    if activation == "none":
        return torch.ones_like(z)
    if activation == "relu":
        return (z >= 0).to(z.dtype)
    if activation == "silu":
        s = torch.sigmoid(z)
        return s * (1.0 + z * (1.0 - s))
    if activation == "gelu":
        t = torch.tanh(_SQRT_2_OVER_PI * (z + 0.044715 * (z ** 3)))
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * (
            _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * (z * z)))
    raise ValueError(
        f"unknown activation {activation!r}; choose from {ACTIVATIONS}")


def apply_epilogue_ref(acc: torch.Tensor, bias=None, activation: str = "none",
                       residual=None, out_dtype=None) -> torch.Tensor:
    """out = act(acc + bias) + residual, computed in f32, then one cast."""
    acc = acc.float()
    if bias is not None:
        acc = acc + bias.float()
    acc = apply_activation(acc, activation)
    if residual is not None:
        acc = acc + residual.float()
    return acc.to(out_dtype) if out_dtype is not None else acc


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """f32-accumulated matmul, the semantics every GEMM kernel matches."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def matmul_batched_ref(a: torch.Tensor, b: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """f32-accumulated batched matmul (``bij,bjk->bik`` over any leading
    dims), the semantics ``sfc_matmul_batched`` matches."""
    return matmul_ref(a, b, out_dtype)


def matmul_fused_ref(a: torch.Tensor, b: torch.Tensor, bias=None,
                     activation: str = "none", residual=None,
                     out_dtype=None) -> torch.Tensor:
    """dot -> bias -> activation -> residual -> cast, f32 throughout."""
    out_dtype = out_dtype or a.dtype
    acc = torch.matmul(a.float(), b.float())
    return apply_epilogue_ref(acc, bias, activation, residual, out_dtype)


def matmul_batched_fused_ref(a: torch.Tensor, b: torch.Tensor, bias=None,
                             activation: str = "none", residual=None,
                             out_dtype=None) -> torch.Tensor:
    """Batched ``matmul_fused_ref``; bias (N,) broadcasts over all leading
    dims, residual matches the (..., M, N) output shape."""
    return matmul_fused_ref(a, b, bias, activation, residual, out_dtype)


def matmul_blocked_ref(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
                       bk: int, order, out_dtype=None) -> torch.Tensor:
    """Loop-nest oracle that accumulates block by block in the given
    output tile ``order``: the schedule changes the result by f32
    addition order at most (k order is fixed per tile)."""
    out_dtype = out_dtype or a.dtype
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"bad GEMM operands {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    kt = k // bk
    out = torch.zeros(m, n, dtype=torch.float32, device=a.device)
    for (i, j) in order:
        i, j = int(i), int(j)
        acc = torch.zeros(bm, bn, dtype=torch.float32, device=a.device)
        for kk in range(kt):
            ab = a[i * bm:(i + 1) * bm, kk * bk:(kk + 1) * bk]
            bb = b[kk * bk:(kk + 1) * bk, j * bn:(j + 1) * bn]
            acc += torch.matmul(ab.float(), bb.float())
        out[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] = acc
    return out.to(out_dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               phys_tables: torch.Tensor,
                               cur_pos, window: int | None = None
                               ) -> torch.Tensor:
    """Gather-then-softmax paged decode attention.

    q: (B, H, dh); k_pages/v_pages: (R, page_size, Hkv, dh) physical
    pool whose last row is the reserved zero row; phys_tables:
    (B, max_pages) physical rows; cur_pos: newest valid position, a
    scalar or a (B,) vector; ``window``: only the keys at positions >
    cur_pos - window count (None: all up to cur_pos).  Scores are taken
    in the cache dtype and
    widened to f32, and the softmax weights are cast back to the value
    dtype before P.V, exactly as the reference does.
    """
    b, h, dh = q.shape
    _, page_size, hkv, _ = k_pages.shape
    g = h // hkv
    max_pages = phys_tables.shape[1]
    span = max_pages * page_size
    idx = phys_tables.long()
    k = k_pages[idx].reshape(b, span, hkv, dh)
    v = v_pages[idx].reshape(b, span, hkv, dh)
    pos = torch.as_tensor(cur_pos, device=q.device).to(torch.int64)
    pos = pos.reshape(-1).expand(b)
    t = torch.arange(span, device=q.device)[None, :]
    valid = t <= pos[:, None]
    if window is not None:
        valid = valid & (t > pos[:, None] - window)
    qg = q.reshape(b, hkv, g, dh)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(dh))
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v)
    return out.reshape(b, h, dh)


def attn_live_pages(pos: int, page_size: int, max_pages: int) -> int:
    """Pages of a slot the paged attention kernel reads: those with
    ``p * page_size <= pos``, at most the table's ``max_pages`` (a stale
    position past the table reads every page); none for ``pos < 0``."""
    return 0 if pos < 0 else min(pos // page_size + 1, max_pages)


def attn_first_page(pos: int, page_size: int, window: int | None,
                    live: int) -> int:
    """The first page the paged attention kernel reads for a slot: 0, or
    under a ``window`` the page of position pos - window + 1, at most
    ``live`` (csrc: first)."""
    if window is None or pos - window + 1 <= 0:
        return 0
    return min((pos - window + 1) // page_size, live)


def attn_page_ranges(live: int, split: int,
                     first: int = 0) -> list[tuple[int, int]]:
    """[lo, hi) of the live pages [first, live) each cluster rank of the
    paged attention kernel takes: contiguous, in rank order, sizes
    differing by at most one; ranks past the pages get an empty range
    (csrc: lo, hi)."""
    n = live - first
    return [(first + r * n // split, first + (r + 1) * n // split)
            for r in range(split)]


def paged_decode_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     phys_tables: torch.Tensor, cur_pos,
                                     split: int,
                                     window: int | None = None
                                     ) -> torch.Tensor:
    """The paged attention kernel's split in plain PyTorch.

    Arguments as :func:`paged_decode_attention_ref`.  Each of ``split``
    ranks runs an f32 online softmax, page by page, over its
    :func:`attn_page_ranges` share of the slot's :func:`attn_live_pages`
    from its :func:`attn_first_page` (scores and weights in f32, masked
    positions, past ``cur_pos`` or below the window, weight 0; an empty rank
    keeps m = -1e30, l = 0, acc = 0); then the ranks are merged in rank
    order (global max, rescale, sum) and ``acc / l`` is cast once to the
    value dtype.  Tests hold it to the reference; the card's path never
    calls it."""
    b, h, dh = q.shape
    _, page_size, hkv, _ = k_pages.shape
    g = h // hkv
    max_pages = phys_tables.shape[1]
    pos = torch.as_tensor(cur_pos, device=q.device).to(torch.int64)
    pos = pos.reshape(-1).expand(b)
    ranges = []
    for p in pos.tolist():
        live = attn_live_pages(p, page_size, max_pages)
        ranges.append(attn_page_ranges(
            live, split, attn_first_page(p, page_size, window, live)))
    ranges = torch.tensor(ranges, device=q.device)     # (b, split, 2)
    low = pos - window if window is not None else torch.full_like(pos, -1)
    qg = q.float().reshape(b, hkv, g, dh)
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    offs = torch.arange(page_size, device=q.device)
    ranks = []
    for r in range(split):
        lo, hi = ranges[:, r, 0], ranges[:, r, 1]
        m = torch.full((b, hkv, g), -1e30, device=q.device)
        l = torch.zeros(b, hkv, g, device=q.device)
        acc = torch.zeros(b, hkv, g, dh, device=q.device)
        for i in range(int((hi - lo).max())):
            p = lo + i
            rows = phys_tables.gather(
                1, p.clamp(max=max_pages - 1)[:, None])[:, 0].long()
            kk = k_pages[rows].float()                 # (b, ps, hkv, dh)
            vv = v_pages[rows].float()
            s = torch.einsum("bhgd,bthd->bhgt", qg, kk) * scale
            t = p[:, None] * page_size + offs
            ok = (p < hi)[:, None] & (t <= pos[:, None]) & (t > low[:, None])
            ok = ok[:, None, None, :]
            s = torch.where(ok, s, torch.full_like(s, -1e30))
            mn = torch.maximum(m, s.amax(-1))
            a = torch.exp(m - mn)
            w = torch.where(ok, torch.exp(s - mn[..., None]),
                            torch.zeros_like(s))
            l = l * a + w.sum(-1)
            acc = acc * a[..., None] + torch.einsum("bhgt,bthd->bhgd", w, vv)
            m = mn
        ranks.append((m, l, acc))
    big_m = torch.stack([m for m, _, _ in ranks]).amax(0)
    big_l = torch.zeros_like(big_m)
    big_a = torch.zeros_like(ranks[0][2])
    for m, l, acc in ranks:
        f = torch.exp(m - big_m)
        big_l = big_l + l * f
        big_a = big_a + acc * f[..., None]
    out = big_a / big_l[..., None]
    return out.reshape(b, h, dh).to(v_pages.dtype)

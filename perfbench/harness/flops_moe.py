"""Operations and bytes in closed form for a routed moe decoder whose
layers mix sliding-window and full attention (the ``arch`` block of a
configuration whose driver is ``serve_moe``), from its shapes and the
work the harness saw done.  Nothing here reads the program.

Per layer a token is a row of the attention projections q (d x H dh), k
and v (d x Hkv dh), o (H dh x d) and of the router (d x E, float32), and
of its top-k experts' SwiGLU, each 2 x 3 x d x F operations (w1, w3 and
w2); experts it is not routed to, and pad rows, are no work.  Attention:
a query row at a context of c keys costs 4 c dh H a layer, where c is
``min(keys, window)`` on a window layer.  The vocab head only for a row
whose logits are computed.
"""
from __future__ import annotations

from .flops import gemm_least_s
from .peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_S

__all__ = ["attn_projections", "window_of", "attention_keys",
           "token_flops", "prefill_flops", "kv_bytes", "rows_least_s",
           "expert_least_s", "params"]


def attn_projections(arch: dict) -> list[tuple[str, int, int]]:
    """(name, K, N) of one layer's attention GEMMs."""
    d, h, hkv = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    dh = arch["d_head"]
    return [("wq", d, h * dh), ("wk", d, hkv * dh), ("wv", d, hkv * dh),
            ("wo", h * dh, d)]


def window_of(arch: dict, i: int) -> int | None:
    """Layer i's window (None: full attention)."""
    return arch["sliding_window"] \
        if arch["layer_types"][i] == "sliding_attention" else None


def attention_keys(arch: dict, keys: int) -> int:
    """Keys a query row at a context of ``keys`` reads, summed over the
    layers (a window layer reads at most its window)."""
    return sum(keys if window_of(arch, i) is None
               else min(keys, window_of(arch, i))
               for i in range(arch["n_layers"]))


def _row_flops(arch: dict) -> float:
    """A routed row's operations in every layer, attention aside."""
    d, e, f, k = (arch["d_model"], arch["experts"], arch["expert_dim"],
                  arch["top_k"])
    proj = sum(kk * nn for _, kk, nn in attn_projections(arch))
    return arch["n_layers"] * 2.0 * (proj + d * e + k * 3 * d * f)


def token_flops(arch: dict, keys: int, head: bool) -> float:
    """Useful operations of one token at a context of ``keys`` keys: the
    projections, the router, its top-k experts, the attention and, where
    its logits are computed, the head."""
    att = 4.0 * arch["d_head"] * arch["n_heads"] * attention_keys(arch, keys)
    hd = 2.0 * arch["d_model"] * arch["padded_vocab"] if head else 0.0
    return _row_flops(arch) + att + hd


def _keys_sum(c0: int, c1: int, window: int | None) -> int:
    """Sum of min(c, window) over contexts c = c0 .. c1 - 1."""
    if window is None or c1 <= window:
        return (c1 * (c1 - 1) - c0 * (c0 - 1)) // 2
    if c0 >= window:
        return (c1 - c0) * window
    return _keys_sum(c0, window, None) + (c1 - window) * window


def prefill_flops(arch: dict, a: int, take: int) -> float:
    """Prompt positions a .. a + take - 1 (position p has p + 1 keys)."""
    keys = sum(_keys_sum(a + 1, a + take + 1, window_of(arch, i))
               for i in range(arch["n_layers"]))
    return take * _row_flops(arch) \
        + 4.0 * arch["d_head"] * arch["n_heads"] * keys


def kv_bytes(arch: dict, keys: int, dtype_bytes: int) -> float:
    """The K and V one decode row must read at a context of ``keys``
    keys, every layer (a window layer only its window's)."""
    return (2.0 * arch["n_kv_heads"] * arch["d_head"] * dtype_bytes
            * attention_keys(arch, keys))


def rows_least_s(arch: dict, rows: int, head: bool, in_bytes: int) -> float:
    """Least time of B1's GEMMs of one step over ``rows`` useful rows:
    the attention projections (bf16), the router (float32 in and out,
    at the float32 peak) in every layer, and the head (f32 out)."""
    if rows <= 0:
        return 0.0
    per = sum(gemm_least_s(rows, k, n, in_bytes, in_bytes, BF16_FLOPS)
              for _, k, n in attn_projections(arch))
    per += gemm_least_s(rows, arch["d_model"], arch["experts"], 4, 4,
                        F32_FLOPS)
    t = arch["n_layers"] * per
    if head:
        t += gemm_least_s(rows, arch["d_model"], arch["padded_vocab"],
                          in_bytes, 4, BF16_FLOPS)
    return t


def expert_least_s(arch: dict, tokens: int, touched: int,
                   in_bytes: int) -> float:
    """Least time of B5 in one moe layer of one step: ``tokens`` routed
    rows (``tokens x top_k`` assignments) of which ``touched`` experts
    got at least one.  The larger of the assignments' 2 x 3 x d x F
    operations at the bf16 peak and the bytes these inputs need at HBM's:
    the weights of each touched expert once, the rows in (d) and the
    hidden rows out and in (2 F) in bf16, and the outputs (d) in float32."""
    if tokens <= 0:
        return 0.0
    d, f = arch["d_model"], arch["expert_dim"]
    r = tokens * arch["top_k"]
    ops = 2.0 * r * 3 * d * f
    byts = touched * 3.0 * d * f * in_bytes + r * (d * in_bytes
                                                   + 2 * f * in_bytes
                                                   + 4 * d)
    return max(ops / BF16_FLOPS, byts / HBM_BYTES_S)


def params(arch: dict) -> tuple[int, int]:
    """(all, active a token) parameters: embedding, head, attention,
    router and experts (norm scales aside)."""
    d, e, f, k = (arch["d_model"], arch["experts"], arch["expert_dim"],
                  arch["top_k"])
    attn = sum(kk * nn for _, kk, nn in attn_projections(arch))
    emb = 2 * arch["vocab"] * d
    n = arch["n_layers"]
    return (emb + n * (attn + d * e + e * 3 * d * f),
            emb + n * (attn + d * e + k * 3 * d * f))

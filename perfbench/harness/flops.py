"""Operations and bytes in closed form, from a configuration's shapes and
the work the harness saw done.  Nothing here reads the program: a change
to the program cannot change how its work is counted.

Dense decoder (the ``arch`` block of a configuration file): per layer
the projections q (d x H dh), k and v (d x Hkv dh), o (H dh x d), and
the SwiGLU MLP's w1 and w3 (d x d_ff) and w2 (d_ff x d); then the vocab
head (d x V).  A token is a row of every projection (2 K N operations a
GEMM); the head only for a row whose logits are computed.  Attention: a
query row at a context of c keys costs 2 c dh a head for the scores and
as much again for the weighted values, so 4 c dh H a layer.
"""
from __future__ import annotations

from .peaks import HBM_BYTES_S

__all__ = ["projections", "head_shape", "nonembed_params", "token_flops",
           "attention_flops", "gemm_least_s", "rows_least_s",
           "kv_bytes", "bmm_flops", "bmm_bytes", "bmm_least_s"]


def projections(arch: dict) -> list[tuple[str, int, int]]:
    """(name, K, N) of one layer's GEMMs."""
    d, h, hkv = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    dh, dff = arch["d_head"], arch["d_ff"]
    return [("wq", d, h * dh), ("wk", d, hkv * dh), ("wv", d, hkv * dh),
            ("wo", h * dh, d), ("w1", d, dff), ("w3", d, dff),
            ("w2", dff, d)]


def head_shape(arch: dict) -> tuple[int, int]:
    return arch["d_model"], arch["padded_vocab"]


def nonembed_params(arch: dict) -> int:
    """The layers' projection weights (norm scales are no GEMM work)."""
    return arch["n_layers"] * sum(k * n for _, k, n in projections(arch))


def attention_flops(arch: dict, keys: int) -> float:
    """One query row against ``keys`` keys, every layer."""
    return 4.0 * keys * arch["d_head"] * arch["n_heads"] * arch["n_layers"]


def token_flops(arch: dict, keys: int, head: bool) -> float:
    """Useful operations of one token: every projection, the attention
    at its context of ``keys`` keys and, where its logits are computed,
    the head."""
    d, v = head_shape(arch)
    return (2.0 * nonembed_params(arch) + (2.0 * d * v if head else 0.0)
            + attention_flops(arch, keys))


def gemm_least_s(m: int, k: int, n: int, in_bytes: int, out_bytes: int,
                 peak_flops: float, bw: float = HBM_BYTES_S) -> float:
    """The least time an (m x k) @ (k x n) GEMM can take: the larger of
    its operations at the peak and its bytes (each operand read once, the
    output written once) at the memory's peak."""
    if m <= 0:
        return 0.0
    ops = 2.0 * m * k * n
    byts = (m * k + k * n) * in_bytes + m * n * out_bytes
    return max(ops / peak_flops, byts / bw)


def rows_least_s(arch: dict, rows: int, head: bool, in_bytes: int,
                 peak_flops: float) -> float:
    """Least time of every projection GEMM (and the head, f32 out) of one
    step over ``rows`` useful rows."""
    per_layer = sum(gemm_least_s(rows, k, n, in_bytes, in_bytes, peak_flops)
                    for _, k, n in projections(arch))
    t = arch["n_layers"] * per_layer
    if head:
        d, v = head_shape(arch)
        t += gemm_least_s(rows, d, v, in_bytes, 4, peak_flops)
    return t


def kv_bytes(arch: dict, keys: int, dtype_bytes: int) -> float:
    """The K and V one decode row must read at a context of ``keys``
    keys, every layer."""
    return (2.0 * keys * arch["n_kv_heads"] * arch["d_head"] * dtype_bytes
            * arch["n_layers"])


def bmm_flops(b: int, n: int) -> float:
    """A batch of b square n x n x n GEMMs."""
    return 2.0 * b * n ** 3


def bmm_bytes(b: int, n: int, dtype_bytes: int) -> float:
    """A, B read once and C written once, each b n^2 elements."""
    return 3.0 * b * n * n * dtype_bytes


def bmm_least_s(b: int, n: int, dtype_bytes: int, peak_flops: float,
                bw: float = HBM_BYTES_S) -> float:
    return max(bmm_flops(b, n) / peak_flops,
               bmm_bytes(b, n, dtype_bytes) / bw)

"""Error-feedback gradient compression for the cross-pod sync (port of
``repro.optim.compress``).

Gradients crossing the slow pod link are compressed to bf16 with an
error-feedback residual, so the quantization error is re-injected the
next step (Karimireddy et al. 2019).  The train step keeps one residual
per pod (``launch/steps.py``).
"""
from __future__ import annotations

import torch

__all__ = ["ef_compress", "init_ef_state"]


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_ef_state(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def ef_compress(grads, ef_state, dtype=torch.bfloat16):
    """Returns (compressed grads in ``dtype``, new residual): ``c =
    dtype(g + r)`` and ``r' = (g + r) - f32(c)``, in f32."""
    def one(g, r):
        corrected = g.to(torch.float32) + r
        c = corrected.to(dtype)
        return c, corrected - c.to(torch.float32)

    pairs = _map(one, grads, ef_state)
    return _map(lambda t: t[0], pairs), _map(lambda t: t[1], pairs)

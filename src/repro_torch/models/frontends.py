"""Model inputs (port of ``repro.models.frontends``).

:func:`make_batch` draws the reference's arrays with the reference's
numpy calls, so a seed gives the same tokens, labels, frame features
and vision embeddings.  Per the reference, the encoder's and the vlm's
modality frontends are stubs: the batch carries *precomputed* frame or
patch embeddings of the documented width, which ``frontend_proj`` maps
into the model.  The abstract batch of the reference's dry-run waits
for the distributed slice (ROADMAP.md queue A, A15)."""
from __future__ import annotations

import numpy as np
import torch

from .config import SHAPES, ArchConfig, ShapeSpec

__all__ = ["make_batch"]


def _tokens(shape, seed: int, maxval: int, device):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, maxval, size=shape, dtype=np.int32)
    return torch.from_numpy(arr).to(device)


def _normal(shape, seed: int, dtype: torch.dtype, device):
    """Standard normal draws in ``dtype``.  The reference draws f64 and
    lets ``jnp.asarray`` cast them: with 64-bit values off that rounds to
    f32 first, then to the activation dtype.  One f64 -> bf16 rounding
    can land a bit away from that, so the draws take the same two
    steps."""
    arr = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                       dtype=dtype)


def make_batch(cfg: ArchConfig, shape: ShapeSpec | str, *, seed: int = 0,
               device=None) -> dict:
    """A training or prefill batch of (batch, seq) on ``device`` (the
    CPU when None).  Token families: ``tokens`` from ``seed`` and
    ``labels`` from ``seed + 1``, int32.  Encoder: ``features`` (batch,
    seq, frontend_dim) from ``seed`` in the activation dtype and
    ``labels``.  Vlm: the tokens and labels, ``vision_embeds`` (batch,
    nv, frontend_dim) from ``seed + 2`` with ``nv = min(frontend_tokens,
    seq // 2)``, and an f32 ``loss_mask`` that is 0 over the first nv
    positions (the image's) and 1 after."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    dt = cfg.act_torch_dtype()
    if cfg.family == "encoder":
        return {"features": _normal((b, s, cfg.frontend_dim), seed, dt,
                                    device),
                "labels": _tokens((b, s), seed + 1, cfg.vocab, device)}
    batch = {"tokens": _tokens((b, s), seed, cfg.vocab, device),
             "labels": _tokens((b, s), seed + 1, cfg.vocab, device)}
    if cfg.family == "vlm":
        nv = min(cfg.frontend_tokens, s // 2)
        batch["vision_embeds"] = _normal((b, nv, cfg.frontend_dim),
                                         seed + 2, dt, device)
        mask = torch.ones((b, s), dtype=torch.float32, device=device)
        mask[:, :nv] = 0.0
        batch["loss_mask"] = mask
    return batch

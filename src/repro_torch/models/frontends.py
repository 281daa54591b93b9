"""Model inputs (port of ``repro.models.frontends``, the token families).

:func:`make_batch` draws the reference's arrays with the reference's
numpy calls, so a seed gives the same tokens and labels.  The modality
stubs (the encoder's ``features``, the vlm's ``vision_embeds``) come
with their families, and the abstract batch of the reference's dry-run
with the distributed slice (ROADMAP.md queue A, A11 and A15)."""
from __future__ import annotations

import numpy as np
import torch

from .config import SHAPES, ArchConfig, ShapeSpec

__all__ = ["make_batch"]


def _tokens(shape, seed: int, maxval: int, device):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, maxval, size=shape, dtype=np.int32)
    return torch.from_numpy(arr).to(device)


def make_batch(cfg: ArchConfig, shape: ShapeSpec | str, *, seed: int = 0,
               device=None) -> dict:
    """A training or prefill batch: ``tokens`` from ``seed`` and
    ``labels`` from ``seed + 1``, int32 (batch, seq) tensors on
    ``device`` (the CPU when None)."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if cfg.family in ("encoder", "vlm"):
        raise NotImplementedError(
            f"make_batch for family {cfg.family!r} (its frontend stub) is "
            f"not ported yet (ROADMAP.md queue A, A11)")
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _tokens((b, s), seed, cfg.vocab, device),
            "labels": _tokens((b, s), seed + 1, cfg.vocab, device)}

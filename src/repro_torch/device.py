"""Device resolution for the port's entry points.

Entry points (``init_model``, ``ServeLoop``, the CLI) run on the card
unless the caller asks for the CPU: ``device=None`` means ``cuda``, and
a machine without a usable CUDA device raises instead of dropping to the
CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (or raise); otherwise the named device, which
    must exist.  ``cpu`` and ``cuda`` are supported, and ``meta``
    (shapes and dtypes without storage: the builders' abstract
    states)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return dev
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

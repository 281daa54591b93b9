"""Parameters from the reference: ``jax.tree.map(np.asarray, params)``
of ``repro.models.init_model`` -> the port's parameter tree, with the
same names and the stacked ``n_layers`` axis.  No JAX is imported: the
input is nested dicts of numpy arrays (bfloat16 arrays arrive with the
``bfloat16`` numpy extension dtype and are reinterpreted bit for bit).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(arr, *, device=None, dtype=None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(np_tree, *, device, dtype=None):
    """Convert a nested dict of numpy arrays into torch tensors on
    ``device`` (cast to ``dtype`` when given)."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device=device, dtype=dtype)
                for k, v in np_tree.items()}
    return tensor_from_numpy(np_tree, device=device, dtype=dtype)

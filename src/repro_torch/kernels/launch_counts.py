"""The kernel wrappers' launch counters, in one registry.

Each wrapper keeps its launch counts as module globals
(``sfc_matmul.launches``, ``paged_attention.window_launches`` ...),
bumps them where it launches and registers their names here when it is
imported.  Code that moves every counter at once -- a decode graph
restores them after its warm-up and capture, and adds a replay's
launches -- goes through :func:`snapshot`, :func:`restore` and
:func:`add`, so a counter a wrapper adds is moved with the others."""
from __future__ import annotations

import sys

__all__ = ["register", "snapshot", "restore", "add", "delta"]

# "module.counter" -> (module name, global name), in registration order
_COUNTERS: dict[str, tuple[str, str]] = {}


def register(module: str, *names: str) -> None:
    """Register the launch counters ``names``, globals of ``module``
    (its ``__name__``)."""
    for name in names:
        _COUNTERS[f"{module.rsplit('.', 1)[-1]}.{name}"] = (module, name)


def snapshot() -> dict[str, int]:
    """Every registered counter's value, by ``module.counter``."""
    return {k: getattr(sys.modules[m], n) for k, (m, n) in _COUNTERS.items()}


def restore(values: dict[str, int]) -> None:
    """Set the counters in ``values`` (a :func:`snapshot`) back."""
    for k, v in values.items():
        m, n = _COUNTERS[k]
        setattr(sys.modules[m], n, v)


def add(deltas: dict[str, int]) -> None:
    """Add ``deltas`` (a :func:`delta`) to the counters."""
    restore({k: v + deltas.get(k, 0) for k, v in snapshot().items()})


def delta(before: dict[str, int]) -> dict[str, int]:
    """Each counter's move since ``before`` (a :func:`snapshot`; a
    counter registered since counts from 0)."""
    return {k: v - before.get(k, 0) for k, v in snapshot().items()}

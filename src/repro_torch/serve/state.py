"""Decode-state container with an explicit KV-cache layout (port of
``repro.serve.state``): a plain dict-like Mapping that carries its
:class:`KVLayout`, so the decode step dispatches on the layout instead
of sniffing key names."""
from __future__ import annotations

import enum
from collections.abc import Mapping
from typing import Any

__all__ = ["KVLayout", "DecodeState", "resolve_layout"]


class KVLayout(enum.Enum):
    """CONTIGUOUS: per-slot ``cache_len`` strips.  PAGED: the shared
    Morton-ordered page pool with per-slot block tables."""

    CONTIGUOUS = "contiguous"
    PAGED = "paged"

    @property
    def is_paged(self) -> bool:
        return self is KVLayout.PAGED


def resolve_layout(layout: "KVLayout | str | None") -> KVLayout:
    """A layout from the enum or its name (CLI plumbing); None means
    CONTIGUOUS, as in the reference."""
    if layout is None:
        return KVLayout.CONTIGUOUS
    if isinstance(layout, str):
        return KVLayout(layout.lower())
    return KVLayout(layout)


class DecodeState(Mapping):
    """Dict of decode-cache tensors plus the :class:`KVLayout`."""

    __slots__ = ("_data", "layout")

    def __init__(self, data: Mapping[str, Any],
                 layout: KVLayout = KVLayout.CONTIGUOUS):
        self._data = dict(data)
        self.layout = layout

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def clone(self) -> "DecodeState":
        """Deep copy of every tensor (the decode step updates the pool
        in place)."""
        return DecodeState({k: v.clone() for k, v in self._data.items()},
                           self.layout)

    def __repr__(self) -> str:
        return (f"DecodeState(layout={self.layout.name}, "
                f"keys={sorted(self._data)})")


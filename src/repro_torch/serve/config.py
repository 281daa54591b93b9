"""ServeLoop configuration (port of ``repro.serve.config``, the fields of
the lockstep paged path only)."""
from __future__ import annotations

from dataclasses import dataclass

from .state import KVLayout, resolve_layout

__all__ = ["ServeConfig"]


@dataclass(frozen=True)
class ServeConfig:
    """What the serving loop is parameterised by.

    ``mode="lockstep"``: a request's whole prompt is prefilled at
    admission, live slots decode together.  ``layout`` is the
    :class:`~repro_torch.serve.state.KVLayout` (names accepted);
    ``page_size``/``num_pages`` shape the paged pool.  Continuous
    batching and the contiguous layout are not ported yet and raise.
    Unlike the reference, the default layout is PAGED: it is the only
    one the port serves.
    """

    slots: int = 4
    cache_len: int = 128
    temperature: float = 0.0
    eos_id: int = 1
    seed: int = 0
    layout: KVLayout = KVLayout.PAGED
    page_size: int = 8
    num_pages: int | None = None
    mode: str = "lockstep"

    def __post_init__(self):
        object.__setattr__(self, "layout", resolve_layout(self.layout))
        if self.mode not in ("lockstep", "continuous"):
            raise ValueError(
                f"mode must be 'lockstep' or 'continuous', got {self.mode!r}")
        if self.mode == "continuous":
            raise NotImplementedError(
                "continuous batching is not ported yet (ROADMAP.md queue A "
                "item 9); use mode='lockstep'")
        if not self.layout.is_paged:
            raise NotImplementedError(
                "the contiguous KV layout is not ported yet (ROADMAP.md "
                "queue A item 7); use layout='paged'")
        if self.slots < 1 or self.cache_len < 1 or self.page_size < 1:
            raise ValueError((self.slots, self.cache_len, self.page_size))


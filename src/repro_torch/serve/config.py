"""ServeConfig (port of ``repro.serve.config``, the fields of the paged
lockstep and continuous paths only)."""
from __future__ import annotations

from dataclasses import dataclass

from .state import KVLayout, resolve_layout

__all__ = ["ServeConfig"]


@dataclass(frozen=True)
class ServeConfig:
    """What the serving loop is parameterised by.

    ``mode="lockstep"``: a request's whole prompt is prefilled at
    admission, live slots decode together.  ``mode="continuous"``:
    requests join and leave mid-flight, their prompts prefilled in
    chunks of at most ``prefill_budget`` tokens per step, interleaved
    with decode.  ``prefix_sharing`` (continuous only) maps page-aligned
    common prompt prefixes onto shared pages with copy-on-write; it
    changes memory behaviour, never tokens.  ``layout`` is the
    :class:`~repro_torch.serve.state.KVLayout` (names accepted);
    ``page_size``/``num_pages`` shape the paged pool.  The contiguous
    layout is not ported yet and raises.  Unlike the reference, the
    default layout is PAGED: it is the only one the port serves.
    ``objective`` ("time", "energy" or "edp"), when set, routes the
    loop's GEMMs through the tuner under that metric and resolves the
    DVFS points its energy accounting uses.
    """

    slots: int = 4
    cache_len: int = 128
    temperature: float = 0.0
    eos_id: int = 1
    seed: int = 0
    objective: str | None = None
    layout: KVLayout = KVLayout.PAGED
    page_size: int = 8
    num_pages: int | None = None
    mode: str = "lockstep"
    prefill_budget: int = 32
    prefix_sharing: bool = True

    def __post_init__(self):
        object.__setattr__(self, "layout", resolve_layout(self.layout))
        if self.mode not in ("lockstep", "continuous"):
            raise ValueError(
                f"mode must be 'lockstep' or 'continuous', got {self.mode!r}")
        if not self.layout.is_paged:
            raise NotImplementedError(
                "the contiguous KV layout is not ported yet (ROADMAP.md "
                "queue A item 7); use layout='paged'")
        if self.slots < 1 or self.cache_len < 1 or self.page_size < 1:
            raise ValueError((self.slots, self.cache_len, self.page_size))
        if self.prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {self.prefill_budget}")

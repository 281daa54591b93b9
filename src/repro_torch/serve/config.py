"""ServeConfig (port of ``repro.serve.config``: both KV layouts, lockstep
and continuous, observability and fault tolerance)."""
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
    :class:`~repro_torch.serve.state.KVLayout` (names accepted; default
    CONTIGUOUS, per-slot ``cache_len`` strips, as in the reference);
    ``page_size``/``num_pages`` shape the paged pool.  ``objective`` ("time", "energy" or "edp"), when set, routes the
    loop's GEMMs through the tuner under that metric and resolves the
    DVFS points its energy accounting uses.

    Observability: ``latency_slo_ms`` is the time-to-first-token target
    the loop counts per-request SLO attainment against (requests carry
    arrival stamps through ``ServeLoop.submit``); ``None`` turns SLO
    accounting off, while TTFT, TPOT and end-to-end latency are still
    recorded.  ``obs=False`` makes the metrics and spans no-ops.

    Fault tolerance: ``fault_guards`` arms the NaN/Inf logit quarantine
    and the straggler watchdog (there is no kernel fallback to arm);
    ``deadline_ms`` is each request's end-to-end budget from arrival --
    an expired request finishes with an error instead of holding a
    slot.  ``max_step_retries`` bounds the replays of a scheduler
    iteration that raised a transient (injected) fault, backing off
    exponentially from ``retry_backoff_s``; ``snapshot_every`` and
    ``snapshot_dir`` set the serve-state snapshot cadence (default:
    every iteration under chaos, else none) and its optional copy on
    disk through the checkpoint store.  ``shed_occupancy`` and
    ``shed_violation_rate`` are load-shedding watermarks: while the
    pool's occupancy or the SLO-violation rate is at or above one,
    queued requests finish with an error instead of being admitted.
    ``chaos`` is a fault-injection schedule
    (:func:`repro_torch.runtime.chaos.parse_chaos_spec`).  Defaults and
    validation are the reference's.
    """

    slots: int = 4
    cache_len: int = 128
    temperature: float = 0.0
    eos_id: int = 1
    seed: int = 0
    objective: str | None = None
    layout: KVLayout = KVLayout.CONTIGUOUS
    page_size: int = 8
    num_pages: int | None = None
    mode: str = "lockstep"
    prefill_budget: int = 32
    prefix_sharing: bool = True
    latency_slo_ms: float | None = None
    obs: bool = True
    fault_guards: bool = True
    deadline_ms: float | None = None
    max_step_retries: int = 2
    retry_backoff_s: float = 0.02
    snapshot_every: int | None = None
    snapshot_dir: str | None = None
    shed_occupancy: float | None = None
    shed_violation_rate: float | None = None
    chaos: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "layout", resolve_layout(self.layout))
        if self.mode not in ("lockstep", "continuous"):
            raise ValueError(
                f"mode must be 'lockstep' or 'continuous', got {self.mode!r}")
        if self.slots < 1 or self.cache_len < 1 or self.page_size < 1:
            raise ValueError((self.slots, self.cache_len, self.page_size))
        if self.prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {self.prefill_budget}")
        if self.latency_slo_ms is not None and self.latency_slo_ms <= 0:
            raise ValueError(
                f"latency_slo_ms must be > 0 (or None to disable SLO "
                f"accounting), got {self.latency_slo_ms}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0 (or None to disable "
                f"deadlines), got {self.deadline_ms}")
        if self.max_step_retries < 0 or self.retry_backoff_s < 0:
            raise ValueError(
                (self.max_step_retries, self.retry_backoff_s))
        if self.snapshot_every is not None and self.snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {self.snapshot_every}")
        for name in ("shed_occupancy", "shed_violation_rate"):
            v = getattr(self, name)
            if v is not None and not (0 < v <= 1):
                raise ValueError(
                    f"{name} must be a watermark in (0, 1], got {v}")

    @property
    def paged(self) -> bool:
        return self.layout.is_paged

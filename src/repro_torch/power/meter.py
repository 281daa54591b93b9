"""EnergyMeter: measure joules around a region of code (port of
``repro.power.meter``).

Context manager and decorator over a
:class:`~repro_torch.power.backends.PowerBackend`:

    with EnergyMeter("step", backend=NvmlBackend(), flops=2 * n * t) as em:
        run_step()
    em.reading.joules, em.reading.edp, em.reading.joules_per_flop

Meters nest: an inner meter's reading is attached to the enclosing
meter's ``children``.  An :class:`~repro_torch.power.report.
EnergyReport` passed as ``reporter`` collects every top-level reading.
A backend whose ``start`` raises gives a zero-joule reading and counts
``power.faults``, and so does an injected ``power`` chaos event
(:func:`repro_torch.runtime.chaos.fire`, checked in ``__enter__`` on
the caller's thread, never on a backend's sampling thread).  A
top-level reading's joules land on the innermost open trace span of
the calling thread (:func:`repro_torch.obs.trace.attribute_energy`), so
a trace's span joules sum to the report's total.

The meter reads the counter on the host clock; it does not synchronise
the device.  A caller metering asynchronous CUDA work synchronises
before the region ends (``repro_torch.launch.serve.ServeLoop`` does).
"""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field

from repro_torch.obs.trace import attribute_energy
from repro_torch.runtime.chaos import fire as _chaos_fire

from .backends import PowerBackend, WorkloadHints, detect_backend

__all__ = ["EnergyReading", "EnergyMeter", "default_backend"]

# sentinel token for an interval whose backend failed to *start* (a
# dying counter or an injected ``power`` chaos event): the interval
# still times, reads zero joules, and never calls backend.stop --
# graceful degradation, metered on the ``power.faults`` counter
_START_FAILED = object()


def _count_power_fault() -> None:
    from repro_torch.obs import default_registry
    default_registry().counter("power.faults").inc()

_DEFAULT_BACKEND: PowerBackend | None = None


def default_backend() -> PowerBackend:
    """Process-wide auto-detected backend (memoised)."""
    global _DEFAULT_BACKEND
    if _DEFAULT_BACKEND is None:
        _DEFAULT_BACKEND = detect_backend()
    return _DEFAULT_BACKEND


@dataclass
class EnergyReading:
    """One metered interval: joules by domain plus derived figures."""

    label: str
    backend: str
    seconds: float
    domains: dict[str, float]
    joules: float               # sum over non-overlapping primary domains
    flops: float = 0.0
    children: list["EnergyReading"] = field(default_factory=list)

    @property
    def watts(self) -> float:
        return self.joules / self.seconds if self.seconds > 0 else 0.0

    @property
    def edp(self) -> float:
        """Energy-delay product (J*s), the paper's efficiency/speed blend."""
        return self.joules * self.seconds

    @property
    def joules_per_flop(self) -> float | None:
        return self.joules / self.flops if self.flops > 0 else None

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "backend": self.backend,
            "seconds": self.seconds,
            "joules": self.joules,
            "watts": self.watts,
            "edp": self.edp,
            "joules_per_flop": self.joules_per_flop,
            "flops": self.flops,
            "domains": dict(self.domains),
            "children": [c.to_dict() for c in self.children],
        }


# per-thread stack of currently-open meters: an exiting meter attaches
# its reading to the one below it (nesting produces a telemetry tree).
# Thread-local so concurrent meters (e.g. a prefetch thread vs the step
# loop) cannot corrupt each other's nesting or swallow reporter adds.
_STACKS = threading.local()


def _active() -> list["EnergyMeter"]:
    if not hasattr(_STACKS, "stack"):
        _STACKS.stack = []
    return _STACKS.stack


class EnergyMeter:
    """Meter a region (``with``) or every call of a function (decorator).

    ``hints`` (or the ``flops=...``/``hbm_bytes=...`` shorthand kwargs)
    describe the metered workload for the model backend and the derived
    J/FLOP.  Readings accumulate on :attr:`readings`; :attr:`reading` is
    the most recent one.  Re-entrant: the same instance may be entered
    recursively (each interval gets its own reading).
    """

    def __init__(self, label: str = "region", *,
                 backend: PowerBackend | None = None,
                 hints: WorkloadHints | None = None,
                 reporter=None, **hint_kwargs):
        if hints is not None and hint_kwargs:
            raise TypeError("pass hints= or hint kwargs, not both")
        if hint_kwargs:
            hints = WorkloadHints(**hint_kwargs)
        self.label = label
        self.backend = backend if backend is not None else default_backend()
        self.hints = hints
        self.reporter = reporter
        self.readings: list[EnergyReading] = []
        self.reading: EnergyReading | None = None
        # one record per open interval: [token, t0, children-so-far]
        self._open: list[list] = []

    # ---------------------------------------------------------- ctx manager
    def __enter__(self) -> "EnergyMeter":
        try:
            _chaos_fire("power")
            token = self.backend.start()
        except Exception:  # degrade: meter the time, skip the joules
            token = _START_FAILED
            _count_power_fault()
        self._open.append([token, time.perf_counter(), []])
        _active().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        token, t0, children = self._open.pop()
        elapsed = time.perf_counter() - t0
        try:
            domains = {} if token is _START_FAILED else \
                self.backend.stop(token, elapsed, self.hints)
        except Exception:  # a dying counter must not mask the real error
            domains = {}
            _count_power_fault()
        primary = getattr(self.backend, "primary_domains", ()) or \
            tuple(domains)
        total = sum(domains.get(d, 0.0) for d in primary)
        r = EnergyReading(
            label=self.label, backend=self.backend.name, seconds=elapsed,
            domains=domains, joules=total,
            flops=self.hints.flops if self.hints else 0.0,
            children=children)
        self.reading = r
        self.readings.append(r)
        active = _active()
        if active and active[-1] is self:
            active.pop()  # with-blocks unwind LIFO
        else:
            active.remove(self)
        if active:
            # attach to the enclosing meter's innermost open interval
            active[-1]._open[-1][2].append(r)
        if not active:
            # a top-level reading's joules land on the innermost open
            # trace span of this thread; nested readings ride inside
            # their parent's total, so attributing them would count twice
            attribute_energy(r.joules, r.seconds)
        if self.reporter is not None and not active:
            self.reporter.add(r)
        elif (self.reporter is not None and active
              and active[-1].reporter is not self.reporter):
            # nested reading rides along inside its parent; report it
            # directly only if the parent reports elsewhere (different
            # reporter) or not at all
            self.reporter.add(r)

    # ------------------------------------------------------------ decorator
    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        wrapper.meter = self
        return wrapper

"""Deterministic fault injection for the serving path (port of
``repro.runtime.chaos``).

Chaos runs must be *reproducible*: an injected failure schedule is data
(step / request / probability with a fixed seed), not a monkeypatch, so
the same spec replays the same faults and a test can hold the
surviving requests' tokens to a fault-free run's.  A spec with a seed
fires the same events at the same steps as the reference's.

Named injection points (``fire(point)``) are registered inside the
subsystems a real fault would hit:

* ``alloc``     -- :meth:`repro_torch.serve.paged_kv.PageAllocator._pop_free`
                   (page-pool metadata corruption / allocation fault)
* ``kernel``    -- the serve loop's decode step (matched at its top,
                   before any launch) and the paged decode attention
                   kernel's host wrapper, just before its launch
                   (``repro_torch.kernels.paged_attention``)
* ``step``      -- the top of a ``ServeLoop`` scheduler iteration
* ``nan``       -- decode logits poisoned with NaN for one request
                   (consumed by the loop's quarantine guard, not raised)
* ``straggler`` -- an injected per-step delay (consumed by the loop)
* ``power``     -- :class:`repro_torch.power.EnergyMeter`'s backend start
                   (a dying energy counter)

Raising points throw :class:`InjectedFault` (a :class:`TransientFault`):
the serve loop's bounded-retry machinery restores the last snapshot and
replays.  Only ``TransientFault`` is retried -- genuine bugs
(``PoolExhausted`` on an undersized pool, extent overflow, a CUDA
error) keep failing loudly; nothing turns one into a ``TransientFault``.

Deep code reaches the injector through the module-level hook
(:func:`install` + :func:`fire`): the loop installs its injector for the
duration of ``run()`` and stamps the ambient step each iteration, so the
allocator and the kernel wrapper need no plumbing and cost one
thread-local read when chaos is off.
"""
from __future__ import annotations

import contextlib
import random
import threading
from dataclasses import dataclass

__all__ = ["ChaosEvent", "ChaosInjector", "InjectedFault",
           "TransientFault", "parse_chaos_spec", "install", "active",
           "set_context", "fire"]

POINTS = ("alloc", "kernel", "step", "nan", "straggler", "power")


class TransientFault(RuntimeError):
    """A failure the serve loop may retry (restore + replay).  Anything
    else that escapes a step is a genuine bug and propagates."""

    point: str = "step"


class InjectedFault(TransientFault):
    """Raised by a chaos injection point."""

    def __init__(self, point: str, detail: str = ""):
        super().__init__(f"injected {point} fault"
                         + (f" ({detail})" if detail else ""))
        self.point = point


@dataclass
class ChaosEvent:
    """One scheduled fault.  ``step``/``request`` are match conditions
    (a ``step`` event fires at the first check whose ambient step is
    >= ``step`` -- robust to retries shifting iteration counts);
    ``p`` makes the event probabilistic under the injector's seeded RNG;
    ``times`` bounds total firings; ``seconds`` parameterises straggler
    delays."""

    point: str
    step: int | None = None
    request: int | None = None
    p: float | None = None
    times: int = 1
    seconds: float = 0.25
    fired: int = 0

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown chaos point {self.point!r}; one of {POINTS}")


class ChaosInjector:
    """A deterministic schedule of :class:`ChaosEvent`.  ``match``
    consumes and returns the first matching event (None otherwise);
    ``check`` raises :class:`InjectedFault` instead -- the form the
    raising injection points use."""

    def __init__(self, events, seed: int = 0):
        self.events = list(events)
        self.rng = random.Random(seed)
        self.fired: list[tuple[str, int | None, int | None]] = []

    def match(self, point: str, step: int | None = None,
              request: int | None = None) -> ChaosEvent | None:
        for ev in self.events:
            if ev.point != point or ev.fired >= ev.times:
                continue
            if ev.step is not None and (step is None or step < ev.step):
                continue
            if ev.request is not None and request != ev.request:
                continue
            if ev.p is not None and self.rng.random() >= ev.p:
                continue
            ev.fired += 1
            self.fired.append((point, step, request))
            return ev
        return None

    def check(self, point: str, step: int | None = None,
              request: int | None = None) -> None:
        ev = self.match(point, step=step, request=request)
        if ev is not None:
            raise InjectedFault(
                point, f"step={step}" if step is not None else "")

    def exhausted(self) -> bool:
        return all(ev.fired >= ev.times for ev in self.events)


def parse_chaos_spec(spec: str, seed: int = 0) -> ChaosInjector:
    """CLI schedule syntax: comma-separated events, each
    ``point[@key=value[:key=value...]]`` with keys ``step``, ``req``,
    ``p``, ``times``, ``delay`` --

        --chaos "alloc@step=2,nan@step=3:req=1,straggler@step=4:delay=0.5"
    """
    events = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        point, _, rest = part.partition("@")
        kw: dict = {"point": point.strip()}
        keys = {"step": ("step", int), "req": ("request", int),
                "p": ("p", float), "times": ("times", int),
                "delay": ("seconds", float)}
        for item in filter(None, rest.split(":")):
            k, _, v = item.partition("=")
            if k.strip() not in keys:
                raise ValueError(
                    f"unknown chaos key {k!r} in {part!r}; "
                    f"one of {sorted(keys)}")
            name, cast = keys[k.strip()]
            kw[name] = cast(v)
        events.append(ChaosEvent(**kw))
    if not events:
        raise ValueError(f"empty chaos spec {spec!r}")
    return ChaosInjector(events, seed=seed)


# ----------------------------------------------------- module-level hook ----
# Thread-local so a chaos serve loop in one thread cannot leak faults
# into another loop (or the tests running in parallel workers).
_LOCAL = threading.local()


def active() -> ChaosInjector | None:
    return getattr(_LOCAL, "injector", None)


def set_context(**ctx) -> None:
    """Stamp ambient match context (``step=...``) for subsequent
    :func:`fire` calls from code with no injector plumbing."""
    if active() is not None:
        _LOCAL.ctx = {**getattr(_LOCAL, "ctx", {}), **ctx}


def fire(point: str, **ctx_override) -> None:
    """Raise :class:`InjectedFault` if the installed injector has a
    matching event.  No-op (one attribute read) when chaos is off."""
    inj = active()
    if inj is None:
        return
    ctx = {**getattr(_LOCAL, "ctx", {}), **ctx_override}
    inj.check(point, step=ctx.get("step"), request=ctx.get("request"))


@contextlib.contextmanager
def install(injector: ChaosInjector | None):
    """Install ``injector`` as this thread's ambient chaos source for
    the duration of the block (None: no-op)."""
    if injector is None:
        yield None
        return
    prev = getattr(_LOCAL, "injector", None)
    prev_ctx = getattr(_LOCAL, "ctx", {})
    _LOCAL.injector = injector
    _LOCAL.ctx = {}
    try:
        yield injector
    finally:
        _LOCAL.injector = prev
        _LOCAL.ctx = prev_ctx

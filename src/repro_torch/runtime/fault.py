"""Fault tolerance for training and serving (port of
``repro.runtime.fault``): retrying step execution, straggler detection,
and the deterministic failure injection that stands in for hardware
faults.

Transient step failures (preemption, a lost device) restore the last
checkpoint and replay; stragglers are flagged by a step-time EMA.  The
control plane is host code, exercised by the tests on the CPU.  The
elastic re-mesh after a permanent node loss is ``runtime/elastic.py``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["FailureInjector", "InjectedFailure", "StepExecutor",
           "StragglerMonitor"]


class InjectedFailure(RuntimeError):
    pass


class FailureInjector:
    """Deterministic failure schedule: {step: kind}."""

    def __init__(self, schedule: dict[int, str] | None = None):
        self.schedule = dict(schedule or {})
        self.fired: list[tuple[int, str]] = []

    def check(self, step: int):
        kind = self.schedule.pop(step, None)
        if kind is not None:
            self.fired.append((step, kind))
            raise InjectedFailure(f"{kind} @ step {step}")


@dataclass
class StragglerMonitor:
    """EMA step-time watchdog: flags steps slower than ``factor`` x EMA."""
    factor: float = 3.0
    alpha: float = 0.2
    warmup: int = 3
    ema: float = 0.0
    seen: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.seen <= self.warmup:
            self.ema = dt if self.ema == 0 else \
                (1 - self.alpha) * self.ema + self.alpha * dt
            return False
        slow = dt > self.factor * self.ema
        if slow:
            self.events.append((step, dt, self.ema))
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


class StepExecutor:
    """Run steps with retry-from-checkpoint semantics.

    ``restore_fn(step) -> state`` reloads the last good state;
    ``step_fn(state, step) -> state`` runs one step.  On failure the
    executor restores and replays.  ``max_retries`` bounds repeated
    failures of the *same* step.  Retries and restores count on the
    ``train.retries`` and ``train.restores`` counters of ``metrics``
    (the process registry by default); each restore is a
    ``train.restore`` span.
    """

    def __init__(self, step_fn, restore_fn, max_retries: int = 2,
                 monitor: StragglerMonitor | None = None,
                 injector: FailureInjector | None = None,
                 metrics=None):
        from repro_torch.obs import default_registry
        self.step_fn = step_fn
        self.restore_fn = restore_fn
        self.max_retries = max_retries
        self.monitor = monitor or StragglerMonitor()
        self.injector = injector
        self.retries: list[tuple[int, str]] = []
        # a silent retry looks like a healthy run in every dashboard
        m = metrics if metrics is not None else default_registry()
        self._c_retries = m.counter("train.retries")
        self._c_restores = m.counter("train.restores")

    def run(self, state, start_step: int, num_steps: int):
        from repro_torch.obs import trace_span
        step = start_step
        end = start_step + num_steps
        while step < end:
            attempts = 0
            while True:
                t0 = time.monotonic()
                try:
                    if self.injector is not None:
                        self.injector.check(step)
                    state = self.step_fn(state, step)
                    self.monitor.observe(step, time.monotonic() - t0)
                    break
                except Exception as e:  # noqa: BLE001 -- retry any fault
                    attempts += 1
                    self.retries.append((step, repr(e)))
                    self._c_retries.inc()
                    if attempts > self.max_retries:
                        raise
                    with trace_span("train.restore", step=step,
                                    attempt=attempts, error=repr(e)):
                        state = self.restore_fn(step)
                    self._c_restores.inc()
            step += 1
        return state, step

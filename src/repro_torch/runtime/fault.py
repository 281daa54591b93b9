"""Straggler detection for the serving loop (port of
``repro.runtime.fault.StragglerMonitor``; the training-side
``FailureInjector`` and ``StepExecutor`` come with the training port).
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["StragglerMonitor"]


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

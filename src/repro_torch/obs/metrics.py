"""Low-overhead metrics registry (port of ``repro.obs.metrics``).

Three instrument kinds, zero dependencies, one naming convention
(dotted lowercase ``subsystem.noun[.verb]``, units suffixed on the
name: ``_ms``, ``_ratio``, ``_bytes``):

* :class:`Counter` -- monotonically increasing count (``.inc(n)``);
* :class:`Gauge`   -- last-set value plus running min/max (``.set(v)``);
* :class:`Histogram` -- fixed **log2 buckets**: an observation ``v > 0``
  lands in bucket ``e`` with ``2**e <= v < 2**(e+1)`` (``frexp``, no
  search), non-positive values in the ``zero`` bucket.  Quantiles are
  estimated by linear interpolation inside the bucket, clamped to the
  recorded min/max.

A :class:`MetricsRegistry` is a dict of instruments with a
deterministic :meth:`~MetricsRegistry.snapshot` (sorted series, plain
JSON types) in the reference's schema, so two registries fed the same
operations, one from each package, snapshot alike.  A registry built
with ``enabled=False`` hands out shared null instruments and snapshots
empty.

``default_registry()`` is the process-wide registry the tuner's cache
and the energy meter count into.
"""
from __future__ import annotations

import json
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "null_registry", "SCHEMA_VERSION"]

SCHEMA_VERSION = 1
_KIND = "repro-obs-metrics"


class Counter:
    """Monotonic count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-set value with running min/max over the series lifetime."""

    __slots__ = ("name", "value", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.value = None
        self.min = None
        self.max = None

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self.value,
                "min": self.min, "max": self.max}


class Histogram:
    """Fixed log2-bucket histogram.

    Bucket ``e`` holds observations in ``[2**e, 2**(e+1))``; bucket
    index comes from ``math.frexp`` (one float decomposition, no edge
    search), so the bucket table is sparse over the exponent range the
    data actually spans.  Non-positive observations land in the
    dedicated ``zero`` bucket (quantile value 0.0).
    """

    __slots__ = ("name", "count", "total", "min", "max", "zero",
                 "buckets")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.zero = 0                      # v <= 0 observations
        self.buckets: dict[int, int] = {}  # exponent -> count

    @staticmethod
    def bucket_of(v: float) -> int | None:
        """Exponent ``e`` with ``2**e <= v < 2**(e+1)``; None for
        ``v <= 0`` (the zero bucket)."""
        if v <= 0.0:
            return None
        return math.frexp(v)[1] - 1

    @staticmethod
    def bucket_bounds(e: int) -> tuple[float, float]:
        return (2.0 ** e, 2.0 ** (e + 1))

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        e = self.bucket_of(v)
        if e is None:
            self.zero += 1
        else:
            self.buckets[e] = self.buckets.get(e, 0) + 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (shard aggregation); log2 buckets
        make the merge a per-exponent integer add."""
        self.count += other.count
        self.total += other.total
        for v in (other.min, other.max):
            if v is not None:
                if self.min is None or v < self.min:
                    self.min = v
                if self.max is None or v > self.max:
                    self.max = v
        self.zero += other.zero
        for e, c in other.buckets.items():
            self.buckets[e] = self.buckets.get(e, 0) + c
        return self

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile: walk the cumulative bucket counts,
        linearly interpolate inside the landing bucket, clamp to the
        recorded [min, max] (so p0/p100 are exact)."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q * self.count))
        if rank >= self.count:
            return self.max
        cum = self.zero
        if rank <= cum:
            return 0.0
        for e in sorted(self.buckets):
            c = self.buckets[e]
            if rank <= cum + c:
                lo, hi = self.bucket_bounds(e)
                frac = (rank - cum - 0.5) / c
                v = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(self.min, min(self.max, v))
            cum += c
        return self.max

    def to_dict(self) -> dict:
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "zero": self.zero,
            "buckets": {str(e): self.buckets[e]
                        for e in sorted(self.buckets)},
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class _NullInstrument:
    """Shared no-op instrument for disabled registries: every recording
    method is a constant no-op, nothing is ever registered."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL = _NullInstrument()


class MetricsRegistry:
    """Get-or-create instrument registry with a deterministic snapshot.

    ``enabled=False`` makes every accessor return the shared null
    instrument and :meth:`snapshot` report an empty ``series`` map --
    the metric-free disabled mode.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._series: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        if not self.enabled:
            return _NULL
        inst = self._series.get(name)
        if inst is None:
            with self._lock:
                inst = self._series.get(name)
                if inst is None:
                    inst = cls(name)
                    self._series[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        """Plain-JSON snapshot, series sorted by name (deterministic:
        two registries fed the same operations serialise identically)."""
        return {
            "kind": _KIND,
            "schema_version": SCHEMA_VERSION,
            "series": {name: self._series[name].to_dict()
                       for name in sorted(self._series)},
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)


_DEFAULT = MetricsRegistry()
_NULL_REGISTRY = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem records into."""
    return _DEFAULT


def null_registry() -> MetricsRegistry:
    """The shared disabled registry (metric-free, near-zero cost)."""
    return _NULL_REGISTRY

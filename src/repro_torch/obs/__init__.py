# Observability (port of repro.obs): the metrics registry.  The span
# tracer (repro.obs.trace) is not ported yet (ROADMAP queue A, A14).
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    null_registry,
)

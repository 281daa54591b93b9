# Observability (port of repro.obs): the metrics registry and the span
# tracer (Chrome trace events, JSONL, energy attributed to spans).
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    null_registry,
)
from .trace import (  # noqa: F401
    Tracer,
    attribute_energy,
    default_tracer,
    load_events,
    set_default_tracer,
    trace_span,
    validate_trace,
)

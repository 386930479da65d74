"""Host-side observability of the port: the metrics registry and the
Chrome-trace tracer (``repro.obs``'s ``metrics`` and ``trace``)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .trace import Tracer, validate_trace  # noqa: F401

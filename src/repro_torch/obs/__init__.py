"""Host-side observability of the port (the metrics registry)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401

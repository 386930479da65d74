"""Host-side observability of the port, stdlib only (``repro.obs``):

* :mod:`repro_torch.obs.trace` — :class:`Tracer` span/instant/counter
  events → Chrome-trace/Perfetto JSON;
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` of counters,
  gauges and log-bucketed histograms, with JSONL snapshots and a
  Prometheus-text endpoint;
* :mod:`repro_torch.obs.numerics` — the §5 controller's exponent and
  overflow timeline as JSONL (the trainer's ``--numerics-log``).
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      start_http_server)
from .numerics import (NumericsLog, count_moves, read_jsonl, serve_records,
                       train_records)
from .trace import Tracer, validate_trace

__all__ = [
    "Tracer", "validate_trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "start_http_server",
    "NumericsLog", "serve_records", "train_records", "count_moves",
    "read_jsonl",
]

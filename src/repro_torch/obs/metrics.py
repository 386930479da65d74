"""Metrics registry: counters, gauges, log-bucketed histograms.

Dependency-free (stdlib only) and host-side; the port's copy of
``repro.obs.metrics``, which ``repro_torch.serve.metrics`` and the
trainer record into.  Three instrument types:

* :class:`Counter` — monotonically increasing total;
* :class:`Gauge` — last-set value, with a high-water mark (``peak``);
* :class:`Histogram` — log-bucketed (powers of ``base`` from ``lo``).
  Bucket ``i`` covers ``[lo * base**i, lo * base**(i+1))``; values below
  ``lo`` land in an underflow bucket, values at/above the last edge in an
  overflow bucket.  ``sum``/``count``/``min``/``max`` ride along.

A :class:`MetricsRegistry` is a named collection with three outputs:

* :meth:`snapshot` — a JSON-able dict of every instrument's state;
* :meth:`snapshot_jsonl` — appends one timestamped snapshot line to a
  file;
* :meth:`prometheus_text` — the Prometheus text exposition format,
  served by :func:`start_http_server` over a stdlib ``http.server``
  endpoint (``curl localhost:PORT/metrics``).
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, List, Optional


class Counter:
    __slots__ = ("name", "help", "_v")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    __slots__ = ("name", "help", "_v", "_peak")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._v = 0.0
        self._peak = 0.0

    def set(self, v: float) -> None:
        self._v = v
        if v > self._peak:
            self._peak = v

    @property
    def value(self) -> float:
        return self._v

    @property
    def peak(self) -> float:
        return self._peak


class Histogram:
    """Log-bucketed histogram over ``[lo, lo * base**n_buckets)``.

    ``edges`` are the ``n_buckets + 1`` bucket boundaries; ``counts`` has
    ``n_buckets + 2`` entries — ``counts[0]`` is the underflow bucket
    (``v < lo``), ``counts[-1]`` the overflow bucket (``v >= edges[-1]``),
    and ``counts[i + 1]`` covers ``[edges[i], edges[i + 1])``.
    """

    __slots__ = ("name", "help", "lo", "base", "edges", "counts",
                 "sum", "count", "min", "max")

    def __init__(self, name: str, help: str = "", *, lo: float = 1e-4,
                 n_buckets: int = 24, base: float = 2.0):
        if lo <= 0 or base <= 1 or n_buckets < 1:
            raise ValueError("need lo > 0, base > 1, n_buckets >= 1")
        self.name, self.help = name, help
        self.lo, self.base = float(lo), float(base)
        self.edges: List[float] = [lo * base ** i
                                   for i in range(n_buckets + 1)]
        self.counts: List[int] = [0] * (n_buckets + 2)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v < self.lo:
            self.counts[0] += 1
        else:
            n = len(self.edges) - 1
            i = min(int(math.log(v / self.lo) / math.log(self.base)), n)
            # float log can land one bucket off at exact edges — fix up
            if i < n and v >= self.edges[i + 1]:
                i += 1
            elif v < self.edges[i]:
                i -= 1
            if i >= n:
                self.counts[-1] += 1
            else:
                self.counts[i + 1] += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (geometric-mid of the
        target bucket; exact min/max for q=0/1)."""
        if not self.count:
            return 0.0
        if q <= 0:
            return self.min
        if q >= 1:
            return self.max
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                if i == 0:
                    return min(self.lo, self.max)
                if i == len(self.counts) - 1:
                    return self.max
                return math.sqrt(self.edges[i - 1] * self.edges[i])
        return self.max

    def state(self) -> dict:
        return {"type": "histogram", "lo": self.lo, "base": self.base,
                "edges": list(self.edges), "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None}


class MetricsRegistry:
    """Named instrument collection with JSONL + Prometheus outputs."""

    def __init__(self):
        self._m: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._m.get(name)
        if m is None:
            m = cls(name, help, **kw) if kw else cls(name, help)
            self._m[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", *, lo: float = 1e-4,
                  n_buckets: int = 24, base: float = 2.0) -> Histogram:
        return self._get(Histogram, name, help, lo=lo, n_buckets=n_buckets,
                         base=base)

    def __contains__(self, name: str) -> bool:
        return name in self._m

    # -- outputs ----------------------------------------------------------
    def snapshot(self) -> dict:
        out: Dict[str, object] = {}
        for name, m in sorted(self._m.items()):
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value,
                             "peak": m.peak}
            else:
                out[name] = m.state()
        return out

    def snapshot_jsonl(self, path_or_file, extra: Optional[dict] = None,
                       ) -> None:
        """Append one ``{"t": ..., **extra, "metrics": snapshot}`` line."""
        rec = {"t": time.time()}
        if extra:
            rec.update(extra)
        rec["metrics"] = self.snapshot()
        line = json.dumps(rec) + "\n"
        if hasattr(path_or_file, "write"):
            path_or_file.write(line)
        else:
            with open(path_or_file, "a") as f:
                f.write(line)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (histograms cumulative)."""
        lines: List[str] = []
        for name, m in sorted(self._m.items()):
            if isinstance(m, Counter):
                lines += [f"# HELP {name} {m.help}".rstrip(),
                          f"# TYPE {name} counter",
                          f"{name} {_fmt(m.value)}"]
            elif isinstance(m, Gauge):
                lines += [f"# HELP {name} {m.help}".rstrip(),
                          f"# TYPE {name} gauge",
                          f"{name} {_fmt(m.value)}",
                          f"{name}_peak {_fmt(m.peak)}"]
            else:
                lines += [f"# HELP {name} {m.help}".rstrip(),
                          f"# TYPE {name} histogram"]
                cum = m.counts[0]
                for e, c in zip(m.edges[1:], m.counts[1:-1]):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_fmt(e)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines += [f"{name}_sum {_fmt(m.sum)}",
                          f"{name}_count {m.count}"]
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def start_http_server(registry: MetricsRegistry, port: int = 0,
                      host: str = "127.0.0.1"):
    """Serve ``registry.prometheus_text()`` at ``/metrics`` (stdlib only).

    Runs a daemon thread; returns the ``HTTPServer`` (read the bound port
    from ``server.server_address[1]`` — ``port=0`` picks an ephemeral
    one; call ``server.shutdown()`` to stop).
    """
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):   # noqa: N802 (stdlib API name)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = registry.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # keep the serve CLI's stdout clean
            pass

    server = HTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="repro-torch-obs-metrics")
    t.start()
    return server


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "start_http_server"]

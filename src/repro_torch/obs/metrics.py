"""Metrics registry: counters, gauges, log-bucketed histograms.

Stdlib only and host-side; the port's copy of the instruments that
``repro_torch.serve.metrics`` records into (the reference keeps them in
``repro.obs.metrics``, with JSONL and Prometheus outputs that the port
does not have yet).

* :class:`Counter` — monotonically increasing total;
* :class:`Gauge` — last-set value, with a high-water mark (``peak``);
* :class:`Histogram` — log-bucketed (powers of ``base`` from ``lo``).
  Bucket ``i`` covers ``[lo * base**i, lo * base**(i+1))``; values below
  ``lo`` land in an underflow bucket, values at/above the last edge in an
  overflow bucket.  ``sum``/``count``/``min``/``max`` ride along.
"""
from __future__ import annotations

import math
from typing import Dict, List


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


class MetricsRegistry:
    """Named instrument collection."""

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

"""Structured tracing: span/instant/counter events → Chrome-trace JSON —
``repro.obs.trace``.

A :class:`Tracer` is a process-local, dependency-free event recorder that
the train supervisor and the fault harness write into:

* **spans** — ``with tracer.span("train_step", tid="train"): ...`` (or the
  explicit :meth:`begin`/:meth:`end` pair) record a named duration on one
  track.  Spans nest per track; export writes them as Chrome-trace
  complete events (``ph: "X"``) whose ``ts``/``dur`` containment encodes
  the nesting, which both ``chrome://tracing`` and Perfetto render as
  stacked slices.
* **instants** — point events (sentinel skips, rollbacks, fault-harness
  injections) rendered as markers.
* **counters** — named numeric series rendered as stacked area charts.

Everything is host-side (one small dict per event); nothing here touches
a tensor.  Call sites hold ``tracer = None`` when tracing is off and guard
every hook with ``if tracer is not None``.

:meth:`Tracer.export` / :meth:`Tracer.to_chrome` produce the Chrome trace
event format (``{"traceEvents": [...]}``) sorted so parents precede
children; :func:`validate_trace` is the schema check the HALTED bundle's
trace is held to.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

# Chrome trace event phases this module emits (and the validator accepts).
_PHASES = {"X", "i", "C", "M"}


class _SpanCtx:
    """Context manager closing one span on one track."""

    __slots__ = ("_tracer", "_tid")

    def __init__(self, tracer: "Tracer", tid: str):
        self._tracer = tracer
        self._tid = tid

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer.end(tid=self._tid)
        return False


class Tracer:
    """Process-local trace-event recorder (Chrome trace event format).

    ``tid`` names the track an event lands on (one per logical timeline:
    ``"engine"`` for step phases, ``"requests"`` for lifecycle instants,
    ``"numerics"`` for controller samples...).  Spans must nest per
    track — :meth:`end` closes the innermost open span of its track.

    ``clock`` defaults to ``time.perf_counter`` (monotonic); timestamps
    are microseconds since the tracer was created, which is what the
    Chrome trace viewer expects in the ``ts`` field.
    """

    def __init__(self, clock=None, pid: int = 0):
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self.pid = pid
        self.events: List[dict] = []
        self._open: Dict[str, List[dict]] = {}   # tid -> open-span stack

    # -- clock ------------------------------------------------------------
    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    # -- event emitters ---------------------------------------------------
    def begin(self, name: str, tid: str = "engine", **args) -> None:
        """Open a span on ``tid``; close it with :meth:`end`."""
        self._open.setdefault(tid, []).append(
            {"name": name, "ts": self.now_us(), "args": args})

    def end(self, tid: str = "engine", **args) -> None:
        """Close the innermost open span on ``tid``."""
        stack = self._open.get(tid)
        if not stack:
            raise RuntimeError(f"Tracer.end on track {tid!r} with no open span")
        sp = stack.pop()
        if args:
            sp["args"].update(args)
        ev = {"name": sp["name"], "ph": "X", "ts": sp["ts"],
              "dur": self.now_us() - sp["ts"], "pid": self.pid, "tid": tid}
        if sp["args"]:
            ev["args"] = sp["args"]
        self.events.append(ev)

    def span(self, name: str, tid: str = "engine", **args) -> _SpanCtx:
        """``with tracer.span("phase"): ...`` — begin/end as a context."""
        self.begin(name, tid=tid, **args)
        return _SpanCtx(self, tid)

    def instant(self, name: str, tid: str = "engine", **args) -> None:
        ev = {"name": name, "ph": "i", "ts": self.now_us(), "pid": self.pid,
              "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: Dict[str, float],
                tid: str = "counters") -> None:
        """One sample of a multi-series counter (rendered as stacked area)."""
        self.events.append(
            {"name": name, "ph": "C", "ts": self.now_us(), "pid": self.pid,
             "tid": tid, "args": {k: float(v) for k, v in values.items()}})

    # -- export -----------------------------------------------------------
    def to_chrome(self, process_name: str = "repro") -> dict:
        """Chrome trace object: open spans are closed at 'now', events are
        sorted so a parent span precedes its children (Perfetto builds the
        slice stack from ``ts`` order + ``ts+dur`` containment)."""
        for tid in list(self._open):
            while self._open[tid]:
                self.end(tid=tid, unclosed_at_export=True)
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid, "tid": t,
                 "ts": 0.0, "args": {"name": process_name}}
                for t in ("engine",)]
        meta += [{"name": "thread_name", "ph": "M", "pid": self.pid,
                  "ts": 0.0, "tid": tid, "args": {"name": tid}}
                 for tid in sorted({e["tid"] for e in self.events})]
        evs = sorted(self.events, key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}

    def export(self, path: str, process_name: str = "repro") -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(process_name), f)
        return path

    # -- introspection (tests / assertions) -------------------------------
    def span_names(self) -> List[str]:
        return [e["name"] for e in self.events if e["ph"] == "X"]

    def find(self, name: str, ph: Optional[str] = None) -> List[dict]:
        return [e for e in self.events
                if e["name"] == name and (ph is None or e["ph"] == ph)]


def validate_trace(obj: dict) -> None:
    """Raise ``ValueError`` unless ``obj`` is a loadable Chrome trace.

    Checks the schema CI asserts on the ``--trace-out`` artifact:

    * top level: dict with a ``traceEvents`` list;
    * every event: ``name`` (str), ``ph`` in {X, i, C, M}, numeric
      ``ts >= 0``, ``pid``/``tid`` present;
    * complete events: numeric ``dur >= 0``;
    * counter events: an ``args`` dict of numbers;
    * ordering: non-meta events sorted by ``ts``, and per track every pair
      of spans either nests or is disjoint (Perfetto's slice-stack
      precondition — overlapping non-nested spans on one track are the
      classic way a trace loads blank).
    """
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError("trace must be a dict with a traceEvents list")
    spans_by_track: Dict[tuple, List[tuple]] = {}
    last_ts = None
    for i, e in enumerate(obj["traceEvents"]):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not a dict")
        if not isinstance(e.get("name"), str):
            raise ValueError(f"event {i} has no name")
        ph = e.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"event {i} ({e['name']}) has bad ph {ph!r}")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} ({e['name']}) has bad ts {ts!r}")
        if "pid" not in e or "tid" not in e:
            raise ValueError(f"event {i} ({e['name']}) missing pid/tid")
        if last_ts is not None and ts < last_ts:
            raise ValueError(f"event {i} ({e['name']}) out of ts order")
        last_ts = ts
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"span {i} ({e['name']}) has bad dur {dur!r}")
            spans_by_track.setdefault((e["pid"], e["tid"]), []).append(
                (ts, ts + dur, e["name"]))
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(
                    f"counter {i} ({e['name']}) needs numeric args")
    for track, spans in spans_by_track.items():
        open_ends: List[float] = []      # enclosing spans' end times
        for ts, te, name in spans:       # already ts-sorted
            while open_ends and ts >= open_ends[-1] - 1e-9:
                open_ends.pop()
            if open_ends and te > open_ends[-1] + 1e-9:
                raise ValueError(
                    f"span {name!r} on track {track} overlaps its "
                    "enclosing span without nesting")
            open_ends.append(te)


__all__ = ["Tracer", "validate_trace"]

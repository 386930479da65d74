"""Serving metrics: per-request latency traces + engine aggregates.

Host-side and allocation-free on the hot path: the engine calls the
``on_*`` hooks with ``time.perf_counter`` stamps; ``summary()`` reduces to
the numbers a serving dashboard wants — TTFT, queue wait, aggregate
decode throughput — plus the packed pool's cumulative cache overflow rate
(see ``kv_pool.overflow_summary``) and the robustness counters the
admission-control/preemption/quarantine layer feeds (rejected, timed
out, preempted, failed, queue-depth high-water mark).

Timestamps come from ``time.perf_counter()`` — monotonic, so TTFT and
queue-wait survive NTP steps and wall-clock slews (stamps are deltas
against other stamps from the same process, never absolute times).

Every hook also records into a :class:`repro_torch.obs.metrics.MetricsRegistry`
(``self.registry``): counters for the robustness events, a queue-depth
gauge, and log-bucketed histograms (TTFT, queue wait, inter-decode-step
latency, per-request tok/s) — the series ``launch.serve --metrics-port``
exposes as Prometheus text and ``--metrics-out`` snapshots as JSONL.
``summary()`` still aggregates from the per-request traces, so its
schema and values are unchanged by the registry.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from repro_torch.obs.metrics import MetricsRegistry


def _now() -> float:
    return time.perf_counter()


@dataclasses.dataclass
class RequestTrace:
    uid: int
    prompt_len: int
    t_submit: float
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_finish: Optional[float] = None
    new_tokens: int = 0
    prefill_chunks: int = 0
    preempts: int = 0
    status: Optional[str] = None      # terminal RequestStatus.value

    @property
    def queue_wait(self) -> Optional[float]:
        return None if self.t_admit is None else self.t_admit - self.t_submit

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit


class ServeMetrics:
    """Collects request traces; ``summary()`` aggregates them.

    Event counts live in ``self.registry`` (shared with the CLI's
    Prometheus endpoint when one is passed in); the legacy attribute
    names (``decode_steps``, ``rejected``...) remain as read-only
    properties over the registry.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.traces: Dict[int, RequestTrace] = {}
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self._t_last_step: Optional[float] = None
        r = self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._c_submitted = r.counter(
            "serve_requests_submitted", "requests entered via submit()")
        self._c_finished = r.counter(
            "serve_requests_finished", "requests resolved OK")
        self._c_rejected = r.counter(
            "serve_requests_rejected", "admission control bounces")
        self._c_timed_out = r.counter(
            "serve_requests_timed_out", "deadline / drain expiries")
        self._c_failed = r.counter(
            "serve_requests_failed", "quarantined / exhausted requests")
        self._c_preempt = r.counter(
            "serve_preemptions", "page-pressure eviction events")
        self._c_tokens = r.counter(
            "serve_new_tokens", "generated tokens across requests")
        self._c_steps = r.counter(
            "serve_decode_steps", "batched decode steps run")
        self._c_chunks = r.counter(
            "serve_prefill_chunks", "prefill chunks run")
        self._g_queue = r.gauge(
            "serve_queue_depth", "waiting queue length at last submit")
        self._h_ttft = r.histogram(
            "serve_ttft_seconds", "submit -> first token")
        self._h_wait = r.histogram(
            "serve_queue_wait_seconds", "submit -> first admission")
        self._h_step = r.histogram(
            "serve_decode_step_seconds", "inter-decode-step latency")
        self._h_tps = r.histogram(
            "serve_request_tok_per_s", "per-request decode throughput",
            lo=0.25)

    # -- legacy attribute views over the registry --------------------------
    @property
    def decode_steps(self) -> int:
        return int(self._c_steps.value)

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def timed_out(self) -> int:
        return int(self._c_timed_out.value)

    @property
    def preemptions(self) -> int:
        # preemption EVENTS (one uid may repeat)
        return int(self._c_preempt.value)

    @property
    def failed(self) -> int:
        # quarantined (numeric sentinel) + OOM
        return int(self._c_failed.value)

    @property
    def queue_depth_peak(self) -> int:
        return int(self._g_queue.peak)

    # -- engine hooks -----------------------------------------------------
    def on_submit(self, uid: int, prompt_len: int) -> None:
        self.traces[uid] = RequestTrace(uid, prompt_len, _now())
        self._c_submitted.inc()

    def on_admit(self, uid: int) -> None:
        tr = self.traces[uid]
        if tr.t_admit is None:        # re-admission after preemption keeps
            tr.t_admit = _now()       # the first admit stamp (true wait)
            self._h_wait.observe(tr.queue_wait)
        if self.t_start is None:
            self.t_start = _now()

    def on_token(self, uid: int) -> None:
        tr = self.traces[uid]
        tr.new_tokens += 1
        self._c_tokens.inc()
        if tr.t_first is None:
            tr.t_first = _now()
            self._h_ttft.observe(tr.ttft)

    def on_prefill_chunk(self, uid: int) -> None:
        """Chunked-prefill mode: one chunk of this request's prompt ran.

        TTFT semantics are unchanged — the first token still stamps
        ``t_first`` via :meth:`on_token` when the *final* chunk's logits
        are sampled — but the chunk count makes a long prompt's TTFT
        interpretable (chunks × step time, interleaved with decode).
        """
        self.traces[uid].prefill_chunks += 1
        self._c_chunks.inc()

    def on_finish(self, uid: int, status: str = "ok") -> None:
        tr = self.traces[uid]
        tr.t_finish = self.t_end = _now()
        tr.status = status
        if status == "timed_out":
            self._c_timed_out.inc()
        elif status == "failed":
            self._c_failed.inc()
        elif status == "ok":
            self._c_finished.inc()
        if tr.t_admit is not None and tr.new_tokens:
            span = tr.t_finish - tr.t_admit
            if span > 0:
                self._h_tps.observe(tr.new_tokens / span)

    def on_reject(self, uid: int) -> None:
        """Admission control bounced the request (queue full)."""
        tr = self.traces[uid]
        tr.t_finish = _now()
        tr.status = "rejected"
        self._c_rejected.inc()

    def on_preempt(self, uid: int) -> None:
        """The request lost its slot/pages and went back to the queue."""
        self.traces[uid].preempts += 1
        self._c_preempt.inc()

    def on_decode_step(self) -> None:
        self._c_steps.inc()
        t = _now()
        if self._t_last_step is not None:
            self._h_step.observe(t - self._t_last_step)
        self._t_last_step = t

    def observe_queue_depth(self, depth: int) -> None:
        self._g_queue.set(depth)

    # -- aggregates -------------------------------------------------------
    def summary(self, extra: Optional[dict] = None) -> dict:
        done = [t for t in self.traces.values() if t.t_finish is not None]
        finished_ok = [t for t in done if t.status in (None, "ok")]
        new_tokens = sum(t.new_tokens for t in self.traces.values())
        wall = ((self.t_end or _now()) - self.t_start
                if self.t_start is not None else 0.0)
        ttfts = [t.ttft for t in self.traces.values() if t.ttft is not None]
        waits = [t.queue_wait for t in self.traces.values()
                 if t.queue_wait is not None]
        out = {
            "requests_submitted": len(self.traces),
            "requests_finished": len(finished_ok),
            "requests_rejected": self.rejected,
            "requests_timed_out": self.timed_out,
            "requests_failed": self.failed,
            "preemptions": self.preemptions,
            "queue_depth_peak": self.queue_depth_peak,
            "new_tokens": new_tokens,
            "decode_steps": self.decode_steps,
            "wall_s": wall,
            "tok_per_s": new_tokens / wall if wall > 0 else 0.0,
            "ttft_mean_s": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            "ttft_max_s": max(ttfts) if ttfts else 0.0,
            "queue_wait_mean_s": sum(waits) / len(waits) if waits else 0.0,
            "queue_wait_max_s": max(waits) if waits else 0.0,
            "prefill_chunks": sum(t.prefill_chunks
                                  for t in self.traces.values()),
        }
        if extra:
            out.update(extra)
        return out

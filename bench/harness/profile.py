"""The traced steps: ``torch.profiler`` over a few iterations of the
measured loop after the window, in two passes, reduced to what the
per-layer readers and the breakdown take.

The device pass records the card's activity alone (``ProfilerActivity.CUDA``):
recording every host operation as well stretches a host-bound step by a
fifth or more, and an idle share over the traced steps would read that
stretch.

* ``kernels``: every device operation (kernels, copies, memsets) of the
  device pass as ``(name, start_us, end_us)`` in the profiler's clock;
* ``window_s``: the device pass's length on the host's clock, from one
  ``torch.cuda.synchronize()`` to the next;
* ``busy_s``: the union of the device operations' intervals.

The host pass records host operations too, and only names the idle gaps:

* ``gaps``: the longest intervals of the host pass where no device
  operation ran, each named by the benchmark's own innermost span
  (``bench:...``) around its middle and the host operation running there;
* ``host_window_s``: that pass's length, to set beside ``window_s``.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import List, Optional

SPAN = "bench:"


@contextlib.contextmanager
def span(torch, name: str, on: bool):
    """A host span of the benchmark's own, seen in the host pass."""
    if not on:
        yield
        return
    with torch.profiler.record_function(SPAN + name):
        yield


class Traced:
    def __init__(self, torch, on: bool):
        self.torch, self.on = torch, on
        self.kernels: List[tuple] = []
        self.window_s: Optional[float] = None
        self.busy_s: Optional[float] = None
        self.host_window_s: Optional[float] = None
        self.gaps: List[tuple] = []

    @contextlib.contextmanager
    def device_pass(self):
        """Profile the card alone over the block; ``window_s`` is the
        block on the host's clock between two synchronisations."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        self.kernels = [(n, s, t) for n, on_device, s, t, ann
                        in _events(prof) if on_device and not ann
                        and not n.startswith(SPAN)]
        if not self.kernels:
            return
        self.window_s = t1 - t0
        busy, _ = _cover(sorted((s, t) for _, s, t in self.kernels),
                         min(s for _, s, _ in self.kernels),
                         max(t for _, _, t in self.kernels))
        self.busy_s = busy / 1e6

    @contextlib.contextmanager
    def host_pass(self):
        """Profile host and card over the block, inside a ``bench:window``
        span, and name its longest idle gaps."""
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(SPAN + "window"):
                yield
                with torch.profiler.record_function(SPAN + "sync"):
                    torch.cuda.synchronize()
        self._name_gaps(list(_events(prof)))

    def _name_gaps(self, events):
        cpu, dev, win = [], [], None
        for name, on_device, s, t, ann in events:
            if on_device:
                dev.append((name, s, t, ann))
            elif name == SPAN + "window":
                win = (s, t)
            else:
                cpu.append((s, t, name))
        # a host span is mirrored on the device as an annotation over its
        # kernels: that is no operation
        spans = {name for _, _, name in cpu}
        ivs = sorted((s, t) for n, s, t, ann in dev
                     if not ann and n not in spans and not n.startswith(SPAN))
        if win is None or not ivs:
            return
        w0, w1 = win
        self.host_window_s = (w1 - w0) / 1e6
        _, gaps = _cover([(max(s, w0), min(t, w1)) for s, t in ivs
                          if t > w0 and s < w1], w0, w1)
        gaps.sort(key=lambda g: g[0] - g[1])
        cpu.sort()
        starts = [c[0] for c in cpu]
        self.gaps = [(self._name_at((g0 + g1) / 2, cpu, starts),
                      (g1 - g0) / 1e6) for g0, g1 in gaps[:10]]

    @staticmethod
    def _name_at(t: float, cpu, starts) -> str:
        """The benchmark's innermost span around ``t`` and the innermost
        host operation there."""
        hi = bisect.bisect_right(starts, t)
        ours, op = None, None
        for s, e, name in cpu[:hi]:
            if e < t:
                continue
            if name.startswith(SPAN):
                if ours is None or s >= ours[0]:
                    ours = (s, name[len(SPAN):])
            elif op is None or s >= op[0]:
                op = (s, name)
        label = ours[1] if ours else "outside the loop"
        return f"{label} > {op[1]}" if op else label

    def device_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, t in self.kernels:
            by[name] = by.get(name, 0.0) + (t - s) / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], sec] for name, sec in top]

    def breakdown(self) -> Optional[dict]:
        if not self.kernels:
            return None
        return {"device_ops": self.device_ops(),
                "idle_gaps": [[name[:200], sec] for name, sec in self.gaps]}

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(t - s for name, s, t in self.kernels if match(name)) / 1e6


def _events(prof):
    """``(name, on_device, start_us, end_us, annotation)`` of every
    event, from the profiler's raw results (its event tree is never
    built: that takes minutes for a few host-bound steps)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        ann = getattr(e, "is_user_annotation", lambda: False)()
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               e.start_ns() / 1e3, e.end_ns() / 1e3, ann)


def _cover(ivs, w0: float, w1: float) -> tuple:
    """The busy length of the sorted intervals ``ivs`` within ``[w0, w1]``
    and the gaps between them."""
    busy, gaps, cur = 0.0, [], w0
    for s, t in ivs:
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if cur < w1:
        gaps.append((cur, w1))
    return busy, gaps

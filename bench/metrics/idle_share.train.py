"""Share of a training step in which no operation ran on the device:
one less the device's busy time a step (the device pass over the traced
steps, which records the card's activity alone: the union of its
kernels, copies and memsets) over the untraced window's time a step.
Traced steps run slower than untraced ones, by the profiler's own cost
(~17% a granite step even with the card alone recorded), so over their
own length the share would count that stretch as idle; ``run.py``
prints both lengths."""


def read(run):
    traced = run.get("traced")
    if (run.get("kind") != "train" or traced is None or not traced.busy_s
            or not run.get("traced_steps") or not run.get("attempted")):
        return None
    busy = traced.busy_s / run["traced_steps"]
    step = run["seconds"] / run["attempted"]
    return 100.0 * (1.0 - busy / step)

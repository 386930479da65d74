"""Share of the traced serving steps in which no operation ran on the
device: the device pass (the card's activity alone, so that the
profiler's host cost does not stretch the steps) less the union of its
kernels, copies and memsets, over its length on the host's clock."""


def read(run):
    traced = run.get("traced")
    if run.get("kind") != "serve" or traced is None or not traced.window_s:
        return None
    return 100.0 * (1.0 - traced.busy_s / traced.window_s)

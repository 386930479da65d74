"""95th percentile of the time to first token over the window's requests,
from the benchmark's own stamps: from when a request was due (its
client's previous request resolved) to the end of the engine step after
which its first token is visible."""
from harness.core import percentile


def read(run):
    if run.get("kind") != "serve" or not run.get("ttft_ms"):
        return None
    return percentile(run["ttft_ms"], 95)
